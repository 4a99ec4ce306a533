"""inputs_ms: host ms a traced frame in the program's span `forma.inputs`,
less the spans inside it: a frame's host work before its replay (the
pending frame completed, the composition compacted, the geometry, the
capacity estimate, the style and geometry tables and their uploads, the
damage cache's no-dispatch test and bookkeeping)."""

from frame_bench import program


def read(ctx):
    return program.span_ms(ctx, "inputs")
