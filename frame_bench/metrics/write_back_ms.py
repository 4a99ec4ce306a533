"""write_back_ms: host ms a traced frame in the program's span
`forma.write_back`: the frame's pixels (or its damaged tiles) written
into the caller's `Buffer`."""

from frame_bench import program


def read(ctx):
    return program.span_ms(ctx, "write_back")
