"""readback_ms: host ms a traced frame in the program's span
`forma.readback`: the frame's pixels copied to the host (a damage-cached
frame's pinned copies issued, and its damaged tiles past their prefix)."""

from frame_bench import program


def read(ctx):
    return program.span_ms(ctx, "readback")
