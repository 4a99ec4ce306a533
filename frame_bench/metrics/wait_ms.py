"""wait_ms: host ms a traced frame in the program's span `forma.wait`: the
host blocked until the frame's diagnostics are on the host (the device's
work for the frame, where the host got there first)."""

from frame_bench import program


def read(ctx):
    return program.span_ms(ctx, "wait")
