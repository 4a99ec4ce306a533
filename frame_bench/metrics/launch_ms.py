"""launch_ms: host ms a traced frame in the program's span `forma.replay`,
less the spans inside it (`forma.capture`): the frame graph's key, the
copies of its inputs, its launch and the clones of its outputs."""

from frame_bench import program


def read(ctx):
    return program.span_ms(ctx, "replay")
