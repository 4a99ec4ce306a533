"""stage_paint_ms: mean device ms a frame in the pipeline stage `paint`:
the paint fold (K3).  The program's own stage stamps inside the frame
graph (`forma_tpu_torch.tracing`), over every frame it rendered."""

from frame_bench import program


def read(ctx):
    return program.stage_ms("paint")
