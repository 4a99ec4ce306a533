"""stage_runs_ms: mean device ms a frame in the pipeline stage `runs`: the
runs extracted and their data (K2's grids, cover rows and run keys). The
program's own stage stamps inside the frame graph
(`forma_tpu_torch.tracing`), over every frame it rendered."""

from frame_bench import program


def read(ctx):
    return program.stage_ms("runs")
