"""stage_rasterize_sort_ms: mean device ms a frame in the pipeline stage
`rasterize_sort`: the rasterizer (K4, or K1 and the emit) and the
segment sort.  The program's own stage stamps inside the frame graph
(`forma_tpu_torch.tracing`), over every frame it rendered."""

from frame_bench import program


def read(ctx):
    return program.stage_ms("rasterize_sort")
