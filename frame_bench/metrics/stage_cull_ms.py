"""stage_cull_ms: mean device ms a frame in the pipeline stage `cull`: the
occlusion cull, the clip pass and the units renumbered, with the damage
cache's tile-unchanged test and the painted tiles' depth.  The program's
own stage stamps inside the frame graph (`forma_tpu_torch.tracing`),
over every frame it rendered."""

from frame_bench import program


def read(ctx):
    return program.stage_ms("cull")
