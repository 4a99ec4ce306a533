"""stage_damage_ms: mean device ms a frame in the pipeline stage `damage`:
the damage-cached frame's re-emit of unchanged tiles and the changed
tiles' compaction.  The program's own stage stamps inside the frame graph
(`forma_tpu_torch.tracing`), over every frame it rendered."""

from frame_bench import program


def read(ctx):
    return program.stage_ms("damage")
