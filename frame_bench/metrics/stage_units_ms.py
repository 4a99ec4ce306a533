"""stage_units_ms: mean device ms a frame in the pipeline stage `units`:
the paint units built from the runs.  The program's own stage stamps
inside the frame graph (`forma_tpu_torch.tracing`), over every frame it
rendered."""

from frame_bench import program


def read(ctx):
    return program.stage_ms("units")
