"""stage_expand_ms: mean device ms a frame in the pipeline stage `expand`,
which only the two-key route runs: K1 (`csrc/expand.cu`) copying each
line's params onto its virtual lines.  The program's own stage stamps
inside the frame graph (`forma_tpu_torch.tracing`), over every frame it
rendered; 0 where no frame took the route."""

from frame_bench import two_key


def read(ctx):
    return two_key.stage_ms("expand")
