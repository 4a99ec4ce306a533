"""stage_emit_ms: mean device ms a frame in the pipeline stage `emit`,
which only the two-key route runs: the pixel segments' two-word keys and
payloads, emitted in PyTorch from K1's virtual lines.  The program's own
stage stamps inside the frame graph (`forma_tpu_torch.tracing`), over
every frame it rendered; 0 where no frame took the route."""

from frame_bench import two_key


def read(ctx):
    return two_key.stage_ms("emit")
