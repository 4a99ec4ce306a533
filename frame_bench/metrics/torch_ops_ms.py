"""torch_ops_ms: device ms a frame in PyTorch's own kernels and fills: every
device activity of the traced frames that is neither a copy nor a kernel
the program writes by hand (`forma_tpu_torch/csrc/*.cu`, matched by
name), from `torch.profiler`."""

from frame_bench.trace import matcher


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    hand = matcher([k for names in ctx.kernels.values() for k in names])
    s = t.device_seconds(lambda n: not n.startswith("Memcpy") and not hand(n))
    return 1e3 * s / t.frames
