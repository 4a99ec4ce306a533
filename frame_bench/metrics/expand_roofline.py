"""expand_roofline: the virtual-line expansion's (K1, `csrc/expand.cu`)
least time over its measured device time, in %, over the traced frames:
the work from each frame's diagnostics (`frame_bench/two_key.py`), the
time from `torch.profiler`'s records of the kernels `expand.cu` defines.
By default only a frame on the two-key route runs K1."""

from frame_bench import roofline, two_key
from frame_bench.trace import matcher


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.diags:
        return None
    s = t.device_seconds(matcher(ctx.kernels.get("expand.cu", [])))
    if s <= 0:
        return None
    least = sum(roofline.least_seconds(*two_key.expand_work(d)) for d in ctx.diags)
    return 100.0 * least / s
