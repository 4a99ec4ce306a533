"""fold_roofline: the paint fold's (K3, `csrc/fold.cu`) least time over its
measured device time, in %, over the traced frames: the work from each
frame's diagnostics (`frame_bench/roofline.py`), the time from
`torch.profiler`'s records of the kernels `fold.cu` defines."""

from frame_bench import roofline
from frame_bench.trace import matcher


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.diags:
        return None
    s = t.device_seconds(matcher(ctx.kernels.get("fold.cu", [])))
    if s <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.fold_work(d, ctx.width, ctx.height))
                for d in ctx.diags)
    return 100.0 * least / s
