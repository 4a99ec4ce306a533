"""grid_roofline: the run grids' (K2, `csrc/grid.cu`) least time over
their measured device time, in %, over the traced frames: the work from
each frame's diagnostics (`frame_bench/roofline.py`), the time from
`torch.profiler`'s records of the kernels `grid.cu` defines."""

from frame_bench import roofline
from frame_bench.trace import matcher


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.diags:
        return None
    s = t.device_seconds(matcher(ctx.kernels.get("grid.cu", [])))
    if s <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.grid_work(d)) for d in ctx.diags)
    return 100.0 * least / s
