"""frame_ms_p95: the 95th percentile of every frame's time in the window,
in ms (host clock)."""


def read(ctx):
    v = sorted(ctx.frame_s)
    pos = (len(v) - 1) * 0.95
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return 1e3 * (v[lo] + (v[hi] - v[lo]) * (pos - lo))
