"""device_idle_share: the share of the traced window, in %, in which no
kernel, copy or fill ran on the device (1 - the union of their intervals
over the window), from `torch.profiler`."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
