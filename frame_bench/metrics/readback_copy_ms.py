"""readback_copy_ms: device ms a traced frame in copies from the device to
the host, of any kind ("Memcpy DtoH (Device -> Pageable)" or "-> Pinned"):
the frame's pixels, the diagnostics, the damage cache's reads; from
`torch.profiler`."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    return 1e3 * t.device_seconds(lambda n: n.startswith("Memcpy DtoH")) / t.frames
