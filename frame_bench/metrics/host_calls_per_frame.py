"""host_calls_per_frame: the CUDA runtime API calls the host makes a
frame (launches, graph launches, copies, synchronisations, events), from
`torch.profiler` over the traced frames."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    return len(t.runtime) / t.frames
