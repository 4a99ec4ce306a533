"""Measurement probes: the port's counterparts of the Pallas kernels of
the JAX package's TPU tools (`tools/*.py`), each a hand-written CUDA kernel
with its plain PyTorch version and an entry point that times it on the
card.

  texture_fold   K5: texture sampling inside a fold loop
                 (`tools/texture_fold_probe.py`, csrc/texture_probe.cu)
  fold_ablate    K8: the solid/Over fold with switchable pieces
                 (`tools/fold_kernel_ablate.py`, csrc/fold_ablate.cu)
  microbench     K6 unit_stream and K7 seg_loop
                 (`tools/tpu_microbench2.py`, csrc/microbench.cu)
  grid_scatter   K9: segments accumulated into a [256, 256] window
                 (`tools/pallas_scatter_probe.py`, csrc/grid_scatter.cu)
"""

import statistics

import torch


def time_ms_graph(fn, calls: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of `fn()`: `calls` calls captured in
    one CUDA graph, whose replays are timed by CUDA events (median over
    `replays` of the mean per call).  No host work lies in the timed
    window, so it reads a kernel whose wrapper's host time exceeds its
    device time, where timing calls queued back to back reads the host's
    rate.  `fn` must not synchronise with the host.  The warm-up runs on
    the stream that is then captured, so state a wrapper keeps per stream
    (K7's workspace) exists before the capture and is not part of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def paris_taps(device="cuda") -> dict:
    """Every kernel's inputs on one paris-30k@1920x1080 frame, recorded by
    `Renderer.render_device(..., taps=)` on `device` (the scene takes ~20 s
    to build on the host)."""
    from .. import Color, Composition, Renderer
    from ..demos import scenes

    comp = Composition()
    scenes.paris30k(comp, 1920, 1080)
    taps = {}
    Renderer(device).render_device(comp, 1920, 1080, Color(1.0, 1.0, 1.0, 1.0), taps=taps)
    return taps
