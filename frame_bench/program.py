"""Readers of what the program records of itself (`forma_tpu_torch.tracing`).

- Its host spans: `torch.profiler` ranges named `forma.<span>`, which
  `trace.Trace` keeps among the host operations of the traced frames.
  `span_ms` is a span's self time: its intervals clipped to the traced
  window, less the `forma.*` spans inside them.
- Its stage stamps: the pipeline's stage times on the device, summed by
  the program over every frame it rendered (`tracing.stage_ms`).

A program that records none of them, as one from before it traced itself,
gives nothing to read, and each reader returns None.
"""

from __future__ import annotations

import importlib

PREFIX = "forma."


def span_ms(ctx, name: str):
    """Host ms a traced frame in the program's span `forma.<name>`, less
    the `forma.*` spans inside it; 0 where the program traces itself and
    never entered it; None where the trace holds no `forma.*` span."""
    t = ctx.trace
    if t is None or t.frames <= 0:
        return None
    spans = sorted((max(s, t.t0), min(e, t.t1), n) for n, s, e in t.host_ops
                   if n.startswith(PREFIX) and e > t.t0 and s < t.t1)
    if not spans:
        return None
    total = 0
    for k, (s, e, n) in enumerate(spans):
        if n != PREFIX + name:
            continue
        inner, end = 0, s  # the union of the spans inside [s, e)
        for cs, ce, _ in spans[k + 1:]:
            if cs >= e:
                break
            ce = min(ce, e)
            if ce > end:
                inner += ce - max(cs, end)
                end = ce
        total += e - s - inner
    return total / 1e6 / t.frames


def stage_ms(stage: str):
    """The program's mean device ms a frame in pipeline stage `stage`, on
    the device it rendered the most frames on (a CUDA card, or the CPU's
    host clock in a CPU run); None where it has no such stage or no
    stamps."""
    try:
        tracing = importlib.import_module("forma_tpu_torch.tracing")
    except ImportError:
        return None
    import torch

    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    return tracing.stage_ms(max(devices, key=tracing.frames)).get(stage)
