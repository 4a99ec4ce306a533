"""Per-stage timing of one frame: `Timings` and `profile_frame`, the
`gpu::Timings` analog (`forma/src/gpu/renderer/mod.rs:24-36,392-427`).

Counterpart of `forma_tpu/profiling.py`.  The JAX package re-runs every
stage as its own jitted program with its arguments re-plumbed; here the
frame runs through `Renderer.render_device` eagerly (with `taps`: a CUDA
graph cannot be fenced inside), with each pipeline stage in `STAGES`
replaced for the frame by a wrapper that fences the renderer's device
before and after it (`_fenced`).  A fence on a CUDA device is
`torch.cuda.synchronize()`; on the CPU, where every op finishes before it
returns, the host clock alone.  `Timings.fused_frame` is, as in the JAX
package, the frame as it really runs: on a card one replay of its CUDA
graph (`graphs.py`).  `python -m forma_tpu_torch.profile_stages` prints
the same stages as a table, and the graph frame beside the eager one.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import torch

from .buffer import RGBA
from .ops import fold_kernel, rasterize, runs
from .ops import pipeline as _pipe

# (module, attribute, row label, nesting depth, `Timings` field) in frame
# order.  A nested row runs inside the row above it and has no field of its
# own; a field may sum several rows (`runs`, `cull`).
STAGES = (
    (_pipe._ls, "line_setup", "line_setup", 0, "line_setup"),
    (_pipe._raster, "rasterize_sort", "rasterize_sort (K4, or K1 + emit; sort, unpack)",
     0, "rasterize_sort"),
    (rasterize, "rasterize_blocks", "K4 rasterize_blocks (fused expand + emit)", 1, None),
    (rasterize, "expand_params", "K1 expand_params", 1, None),
    (rasterize, "emit_two_key", "two-key emit kernel (ff64 emit of int64 keys)", 1, None),
    (rasterize, "sort_two_key", "two-key int64 sort", 1, None),
    (_pipe._runs, "extract_runs", "extract_runs", 0, "runs"),
    (_pipe._runs, "run_data", "run_data", 0, "runs"),
    (runs, "grid_build", "K2 grid_build", 1, None),
    (_pipe._runs, "build_units", "build_units", 0, "units"),
    (_pipe._paint, "cull_units_keep", "cull_units_keep", 0, "cull"),
    (_pipe._paint, "skip_trivial_clips_keep", "skip_trivial_clips_keep", 0, "cull"),
    (_pipe._paint, "_renumber_units", "_renumber_units", 0, "cull"),
    (_pipe._paint, "paint", "paint", 0, "paint"),
    (fold_kernel, "paint_fold", "K3 paint_fold", 1, None),
    (_pipe._srgb, "pack_srgb", "pack_srgb", 0, "srgb"),
)


class Timings(NamedTuple):
    """Stage times in ms on the renderer's device, each the minimum over
    `REPEATS` frames, fenced before and after (the fences are in them)."""

    line_setup: float
    rasterize_sort: float  # K4, or K1 + the emit; the segment sort
    runs: float  # extract_runs + run_data (K2)
    units: float  # build_units
    cull: float  # cull_units_keep + skip_trivial_clips_keep + _renumber_units
    paint: float  # K3
    srgb: float
    fused_frame: float  # one render_device(check_caps=False), fenced: a graph replay on a card
    dispatch_floor_ms: float  # one trivial op, fenced
    k_active: int  # the paint's active unit depth: the frame's DIAG_K


REPEATS = 3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _fenced(fn, times, device, outs=None):
    """`fn` with `device` fenced before and after each call; appends each
    call's ms to `times` (and its output to `outs`, when given)."""

    def wrapper(*args, **kwargs):
        _sync(device)
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(device)
        times.append((time.perf_counter() - t) * 1e3)
        if outs is not None:
            outs.append(out)
        return out

    return wrapper


@contextlib.contextmanager
def wrapped_stages(wrap, depth: int = 1):
    """While open, every stage of `STAGES` nested no deeper than `depth`
    is replaced by `wrap(fn, row label)`; the originals come back on
    exit."""
    rows = [s for s in STAGES if s[3] <= depth]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, *_ in rows]
    try:
        for (mod, attr, fn), (_, _, label, _, _) in zip(saved, rows):
            setattr(mod, attr, wrap(fn, label))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def fenced_stages(device, depth: int = 1, keep=()):
    """While open, every stage of `STAGES` nested no deeper than `depth`
    runs fenced on `device`; yields ({row label: list of ms, one per call},
    {row label in `keep`: list of outputs})."""
    acc, outs = defaultdict(list), defaultdict(list)

    def fence(fn, label):
        return _fenced(fn, acc[label], device, outs[label] if label in keep else None)

    with wrapped_stages(fence, depth):
        yield acc, outs


def _min_ms(fn, device, n: int = REPEATS) -> float:
    """The minimum over `n` calls of `fn()`, each fenced."""
    times = []
    fenced = _fenced(fn, times, device)
    for _ in range(n):
        fenced()
    return min(times)


def profile_frame(renderer, composition, width, height, clear_color, channels=None):
    """Renders the frame once to settle the capacity buckets, then
    `REPEATS` more eagerly with every top-level stage fenced, then
    `REPEATS` graph frames (`fused_frame`); returns `Timings`.  Works on
    either sort key (a two-key frame's `rasterize_sort` holds K1, the
    two-key emit and the int64 sort)."""
    channels = channels or RGBA
    dev = renderer.device

    def frame(**kw):
        return renderer.render_device(composition, width, height, clear_color, channels, **kw)

    frame()  # warm-up: grows the buckets, builds the device's kernels
    fields = Timings._fields[:7]
    per_frame = {f: [] for f in fields}
    for _ in range(REPEATS):
        with fenced_stages(dev, depth=0, keep=("_renumber_units",)) as (acc, outs):
            _, diag = frame(taps={})  # eager: taps keep the frame out of its graph
        # The paint's depth: `_renumber_units`' k_needed (JAX's cull_units[7]).
        k_active = int(outs["_renumber_units"][-1][7])
        if k_active != int(diag[_pipe.DIAG_K]):
            raise AssertionError(f"profile_frame: the paint's k {k_active} is not the "
                                 f"frame's DIAG_K {int(diag[_pipe.DIAG_K])}")
        for f in fields:
            per_frame[f].append(sum(sum(acc[label]) for _, _, label, depth, field in STAGES
                                    if depth == 0 and field == f))

    fused = _min_ms(lambda: frame(check_caps=False), dev)
    z = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    floor = _min_ms(lambda: z + 1.0, dev)
    return Timings(
        **{f: min(v) for f, v in per_frame.items()},
        fused_frame=fused,
        dispatch_floor_ms=floor,
        k_active=k_active,
    )


def timings_line(t: Timings) -> str:
    """One line of `t`, as the demo CLI prints it."""
    return (
        "timings ms: "
        f"line_setup {t.line_setup:.1f} | rasterize+sort {t.rasterize_sort:.1f} | "
        f"runs {t.runs:.1f} | units {t.units:.1f} | cull {t.cull:.1f} | "
        f"paint {t.paint:.1f} | srgb {t.srgb:.1f} | fused {t.fused_frame:.1f} "
        f"(dispatch floor ~{t.dispatch_floor_ms:.1f}) | k_active {t.k_active}"
    )
