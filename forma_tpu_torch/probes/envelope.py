"""The render-target envelope: how large a frame one card renders.

    python -m forma_tpu_torch.probes.envelope [--device cuda|cpu] [--sizes WxH ...]

The counterpart of `tools/envelope_probe.py:50-75` (`big_frames`).  The
format allows frames up to MAX_WIDTH x MAX_HEIGHT (65536 x 32768,
`consts.py`); what one card holds is set by its memory, since the frame's
own tensors grow with its pixels (`frame_tensor_bytes`).  The ladder is the
tool's own sizes, then on up to the format's limit (`SIZES`); each size
renders `scenes.paris30k(comp, w, h, paths=8000)`, as the tool composes it.

At each size `measure_size` builds a `Renderer(device)`, calls
`render_device` twice (cold, then warm, each ended by a synchronise), and
reports the first call's seconds, the warm call's ms, the route (the packed
key, or two keys where `pipeline.slot_bits_for` gives 0), DIAG_SEGS, the
peak of `torch.cuda.max_memory_allocated()` over each call and the
top-level pipeline stage in which the cold call reached its peak, and the
bytes of the frame-sized tensors.  On a card the cold call captures the
frame's CUDA graph (an eager warm-up frame, whose stages the peaks see,
then the capture) and replays it; the warm call replays it, so the row
also holds the graph's pool bytes and the bytes the allocator reserves
after the warm call.  It reads back only two tile-aligned windows,
top-left and bottom-right (far tiles are where an int32 offset would first
go wrong), and holds each against the numpy oracle's render of that window
(`backend_numpy.render_window`), given only the layers whose bounding
boxes meet it: exact there, since a closed path adds no cover outside its
bounding box.  Tolerance: max channel diff <= 1 (of 255).

`run_ladder` stops at the first size that raises
`torch.cuda.OutOfMemoryError`, as the tool stops at its first failure:
that error is the measurement.  Any other exception propagates.  The entry
point runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from .. import consts
from ..backend_numpy import render_window
from ..buffer import Rect
from ..composition import Composition
from ..demos import scenes
from ..ops import _build
from ..ops import pipeline as _pipe
from ..profiling import wrapped_stages
from ..renderer import Renderer
from ..styling import Color

# The tool's ladder (`tools/envelope_probe.py:51-53`), then on to the
# format's limit.
SIZES = (
    (4096, 4096), (8192, 8192), (16384, 8192),
    (16384, 16384), (32768, 16384), (32768, 32768),
    (consts.MAX_WIDTH, consts.MAX_HEIGHT),
)
PATHS = 8000  # paris30k(paths=8000), as the tool composes it
WINDOW = 256  # side of each window read back, in pixels
TOLERANCE = 1  # max channel diff against the oracle, of 255
CLEAR = Color(1.0, 1.0, 1.0, 1.0)
TW, TH = consts.TILE_WIDTH, consts.TILE_HEIGHT


def windows(width: int, height: int, size: int = WINDOW) -> tuple:
    """The top-left and bottom-right windows, each (x0, y0, w, h): `size`
    square (cut to the frame), their corners on the tile grid."""
    w, h = min(size, width), min(size, height)
    return (0, 0, w, h), ((width - w) // TW * TW, (height - h) // TH * TH, w, h)


def window_rect(window) -> Rect:
    x0, y0, w, h = window
    return Rect.new(range(x0, x0 + w), range(y0, y0 + h))


def window_orders(comp: Composition, window) -> np.ndarray:
    """u32 ids of the enabled layers whose lines' bounding box (after the
    layer's transform) meets `window` grown by a pixel on every side."""
    x, y, ids = comp.shared_segment_buffer().flat()
    gid = ids[:-1]
    live = gid != 0
    p0x, p0y = x[:-1][live].astype(np.float64), y[:-1][live].astype(np.float64)
    p1x, p1y = x[1:][live].astype(np.float64), y[1:][live].astype(np.float64)
    gid = gid[live]
    uniq = np.unique(gid)
    g2o = comp.geom_id_to_order()
    order = np.zeros(len(uniq), np.int64)
    ok = np.zeros(len(uniq), bool)
    tf = np.tile(np.asarray([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]), (len(uniq), 1))
    for k, g in enumerate(uniq):
        o = g2o.get(int(g))
        layer = comp.layers.get(o) if o is not None else None
        if layer is None or not layer.is_enabled_value:
            continue
        order[k], ok[k] = o.as_u32(), True
        if layer.affine_transform_value is not None:
            tf[k] = layer.affine_transform_value.as_slice()
    slot = np.searchsorted(uniq, gid)
    a, b, c, d, e, f = tf[slot].T
    xs = np.stack([a * p0x + c * p0y + e, a * p1x + c * p1y + e])
    ys = np.stack([b * p0x + d * p0y + f, b * p1x + d * p1y + f])
    lo_x = np.full(len(uniq), np.inf)
    hi_x = np.full(len(uniq), -np.inf)
    lo_y, hi_y = lo_x.copy(), hi_x.copy()
    np.minimum.at(lo_x, slot, xs.min(0))
    np.maximum.at(hi_x, slot, xs.max(0))
    np.minimum.at(lo_y, slot, ys.min(0))
    np.maximum.at(hi_y, slot, ys.max(0))
    x0, y0, w, h = window
    meets = (ok & (hi_x >= x0 - 1) & (lo_x <= x0 + w + 1)
             & (hi_y >= y0 - 1) & (lo_y <= y0 + h + 1))
    return order[meets].astype(np.uint32)


def oracle_window(comp: Composition, width: int, height: int, window,
                  clear: Color = CLEAR) -> np.ndarray:
    """The numpy oracle's u8 [h, w, 4] of `window` of the width x height
    frame, from the layers that can reach it."""
    x0, y0, w, h = window
    out = render_window(comp, width, height, window_rect(window), clear,
                        orders=window_orders(comp, window))
    return out[:h, :w]


def frame_tensor_bytes(width: int, height: int, channels: int = 4) -> dict:
    """Bytes of the tensors whose size is the frame's: K3's f32 [T, 1024]
    (`ops/fold_kernel.py`), paint's f32 [H, W, 4] copy in raster order,
    `pack_srgb`'s three f32 planes of the sRGB channels (held together
    before they pack), and the u8 frame."""
    rows, tiles_x = -(-height // TH), -(-width // TW)
    px = rows * TH * tiles_x * TW
    return {"k3_out": 16 * px, "paint_copy": 16 * px, "srgb_planes": 12 * px,
            "u8_frame": channels * px}


def route(n_slots: int, width: int, height: int) -> str:
    rows, tiles_x = -(-height // TH), -(-width // TW)
    return "packed" if _pipe.slot_bits_for(n_slots, rows, tiles_x) else "two-key"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_peaks(device):
    """While open, each top-level pipeline stage (`profiling.STAGES`, depth
    0) on a card resets its peak memory before it runs and reads it after;
    yields {stage: most bytes allocated while it ran} (empty off a card).
    On any device an out-of-memory error leaves a stage with a note naming
    it."""
    peaks = {}
    cuda = device.type == "cuda"

    def peaked(fn, label):
        def wrapper(*args, **kwargs):
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            try:
                out = fn(*args, **kwargs)
            except torch.cuda.OutOfMemoryError as e:
                e.add_note(f"in stage {label}")
                raise
            if cuda:
                peaks[label] = max(peaks.get(label, 0),
                                   torch.cuda.max_memory_allocated(device))
            return out
        return wrapper

    with wrapped_stages(peaked, depth=0):
        yield peaks


def _render(r, comp, width, height, clear, device) -> tuple:
    """(frame, diag, seconds, {stage: peak bytes}, peak bytes of the call)
    of one synchronised `render_device`; the peaks only on a card (None
    off it), the stages' only where the call ran them eagerly."""
    cuda = device.type == "cuda"
    with stage_peaks(device) as peaks:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        frame, d = r.render_device(comp, width, height, clear)
        _sync(device)
        seconds = time.perf_counter() - t
        # Each stage resets the peak as it starts: the call's is the most
        # of the stages' and what came after the last reset.
        peak = max([torch.cuda.max_memory_allocated(device), *peaks.values()]) if cuda else None
        return frame, d, seconds, dict(peaks), peak


def measure_size(comp: Composition, width: int, height: int, device,
                 window: int = WINDOW, clear: Color = CLEAR) -> dict:
    """One size of the ladder (see the module's text); returns its row.
    Raises if a window differs from the oracle by more than TOLERANCE."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()  # the allocator's statistics exist from here on
    r = Renderer(device)
    frame, d, first_s, cold, cold_peak = _render(r, comp, width, height, clear, device)
    del frame
    frame, d, warm_s, _, warm_peak = _render(r, comp, width, height, clear, device)
    row = {
        "size": f"{width}x{height}", "ok": True,
        "route": route(r._styles_cache[0].orders.shape[0], width, height),
        "first_s": first_s, "warm_ms": warm_s * 1e3, "segs": int(d[_pipe.DIAG_SEGS]),
        "regrows": r.regrow_count, "tensor_bytes": frame_tensor_bytes(width, height),
    }
    if cold:
        stage = max(cold, key=cold.get)
        row.update(peak_bytes=max(cold_peak, warm_peak), peak_cold_bytes=cold_peak,
                   peak_warm_bytes=warm_peak, peak_stage=stage, stage_peaks=cold,
                   graph_pool_bytes=r.graphs.pool_bytes(),
                   reserved_bytes=torch.cuda.memory_reserved(device))
    diffs = []
    for win in windows(width, height, window):
        x0, y0, w, h = win
        got = frame[y0:y0 + h, x0:x0 + w].cpu().numpy()
        want = oracle_window(comp, width, height, win, clear)
        diffs.append(int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()))
    row["windows"] = [list(win) for win in windows(width, height, window)]
    row["window_max_diff"] = diffs
    del frame, r
    if max(diffs) > TOLERANCE:
        raise AssertionError(f"{width}x{height}: windows {row['windows']} differ from the "
                             f"oracle by {diffs} (> {TOLERANCE})")
    return row


def row_line(row: dict) -> str:
    """One printed line of a ladder row."""
    if not row["ok"]:
        where = f", {row['where']}" if row["where"] else ""
        return f"{row['size']}: OUT OF MEMORY{where} ({row['error']})"
    gb = {k: v / 1e9 for k, v in row["tensor_bytes"].items()}
    peak = (f"peak {row['peak_bytes'] / 1e9:.2f} GB (cold in {row['peak_stage']}, warm "
            f"{row['peak_warm_bytes'] / 1e9:.2f}), graph pool "
            f"{row['graph_pool_bytes'] / 1e9:.2f} GB, reserved {row['reserved_bytes'] / 1e9:.2f} GB"
            if "peak_bytes" in row else "peak not measured (CPU)")
    return (f"{row['size']}: OK, route {row['route']}, first {row['first_s']:.1f} s, warm "
            f"{row['warm_ms']:.1f} ms, segs={row['segs']}, {peak}; frame tensors GB: "
            + ", ".join(f"{k} {v:.2f}" for k, v in gb.items())
            + f"; windows {row['windows']} max diff {row['window_max_diff']}")


def run_ladder(sizes=SIZES, device="cuda", paths: int = PATHS, window: int = WINDOW,
               report=print) -> list:
    """Measures each size in turn (`measure_size`), printing each row
    through `report`; stops after the first size that raises
    `torch.cuda.OutOfMemoryError`, whose row records the error.  Returns
    the rows."""
    device = torch.device(device)
    if device.type == "cuda":
        _build.lib()  # the kernels build before the first size's cold call
    rows = []
    for w, h in sizes:
        comp = Composition()
        t = time.perf_counter()
        scenes.paris30k(comp, w, h, paths=paths)
        compose_s = time.perf_counter() - t
        try:
            row = measure_size(comp, w, h, device, window)
        except torch.cuda.OutOfMemoryError as e:
            row = {"size": f"{w}x{h}", "ok": False,
                   "error": f"{type(e).__name__}: {str(e)[:300]}",
                   "where": "; ".join(getattr(e, "__notes__", []))}
        finally:
            del comp
            if device.type == "cuda":
                torch.cuda.empty_cache()
        row["compose_s"] = compose_s
        rows.append(row)
        report(row_line(row))
        if not row["ok"]:
            break
    return rows


def _size(text: str) -> tuple:
    w, h = text.lower().split("x")
    return int(w), int(h)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--sizes", nargs="+", type=_size, default=list(SIZES),
                    help="frame sizes WxH, in order (default: the ladder up to "
                         f"{consts.MAX_WIDTH}x{consts.MAX_HEIGHT})")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("envelope: no CUDA card; pass --device cpu to run on the CPU")
        print(f"card: {torch.cuda.get_device_name(0)}")
    run_ladder(args.sizes, args.device)


if __name__ == "__main__":
    main()
