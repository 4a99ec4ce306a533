"""The PyTorch renderer facade.

Counterpart of `forma_tpu/renderer.py:28-57,59-360,991-1079`.  Each frame
runs the pipeline (`ops/pipeline.render_frame`) with optimistic capacity
buckets: the packed frame and a diagnostics vector come back together, the
diagnostics cross to the host once, and if any actual total exceeded its
bucket the buckets grow (sticky, fine-grained) and the frame re-renders.

Geometry tensors are cached on the segment buffer's version and only
re-upload when paths change; per-frame host work is O(#geometries +
#layers).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from forma_tpu import consts
from forma_tpu.buffer import RGBA
from forma_tpu.buffer import normalize_channels as _normalize_channels
from forma_tpu.composition import Composition
from forma_tpu.styling import Color

from .ops import pipeline as _pipe
from .ops import styles as _styles
from .ops._u32 import from_numpy


def _bucket(n: int, lo: int = 256) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


def _bucket_fine(n: int, lo: int = 256) -> int:
    """Sixteenth-power-of-two buckets ({16..32}/16 x 2^k): padding stays
    under 6.25%."""
    if n <= lo:
        return lo
    p = 1 << (int(n - 1).bit_length() - 1)  # largest pow2 <= n-1
    for m in range(16, 33):
        c = p * m // 16
        if c >= n:
            return c
    return p * 2


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to forma_tpu_torch yet: ROADMAP.md section 1, "
        f"item {item}"
    )


class Renderer:
    """Renders compositions with PyTorch on `device` (default: the first
    CUDA device when one is present, else the CPU)."""

    def __init__(self, device=None, caps: Optional[_pipe.Caps] = None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self._geom_cache_key = None
        self._geom_cache = None
        self._slots_cache_key = None
        self._slots_cache = None
        self._tables_cache_key = None
        self._tables_cache = None
        self._styles_cache_key = None
        self._styles_cache = None
        self._estimate_key = None
        self._style_map = _styles.StyleMap()
        self._caps = caps if caps is not None else _pipe.Caps()
        self.last_diag: Optional[np.ndarray] = None
        self.regrow_count = 0
        self._animating = False
        self._last_tver = None

    def _tensor(self, a) -> torch.Tensor:
        return from_numpy(a, self.device)  # a copy: host arrays may change

    # -- capacity headroom ---------------------------------------------------

    def _cap_headroom(self) -> float:
        """Capacity slack while transforms churn between frames (~20%),
        applied at the animating flip and to any regrow."""
        return 1.20 if self._animating else 1.0

    # -- geometry upload -----------------------------------------------------

    def _prepare_geometry(self, composition: Composition):
        buf = composition.shared_segment_buffer()
        x, y, ids = buf.flat()
        key = (buf.serial, buf.version)
        if self._geom_cache_key != key:
            if len(x) < 2:
                # No lines: one culled line keeps every array non-empty.
                px = np.zeros(2, np.float32)
                py = np.zeros(2, np.float32)
                line_slot = np.full(1, -1, np.int32)
                uniq = np.zeros(0, np.int64)
            else:
                px, py = x, y
                uniq = np.unique(ids[:-1])
                uniq = uniq[uniq != 0]
                line_ids = ids[:-1]
                slot = np.searchsorted(uniq, line_ids)
                line_slot = np.where(
                    (line_ids != 0)
                    & (slot < len(uniq))
                    & (uniq[np.minimum(slot, max(len(uniq) - 1, 0))] == line_ids),
                    slot,
                    -1,
                ).astype(np.int32)
            self._geom_cache_key = key
            self._geom_cache = (
                self._tensor(np.asarray(px, np.float32)),
                self._tensor(np.asarray(py, np.float32)),
                self._tensor(line_slot),
                uniq,
                line_slot,
            )
        return self._geom_cache[:4]

    def _geom_slots(self, composition: Composition, uniq: np.ndarray):
        """uniq geom id -> layer registry slot (-1 if unregistered); cached
        on membership changes, not on per-frame transform changes."""
        shared = composition._shared
        key = (
            shared.segment_buffer.serial,
            shared.segment_buffer.version,
            shared.scene_version,
        )
        if self._slots_cache_key != key:
            g2s = shared.geom_id_to_slot
            self._slots_cache = np.fromiter(
                (g2s.get(int(gid), -1) for gid in uniq), np.int32, count=len(uniq)
            )
            self._slots_cache_key = key
        return self._slots_cache

    def _geom_tables(self, composition: Composition, uniq: np.ndarray, st_orders):
        """Per-geometry style-slot / validity / transform tables; the
        geometry's layer resolves to its style slot here, on the host."""
        shared = composition._shared
        key = (
            shared.segment_buffer.serial,
            shared.segment_buffer.version,
            shared.scene_version,
            shared.style_version,
            shared.tform_version,
        )
        if self._tables_cache_key == key:
            return self._tables_cache
        slots = self._geom_slots(composition, uniq)
        reg = shared.registry
        g = max(len(uniq), 1)
        if len(uniq):
            sl = np.maximum(slots, 0)
            ok = slots >= 0
            g_order = np.where(ok, reg.order[sl], 0).astype(np.uint32)
            g_valid = ok & reg.valid[sl]
            g_t = reg.tform[sl].astype(np.float32)
            g_has_t = ok & reg.has_t[sl]
            pos = np.searchsorted(st_orders, g_order)
            pos = np.minimum(pos, max(len(st_orders) - 1, 0))
            found = g_valid & (st_orders[pos] == g_order)
            g_slot = np.where(found, pos, -1).astype(np.int32)
            g_valid = found
        else:
            g_slot = np.full(g, -1, np.int32)
            g_valid = np.zeros(g, bool)
            g_t = np.tile(np.asarray([1, 0, 0, 1, 0, 0], np.float32), (g, 1))
            g_has_t = np.zeros(g, bool)
        self._tables_cache_key = key
        self._tables_cache = (
            self._tensor(g_slot),
            self._tensor(g_valid),
            self._tensor(g_t),
            self._tensor(g_has_t),
        )
        return self._tables_cache

    def _estimate_caps(self, composition: Composition, width: int, height: int):
        """Pre-sizes the capacity buckets from a host numpy replay of line
        setup (transform, cull, Manhattan lengths), so the first render
        rarely regrows (`forma_tpu/renderer.py:244-334`)."""
        buf = composition.shared_segment_buffer()
        shared = composition._shared
        if self._last_tver is not None and shared.tform_version != self._last_tver:
            self._animating = True
        self._last_tver = shared.tform_version
        ekey = (
            buf.serial, buf.version, shared.scene_version, width, height,
            self._animating,
        )
        if self._estimate_key == ekey:
            return
        self._estimate_key = ekey
        x, y, ids = buf.flat()
        if len(x) < 2:
            return
        uniq = self._geom_cache[3] if self._geom_cache else None
        if uniq is None or not len(uniq):
            return
        slots = self._geom_slots(composition, uniq)
        ls = self._geom_cache[4]
        gi = np.maximum(ls, 0)
        reg = composition._shared.registry
        rslots = np.maximum(slots, 0)
        valid = (ls >= 0) & (slots[gi] >= 0) & reg.valid[rslots[gi]]
        t = reg.tform[rslots[gi]]
        has_t = reg.has_t[rslots[gi]]
        p0x, p0y = x[:-1], y[:-1]
        p1x, p1y = x[1:], y[1:]
        with np.errstate(invalid="ignore"):
            q0x = np.where(has_t, t[:, 0] * p0x + t[:, 2] * p0y + t[:, 4], p0x)
            q0y = np.where(has_t, t[:, 1] * p0x + t[:, 3] * p0y + t[:, 5], p0y)
            q1x = np.where(has_t, t[:, 0] * p1x + t[:, 2] * p1y + t[:, 4], p1x)
            q1y = np.where(has_t, t[:, 1] * p1x + t[:, 3] * p1y + t[:, 5], p1y)
            skip = (
                (q0y == q1y)
                | ((q0y >= height) & (q1y >= height))
                | ((q0x >= width) & (q1x >= width))
                | ((q0y <= 0) & (q1y <= 0))
            )
            valid &= ~skip

            def ib(u, v):
                mn = np.minimum(u, v)
                mx = np.maximum(u, v)
                return np.maximum((np.ceil(mx) - np.floor(mn) - 1), 0)

            lengths = np.where(valid, ib(q0x, q1x) + ib(q0y, q1y) + 1, 0)
            vlines = int(np.ceil(lengths / _pipe.K_SEG).sum())
        headroom = 1.20 if self._animating else 1.0626
        caps = self._caps
        h = self._cap_headroom()
        self._caps = _pipe.Caps(
            vline=max(caps.vline, _bucket_fine(int(vlines * headroom) + 512)),
            run=max(caps.run, _bucket_fine(int(caps.run * h))) if h > 1.0 else caps.run,
            virt=max(caps.virt, _bucket_fine(int(caps.virt * h))) if h > 1.0 else caps.virt,
            k=max(
                caps.k,
                256 if vlines > 100_000 else caps.k,
                _bucket(int(caps.k * h), lo=4) if h > 1.0 else caps.k,
            ),
        )

    # -- rendering -----------------------------------------------------------

    def render(
        self,
        composition: Composition,
        width: int,
        height: int,
        clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
        channels=RGBA,
        crop=None,
    ) -> np.ndarray:
        """Renders and returns u8 [height, width, 4] in channel order."""
        if crop is not None:
            raise _not_ported("crop", "11 (incremental frames)")
        frame, _ = self.render_device(composition, width, height, clear_color, channels)
        return frame[:height, :width].cpu().numpy()

    def render_device(
        self,
        composition: Composition,
        width: int,
        height: int,
        clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
        channels=RGBA,
        plain: bool = False,  # run every kernel's plain PyTorch version
        taps=None,  # dict: receives each kernel's inputs (last attempt)
    ):
        """Renders; returns (u8 frame tensor [rows*16, tiles_x*16, C] on the
        device, diag as numpy).  The diagnostics cross to the host once per
        attempt; on overflow the buckets grow and the frame re-renders."""
        composition.compact_geom()
        composition._shared.props_interner.compact()

        rows = -(-height // consts.TILE_HEIGHT)
        tiles_x = -(-width // consts.TILE_WIDTH)

        px, py, line_slot, uniq = self._prepare_geometry(composition)
        self._estimate_caps(composition, width, height)

        # Style tables depend on membership + props, not transforms.
        skey = (
            composition.shared_segment_buffer().serial,
            composition._shared.scene_version,
            composition._shared.style_version,
        )
        if self._styles_cache_key == skey:
            st_host, st = self._styles_cache
        else:
            st_host = self._style_map.build(composition.layers)
            st = _pipe.style_tables_device(st_host, self.device)
            self._styles_cache_key = skey
            self._styles_cache = (st_host, st)

        g_slot, g_valid, g_t, g_has_t = self._geom_tables(
            composition, uniq, st_host.orders
        )
        clear = torch.tensor(
            clear_color.to_array(), dtype=torch.float32, device=self.device
        )
        chans = tuple(ch.value for ch in _normalize_channels(channels, clear_color))

        for _ in range(8):  # bounded growth retries
            frame, diag = _pipe.render_frame(
                px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
                width, height, rows, tiles_x,
                self._caps, st_host.features, chans,
                plain=plain, taps=taps,
            )
            d = diag.cpu().numpy()
            caps = self._caps
            if (
                d[_pipe.DIAG_VLINES] <= caps.vline
                and d[_pipe.DIAG_RUNS] <= caps.run
                and d[_pipe.DIAG_VIRT] <= caps.virt
                and d[_pipe.DIAG_K] <= caps.k
            ):
                self.last_diag = d
                return frame, d
            self.regrow_count += 1
            h = self._cap_headroom()
            self._caps = _pipe.Caps(
                vline=max(caps.vline, _bucket_fine(int(d[_pipe.DIAG_VLINES] * h) + 1)),
                run=max(caps.run, _bucket_fine(int(d[_pipe.DIAG_RUNS] * h))),
                virt=max(caps.virt, _bucket_fine(int(d[_pipe.DIAG_VIRT] * h) + 1)),
                k=max(caps.k, _bucket(max(int(d[_pipe.DIAG_K] * h), 1), lo=4)),
            )
        raise RuntimeError(f"capacity growth did not converge: {d}")

    # -- not in this slice -------------------------------------------------

    def render_into(self, *args, **kwargs):
        raise _not_ported("render_into (buffers, pipelined readback)", "11 (incremental frames)")

    def create_buffer_layer_cache(self):
        raise _not_ported("the damage cache", "11 (incremental frames)")

    def render_device_sharded(self, *args, **kwargs):
        raise _not_ported("the framebuffer-sharded path", "13 (multi-device paths)")

    def render_device_sharded_lines(self, *args, **kwargs):
        raise _not_ported("the line-sharded path", "13 (multi-device paths)")
