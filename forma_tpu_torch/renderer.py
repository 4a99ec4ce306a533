"""The PyTorch renderer facade.

Counterpart of `forma_tpu/renderer.py:28-1079`.  Each frame runs
the pipeline (`ops/pipeline.render_frame`) with optimistic capacity
buckets: the packed frame and a diagnostics vector come back together, the
diagnostics cross to the host once, and if any actual total exceeded its
bucket the buckets grow (sticky, fine-grained) and the frame re-renders.
`render_device(check_caps=False)` skips that read: frames queue back to
back and the caller checks the device diagnostics afterwards.

Incremental frames: `render(crop=)` and `render_into(crop=)` paint only
the tiles of a rect; a `BufferLayerCache` (`create_buffer_layer_cache`)
keeps the previous frame on the device, re-emits unchanged tiles and reads
back only the damaged ones, in one round trip whose pixel prefix adapts to
the previous frame's damage; `render_into(pipelined=True)` overlaps frame
i's readback (non-blocking copies into pinned host memory on a CUDA
device) with frame i + 1's dispatch.

Multi-device frames: `render_device_sharded` (the frame sharded by tile
rows) and `render_device_sharded_lines` (the lines too, with an exchange
of segments between the shards) over a `mesh.Mesh` of the caller's
devices, one card holding several shards where it is listed so.

Compiled frames: on a CUDA device, `render_device` (and so `render`,
`render_into` plain, strided or cropped) and the damage-cached frames
(synchronous and pipelined) replay one CUDA graph per static key
(`graphs.FrameGraphs`, the counterpart of the JAX package's jitted frame
programs), captured the first time a key is seen; a capture that fails
raises.  `plain=True` and `taps=` run the frame eagerly, op by op: they
are the instruments the checks use, not a fallback.  A CPU renderer
captures nothing.  So do the multi-device frames: one graph of the whole
frame where every shard sits on the renderer's card, else one graph a
card of its piece (two for the line-sharded frame, the exchange between
them), each card's graphs in their own `FrameGraphs` (`graphs_on`).

Geometry tensors are cached on the segment buffer's version and only
re-upload when paths change; per-frame host work is O(#geometries +
#layers).

Tracing: while a `torch.profiler` session records, the host phases of a
frame are `tracing` spans (`forma.inputs`, `replay`, `capture`, `wait`,
`readback`, `write_back`), and `readback_bytes` counts every byte of
pixels read back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import consts, tracing
from .buffer import RGBA, Buffer, BufferLayerCache, LinearLayout
from .buffer import normalize_channels as _normalize_channels
from .composition import Composition
from .graphs import FrameGraphs
from .mesh import Mesh, as_device
from .ops import pipeline as _pipe
from .ops import styles as _styles
from .ops._u32 import from_numpy
from .profiling import profile_frame as _profile_frame
from .styling import Color


def _bucket(n: int, lo: int = 256) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


# Minimum damaged-tile pixel prefix read back with the diagnostics; the
# renderer adapts it to the previous frame's damage (damage is coherent from
# frame to frame), so a steady incremental frame takes one round trip with
# bytes ~ its damage.  A larger frame reads one 64-aligned remainder slice.
_DMG_PREFIX = 64


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


def _shard_rows(height: int, n: int) -> int:
    """A shard's tile rows: the frame's, padded up to a multiple of n."""
    rows_total = -(-height // consts.TILE_HEIGHT)
    return -(-rows_total // n)


class Renderer:
    """Renders compositions with PyTorch on `device`.

    `device=None` means the CUDA card, and raises `RuntimeError` when
    PyTorch sees none: the CPU is used only when the caller passes it
    (`Renderer("cpu")`), and then every kernel runs its plain PyTorch
    version.  `expand` picks the rasterizer's expand path, one of
    `ops.rasterize.EXPAND_PATHS` (checked there): `"fused"` (the fused
    expand + emit kernel, the default and the faster) or `"split"` (the
    expand kernel, then the emit in PyTorch).  Both compute the same
    segments; `"split"` is not a tuning knob, it exists so that the expand
    kernel stays on a path that is driven and checked.  The path applies
    to frames whose sort key packs into one word; a frame with more layer
    slots than that key holds takes the two-key route (`render_device`)."""

    def __init__(
        self, device=None, caps: Optional[_pipe.Caps] = None, expand: str = "fused"
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Renderer(): no CUDA device is available to PyTorch; pass "
                    "device='cpu' to render on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.expand = expand
        self._geom_cache_key = None
        self._geom_cache = None
        self._slots_cache_key = None
        self._slots_cache = None
        self._tables_cache_key = None
        self._tables_cache = None
        self._styles_cache_key = None
        self._styles_cache = None
        self._estimate_key = None
        self._pairs_cache_key = None
        self._pairs_cache = None
        # The line-sharded frame's per-shard buckets and exchange capacity,
        # sized for `_lines_n` shards.
        self._lines_n = None
        self._caps_lines = None
        self._xcap = None
        self._style_map = _styles.StyleMap()
        self._caps = caps if caps is not None else _pipe.Caps()
        self._cache_slots = 0  # 32-bit set of handed-out layer-cache ids
        self.last_diag: Optional[np.ndarray] = None
        self._last_dmg = None  # compact damaged-tile readback (idx, tiles)
        # `regrow_count` counts entries into the growth loop (tests assert a
        # warmed animation never re-enters it); transform churn between
        # renders flips `_animating`, and `announce_max_scale` bounds zooms.
        self.regrow_count = 0
        self._animating = False
        self._last_tver = None
        self._announced_scale = 1.0
        self._dmg_prefix = _DMG_PREFIX  # adaptive damage-readback prefix
        # Bytes read back to the host: every frame's pixels, and the
        # damage-cached frame's diagnostics and damaged-tile indices.
        self.readback_bytes = 0
        self._pending = None  # in-flight pipelined frame (ticket, buffer, ...)
        # The frame graphs, one per static key; only a CUDA renderer captures.
        # A sharded frame's pieces on other cards keep theirs in `_card_graphs`.
        self.graphs = FrameGraphs(self.device)
        self._card_graphs = {}

    def _tensor(self, a) -> torch.Tensor:
        return from_numpy(a, self.device)  # a copy: host arrays may change

    def profile_frame(self, composition, width, height, clear_color, channels=None):
        """Per-stage `Timings` of one frame (the `gpu::Timings` analog), each
        stage fenced on this renderer's device; see `profiling.py`."""
        return _profile_frame(self, composition, width, height, clear_color, channels)

    # -- layer caches --------------------------------------------------------

    def create_buffer_layer_cache(self):
        """Hands out one of <= 32 damage-cache slots
        (`cpu/renderer.rs:67-73`); returns None when exhausted."""
        for i in range(32):
            if not self._cache_slots & (1 << i):
                self._cache_slots |= 1 << i
                return BufferLayerCache(i, self)
        return None

    def _release_cache_slot(self, cache_id: int):
        self._cache_slots &= ~(1 << cache_id)

    # -- capacity headroom ---------------------------------------------------

    def _cap_headroom(self, area: bool = False) -> float:
        """Capacity slack while transforms churn between frames (~20%, or
        the announced zoom bound), applied at the animating flip and to any
        regrow.  `area`: the slack of the virtual units (the gap tiles
        inside shapes), which grow with the area a zoom covers: with the
        square of the announced bound (the JAX package's linear bound
        regrows there on a zoom of paris-30k)."""
        h = 1.20 if self._animating else 1.0
        if self._announced_scale > 1.0:
            s = self._announced_scale ** 2 if area else self._announced_scale
            h = max(h, s * 1.0626)
        return h

    def announce_max_scale(self, scale: float):
        """Declares the largest zoom an upcoming animation applies relative
        to the composition's current transforms, so that the capacity
        estimate bounds line lengths over the whole sequence and a zoom-in
        never regrows mid-animation.  Scales below an announced bound are
        ignored."""
        if scale > self._announced_scale:
            self._announced_scale = float(scale)
            self._estimate_key = None  # re-estimate at the new bound

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
            px = np.asarray(px, np.float32)
            py = np.asarray(py, np.float32)
            self._geom_cache_key = key
            self._geom_cache = (
                self._tensor(px), self._tensor(py), self._tensor(line_slot),
                uniq, line_slot, px, py,
            )
        return self._geom_cache[:4]

    def _prepare_line_pairs(self, composition: Composition, n: int):
        """The line-sharded frame's (p0x, p0y, p1x, p1y, line_slot) tensors:
        each line's endpoints, permuted round-robin so that shard i owns
        lines {i, i + n, ...}, a spatially uniform sample of the scene
        (paths are spatially coherent, so contiguous blocks would skew the
        shards' vline load and the exchange's destinations), padded with
        dead lines to a multiple of n; cached on the segment buffer's
        (serial, version) and n (`forma_tpu/renderer.py:834-868`)."""
        buf = composition.shared_segment_buffer()
        key = (buf.serial, buf.version, n)
        if self._pairs_cache_key != key:
            self._prepare_geometry(composition)
            line_slot, px, py = self._geom_cache[4:]
            L = line_slot.shape[0]
            pad = (-L) % n

            def padded(a, fill):
                return np.concatenate([a, np.full(pad, fill, a.dtype)])

            perm = np.argsort(np.arange(L + pad) % n, kind="stable")
            self._pairs_cache = tuple(
                self._tensor(padded(a, fill)[perm])
                for a, fill in ((px[:-1], 0), (py[:-1], 0), (px[1:], 0),
                                (py[1:], 0), (line_slot, -1))
            )
            self._pairs_cache_key = key
        return self._pairs_cache

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
            self._animating, self._announced_scale,
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
            if self._announced_scale > 1.0:
                # The bound over the announced zoom: lengths scale about
                # linearly with the transform, plus the ceil/floor slack.
                sc = self._announced_scale
                lengths = np.where(valid, lengths * sc + (sc + 1.0), 0.0)
            vlines = int(np.ceil(lengths / _pipe.K_SEG).sum())
        headroom = 1.20 if self._animating else 1.0626
        caps = self._caps
        h, hv = self._cap_headroom(), self._cap_headroom(area=True)
        self._caps = _pipe.Caps(
            vline=max(caps.vline, _bucket_fine(int(vlines * headroom) + 512)),
            run=max(caps.run, _bucket_fine(int(caps.run * h))) if h > 1.0 else caps.run,
            virt=max(caps.virt, _bucket_fine(int(caps.virt * hv))) if hv > 1.0 else caps.virt,
            k=max(
                caps.k,
                256 if vlines > 100_000 else caps.k,
                _bucket(int(caps.k * h), lo=4) if h > 1.0 else caps.k,
            ),
        )

    # -- rendering -----------------------------------------------------------

    def _frame_inputs(self, composition: Composition, width: int, height: int,
                      clear_color: Color, channels):
        """The pipeline's device inputs for a frame of a compacted
        composition: ((px, py, line_slot, g_slot, g_valid, g_t, g_has_t,
        st, clear), host style tables, channel codes), each cached on the
        versions it depends on."""
        px, py, line_slot, uniq = self._prepare_geometry(composition)
        self._estimate_caps(composition, width, height)

        # Style tables depend on membership + props, not transforms; the
        # cached tables hold the texture atlas on the device, so an
        # unchanged scene uploads it once.
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
        clear = self._tensor(np.asarray(clear_color.to_array(), np.float32))
        chans = tuple(ch.value for ch in _normalize_channels(channels, clear_color))
        inputs = (px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear)
        return inputs, st_host, chans

    def _fits(self, d, caps) -> bool:
        return (
            d[_pipe.DIAG_VLINES] <= caps.vline
            and d[_pipe.DIAG_RUNS] <= caps.run
            and d[_pipe.DIAG_VIRT] <= caps.virt
            and d[_pipe.DIAG_K] <= caps.k
        )

    def _grow(self, d, caps: _pipe.Caps) -> _pipe.Caps:
        """`caps` grown past the totals of diagnostics `d`."""
        self.regrow_count += 1
        h, hv = self._cap_headroom(), self._cap_headroom(area=True)
        return _pipe.Caps(
            vline=max(caps.vline, _bucket_fine(int(d[_pipe.DIAG_VLINES] * h) + 1)),
            run=max(caps.run, _bucket_fine(int(d[_pipe.DIAG_RUNS] * h))),
            virt=max(caps.virt, _bucket_fine(int(d[_pipe.DIAG_VIRT] * hv) + 1)),
            k=max(caps.k, _bucket(max(int(d[_pipe.DIAG_K] * h), 1), lo=4)),
        )

    def render(
        self,
        composition: Composition,
        width: int,
        height: int,
        clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
        channels=RGBA,
        crop=None,
    ) -> np.ndarray:
        """Renders and returns u8 [height, width, 4] in channel order.
        With `crop` (a `Rect`), pixels outside its tile-aligned rect stay
        zero."""
        if crop is not None:
            out = np.zeros((height, width * 4), np.uint8)
            self.render_into(
                composition,
                Buffer(buffer=out, layout=LinearLayout(width, width * 4, height)),
                clear_color, channels, crop,
            )
            return out.reshape(height, width, 4)
        frame, _ = self.render_device(composition, width, height, clear_color, channels)
        return self._read(frame[:height, :width])

    def _read(self, pixels: torch.Tensor) -> np.ndarray:
        """`pixels` on the host, counted in `readback_bytes`."""
        with tracing.span("readback"):
            img = pixels.cpu().numpy()
        self.readback_bytes += img.nbytes
        return img

    def render_into(
        self,
        composition: Composition,
        buffer: Buffer,
        clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
        channels=RGBA,
        crop=None,
        pipelined: bool = False,
    ):
        """Renders into a `Buffer` (numpy u8 [H, width_stride]); pixels
        outside `crop` (a tile-aligned `Rect`) are left untouched
        (`cpu::Renderer::render`, `forma/src/cpu/renderer.rs:75`).

        With `buffer.layer_cache` set, unchanged tiles (same layer set,
        every layer's is_unchanged bit, same clear colour) re-emit the
        previous frame's pixels and skip painting, and only the damaged
        tiles are read back and written.

        `pipelined=True` (cached, uncropped renders only) overlaps the
        damage readback with the next frame's dispatch: the call returns
        after writing the previous frame's pixels into its buffer (one
        frame of latency), and `flush_pending()` completes the last frame.
        The pixels over a whole animation are byte-equal to the synchronous
        path's."""
        layout = buffer.layout
        w, h = layout.width(), layout.height()
        cache = buffer.layer_cache
        if pipelined and cache is not None and crop is None:
            with tracing.span("inputs"):
                t = self._dispatch_cached(composition, cache, w, h, clear_color, channels)
            prev = self._pending
            self._pending = (t, buffer, layout, h, w)
            if prev is not None:
                self._complete_pending(prev, next_ticket=t)
            return
        self.flush_pending()
        if crop is not None:
            # Work-culling crop: only tiles inside the rect paint
            # (`cpu/renderer.rs:38-53`).  The damage cache survives cropped
            # renders: in-crop tiles update it, out-of-crop tiles keep their
            # entries, and the layers' is_unchanged bits stay as they were,
            # so out-of-crop tiles of a changed layer never go stale.
            rows_total = -(-h // consts.TILE_HEIGHT)
            y0t = max(crop.vert.start, 0)
            y1t = min(crop.vert.stop, rows_total)
            if y0t >= y1t:
                return
            x0 = max(crop.hor.start, 0) * consts.TILE_WIDTH
            x1 = min(crop.hor.stop * consts.TILE_WIDTH, w)
            y0 = y0t * consts.TILE_HEIGHT
            y1 = min(y1t * consts.TILE_HEIGHT, h)
            if cache is not None:
                frame, d = self._render_device_cached(
                    composition, cache, w, h, clear_color, channels,
                    crop=(y0t, y1t, crop.hor.start, crop.hor.stop),
                )
                # Out-of-crop tiles re-emit cached pixels, so they are never
                # damaged; only painted in-crop tiles write back.
                self._write_back(buffer, layout, frame, d, h, w, rect=(y0, y1, x0, x1))
                return
            frame, _ = self.render_device(
                composition, w, h, clear_color, channels,
                row_span=(y0t, y1t), crop_x=(crop.hor.start, crop.hor.stop),
            )
            img = self._read(frame[: y1 - y0, x0:x1])
            with tracing.span("write_back"):
                layout.write(buffer.buffer, img, rect=(y0, y1, x0, x1))
            return
        if cache is None:
            frame, _ = self.render_device(composition, w, h, clear_color, channels)
            img = self._read(frame[:h, :w])
            with tracing.span("write_back"):
                layout.write(buffer.buffer, img)
            return
        frame, d = self._render_device_cached(composition, cache, w, h, clear_color,
                                              channels)
        self._write_back(buffer, layout, frame, d, h, w)

    def flush_pending(self):
        """Completes the in-flight `render_into(pipelined=True)` frame, if
        any: waits for its damage readback and writes its pixels into its
        buffer.  Call once after the last pipelined frame; the synchronous
        entry points flush first."""
        prev = self._pending
        if prev is None:
            return
        self._pending = None
        self._complete_pending(prev, next_ticket=None)

    def _complete_pending(self, pend, next_ticket=None):
        """Resolves a pipelined frame and writes it back.  If resolving
        forced a capacity re-render, the successor ticket, dispatched
        against the cache state before the correction, is re-issued."""
        t, buffer, layout, h, w = pend
        frame, d = self._resolve_cached(t)
        if t.get("recovered") and next_ticket is not None:
            self._redispatch_cached(next_ticket)
        self._write_back(buffer, layout, frame, d, h, w)

    def _write_back(self, buffer, layout, frame, d, h, w, rect=None):
        """Damage-aware host write: only the changed tiles' pixels were
        read back, and only they are written (a layer cache assumes the
        same buffer is presented every frame, `layer_workbench/mod.rs:
        280-342`).  Falls back to the whole frame (or the crop rect) when
        the damage passes `DMG_CAP` tiles."""
        n_dmg = int(d[_pipe.DIAG_DMG]) if d is not None else _pipe.DMG_CAP + 1
        if n_dmg == 0:
            return  # fully unchanged: the buffer is not touched at all
        dmg = self._last_dmg
        if dmg is not None and n_dmg <= _pipe.DMG_CAP:
            idx, tiles = dmg
            with tracing.span("write_back"):
                layout.write_tiles(buffer.buffer, idx[:n_dmg], tiles[:n_dmg])
            return
        y0, y1, x0, x1 = (0, h, 0, w) if rect is None else rect
        img = self._read(frame[y0:y1, x0:x1])
        with tracing.span("write_back"):
            layout.write(buffer.buffer, img, rect=rect)

    def _render_device_cached(
        self, composition, cache, width, height, clear_color, channels,
        crop=None,  # (tile_row_lo, tile_row_hi, tile_x_lo, tile_x_hi)
        taps=None,  # dict: receives each kernel's inputs (last attempt)
    ):
        """Damage-aware render; updates `cache`'s device state and the
        layers' is_unchanged bits (`cpu/renderer.rs:217-223`); returns
        (u8 frame on the device, diag as numpy).

        With `crop`, out-of-crop tiles skip painting and re-emit their
        cached pixels; the is_unchanged bits are not updated (a cropped
        render must not certify out-of-crop tiles as current), and the
        whole-frame no-dispatch key resets."""
        with tracing.span("inputs"):
            self.flush_pending()
            t = self._dispatch_cached(composition, cache, width, height, clear_color,
                                      channels, crop, taps)
        return self._resolve_cached(t)

    def _dispatch_cached(
        self, composition, cache, width, height, clear_color, channels,
        crop=None, taps=None,
    ):
        """Queues one cached frame and starts its damage readback; returns a
        ticket for `_resolve_cached`.  The ticket keeps every input, so a
        capacity overflow found at resolve time can re-render this frame
        with grown buckets, and an already dispatched successor can be
        re-issued against the corrected cache state."""
        rows = -(-height // consts.TILE_HEIGHT)
        tiles_x = -(-width // consts.TILE_WIDTH)
        n_tiles = rows * tiles_x
        chans = tuple(ch.value for ch in _normalize_channels(channels, clear_color))

        # A completely unchanged scene re-emits the cached frame with no
        # dispatch at all (the whole-frame TileWriteOp::None).
        composition.compact_geom()
        composition._shared.props_interner.compact()
        shared = composition._shared
        vkey = (
            shared.segment_buffer.serial, shared.segment_buffer.version,
            shared.scene_version, shared.style_version, shared.tform_version,
            width, height, chans, clear_color,
        )
        if cache.prev_frame is not None and getattr(cache, "_vkey", None) == vkey:
            return {"noop": True, "cache": cache}

        inputs, st_host, chans = self._frame_inputs(
            composition, width, height, clear_color, channels
        )
        reg = shared.registry
        bit = np.uint32(1 << cache.id)
        has_layers = len(composition.layers) > 0
        if has_layers:
            st_unchanged = (reg.unchanged[st_host.lslot] & bit) != 0
        else:
            st_unchanged = np.zeros(st_host.lslot.shape[0], bool)

        cache_ok = (
            cache.prev_frame is not None
            and cache.width == width
            and cache.height == height
            and cache.channels == chans
            and cache.clear_color == clear_color
        )
        if cache_ok:
            prev_frame, prev_counts = cache.prev_frame, cache.prev_counts
        else:
            prev_frame = torch.zeros(
                (rows * consts.TILE_HEIGHT, tiles_x * consts.TILE_WIDTH, len(chans)),
                dtype=torch.uint8, device=self.device,
            )
            prev_counts = torch.full((n_tiles,), -1, dtype=torch.int32, device=self.device)

        crop_x = crop_y = None
        if crop is not None:
            crop_y, crop_x = tuple(crop[:2]), tuple(crop[2:])
        t = {
            "noop": False,
            "cache": cache,
            "inputs": inputs,
            "prev": (prev_frame, prev_counts, self._tensor(st_unchanged), cache_ok),
            "dims": (width, height, rows, tiles_x),
            "chans": chans,
            "features": st_host.features,
            "crop": (crop_x, crop_y),
            "taps": taps,
            "recovered": False,
        }
        self._issue_cached(t)

        # Device-side cache chaining: the next dispatch may consume these
        # before this frame's diagnostics are read (pipelined mode);
        # `_resolve_cached` corrects them if an overflow forces a re-render.
        cache.prev_frame = t["frame"]
        cache.prev_counts = t["counts"]
        cache.width, cache.height = width, height
        cache.channels = chans
        cache.clear_color = clear_color
        if crop is None:
            cache._vkey = vkey
            # Every enabled rendered layer is now unchanged for this slot.
            if has_layers:
                reg.unchanged[st_host.lslot] = np.where(
                    reg.valid[st_host.lslot],
                    reg.unchanged[st_host.lslot] | bit,
                    reg.unchanged[st_host.lslot] & ~bit,
                )
        else:
            cache._vkey = None
        return t

    def _compiled(self, kwargs) -> bool:
        """Whether a frame with keyword arguments `kwargs` replays a CUDA
        graph: on a CUDA device, unless `kwargs` asks for the plain
        kernels or taps (then it runs eagerly, as on the CPU)."""
        return (self.device.type == "cuda" and not kwargs.get("plain")
                and kwargs.get("taps") is None)

    def _frame(self, entry, args, kwargs, scalars):
        """One frame of pipeline entry point `entry`: where `_compiled`, a
        replay of its graph for this key (`graphs.FrameGraphs.run`; the
        row span, crop bounds and cache state in `scalars` become int32
        device scalars, outside the key), else eagerly."""
        with tracing.span("replay"):
            if not self._compiled(kwargs):
                return entry(*args, **kwargs, **scalars)
            return self.graphs.run(entry, args, kwargs, scalars, ("_caps", self._caps))

    def graphs_on(self, device) -> FrameGraphs:
        """The frame graphs of `device`: `graphs` on this renderer's own,
        a set of their own on each other card (a CUDA graph belongs to one
        card)."""
        device = as_device(device)
        if device == as_device(self.device):
            return self.graphs
        return self._card_graphs.setdefault(device, FrameGraphs(device))

    def _one_card(self, mesh: Mesh) -> bool:
        """Whether every shard of `mesh` sits on this renderer's device."""
        return set(mesh.devices) == {as_device(self.device)}

    def _sharded_frame(self, entry, mesh, args, kwargs, buckets):
        """One multi-device frame of `entry` over `mesh` (one of `args`),
        reading the bucket set `buckets`: where `_compiled` and every shard
        sits on this card, one replay of the whole frame's graph; where
        `_compiled` and the shards sit on other cards too, each card's
        piece replays that card's graph (`graphs_on`) and the collectives
        between the pieces run eagerly; else eagerly."""
        def run(fn, device, a, k):
            return self.graphs_on(device).run(fn, a, k, {}, buckets)

        with tracing.span("replay"):
            if not self._compiled(kwargs):
                return entry(*args, **kwargs)
            if self._one_card(mesh):
                return self.graphs.run(entry, args, kwargs, {}, buckets)
            return entry(*args, **kwargs, run=run)

    def _issue_cached(self, t):
        """Queues the frame of a ticket with the current caps and its kept
        previous state, and starts the damage readback: the diagnostics,
        the damaged tiles' indices and a pixel prefix sized from the
        previous frame's damage, copied without blocking into pinned host
        tensors of the ticket's own (on a CUDA device), an event recorded
        after them.  On the CPU the results are the host tensors."""
        width, height, rows, tiles_x = t["dims"]
        prev_frame, prev_counts, st_unchanged, cache_ok = t["prev"]
        crop_x, crop_y = t["crop"]
        frame, diag, counts, dmg = self._frame(
            _pipe.render_frame_cached,
            (*t["inputs"], prev_frame, prev_counts, st_unchanged),
            dict(width=width, height=height, rows=rows, tiles_x=tiles_x, caps=self._caps,
                 features=t["features"], channels=t["chans"], expand=self.expand,
                 taps=t["taps"]),
            dict(cache_ok=cache_ok, crop_x=crop_x, crop_y=crop_y),
        )
        pfx = self._dmg_prefix
        reads = (diag, dmg[0], dmg[1][:pfx])
        event = None
        with tracing.span("readback"):
            if frame.is_cuda:
                # A fresh pinned set per ticket: two tickets in flight never
                # share host memory (PyTorch's pinned allocator reuses a block
                # only after the copies recorded on it have run).
                host = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                             for a in reads)
                for h, a in zip(host, reads):
                    h.copy_(a, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                reads = host
        self.readback_bytes += sum(a.numel() * a.element_size() for a in reads)
        t.update(frame=frame, counts=counts, dmg=dmg, reads=reads, event=event,
                 pfx=pfx, caps=self._caps)

    def _redispatch_cached(self, t):
        """Re-issues an in-flight ticket after an earlier frame's capacity
        recovery replaced the cache arrays it was dispatched against; a
        no-op for a ticket that never dispatched."""
        if t["noop"]:
            return
        cache = t["cache"]
        _, _, st_unchanged, cache_ok = t["prev"]
        t["prev"] = (cache.prev_frame, cache.prev_counts, st_unchanged, cache_ok)
        self._issue_cached(t)
        cache.prev_frame = t["frame"]
        cache.prev_counts = t["counts"]

    def _resolve_cached(self, t):
        """Waits for a ticket's damage readback, growing the buckets and
        re-rendering on overflow; returns (frame, diagnostics) and leaves
        the compact damaged-tile data in `self._last_dmg`."""
        if t["noop"]:
            if self.last_diag is not None:
                self.last_diag = self.last_diag.copy()
                self.last_diag[_pipe.DIAG_K] = 0  # nothing painted
                self.last_diag[_pipe.DIAG_DMG] = 0  # nothing to write back
            self._last_dmg = None
            return t["cache"].prev_frame, self.last_diag

        for _ in range(8):
            with tracing.span("wait"):
                if t["event"] is not None:
                    t["event"].synchronize()
                d, idx_h, head = (a.numpy() for a in t["reads"])
            frame, dmg, pfx = t["frame"], t["dmg"], t["pfx"]
            n_dmg = int(d[_pipe.DIAG_DMG])
            if n_dmg <= pfx or n_dmg > _pipe.DMG_CAP:
                self._last_dmg = (idx_h, head)
            else:
                m = min(-(-n_dmg // 64) * 64, _pipe.DMG_CAP)
                rest = self._read(dmg[1][pfx:m])
                self._last_dmg = (idx_h, np.concatenate([head, rest], axis=0))
            if n_dmg <= _pipe.DMG_CAP:
                # 25% headroom, 64-aligned, at least the minimum prefix: it
                # shrinks with the damage and grows past a misprediction.
                self._dmg_prefix = int(min(
                    max(_DMG_PREFIX, -(-(n_dmg * 5 // 4) // 64) * 64), _pipe.DMG_CAP
                ))
            if self._fits(d, t["caps"]):
                break
            self._caps = self._grow(d, self._caps)
            # Re-render this frame against its kept previous state with the
            # grown buckets, and correct the chained cache arrays.
            t["recovered"] = True
            self._issue_cached(t)
            cache = t["cache"]
            cache.prev_frame = t["frame"]
            cache.prev_counts = t["counts"]
        else:
            raise RuntimeError(f"capacity growth did not converge: {d}")
        self.last_diag = d
        return frame, d

    def render_device(
        self,
        composition: Composition,
        width: int,
        height: int,
        clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
        channels=RGBA,
        check_caps: bool = True,
        row_span=None,  # (tile_row_lo, tile_row_hi): render only these rows
        crop_x=None,  # (tile_x_lo, tile_x_hi): paint only these tile columns
        plain: bool = False,  # run every kernel's plain PyTorch version
        taps=None,  # dict: receives each kernel's inputs (last attempt)
    ):
        """Renders; returns (u8 frame tensor [rows*16, tiles_x*16, C] on the
        device, diag).  With `check_caps` (the default) the diagnostics
        cross to the host as numpy once per attempt, and on overflow the
        buckets grow and the frame re-renders.  With `check_caps=False`
        nothing is read back: diag stays a device tensor, frames queue back
        to back, and the caller checks the diagnostics afterwards.  With
        `row_span`, the frame holds tile rows [lo, hi) only.

        Every fill, blend mode and clip, on either sort key: where [row |
        slot | tx] fits 31 bits (`pipeline.slot_bits_for`), the packed key
        through the renderer's `expand` path; otherwise the two-key route,
        which takes the expand kernel (K1) and the emit in PyTorch whatever
        `expand` says (the fused kernel packs only the one-word key), then
        the grid and fold kernels as every frame does.  On a CUDA device a
        kernel that fails to build or launch raises; nothing falls back to
        a plain version.  There the frame is a replay of its key's CUDA
        graph (the regrow loop replays, reads the diagnostics, grows and
        captures the new key), unless `plain` or `taps` asks for the eager
        frame."""
        inputs, st_host, chans = self._whole_frame_inputs(
            composition, width, height, clear_color, channels
        )
        rows = -(-height // consts.TILE_HEIGHT)
        tiles_x = -(-width // consts.TILE_WIDTH)
        row_lo = 0
        if row_span is not None:
            row_lo = row_span[0]
            rows = row_span[1] - row_span[0]
        return self._until_fits(lambda: self._frame(
            _pipe.render_frame,
            (*inputs, width, height, rows, tiles_x, self._caps, st_host.features, chans),
            dict(expand=self.expand, plain=plain, taps=taps),
            dict(row_lo=row_lo, crop_x=None if crop_x is None else tuple(crop_x)),
        ), check_caps)

    def _whole_frame_inputs(self, composition: Composition, width: int, height: int,
                            clear_color: Color, channels):
        """`_frame_inputs` of a frame rendered whole (no damage cache): the
        last pipelined frame completed and the composition compacted first."""
        with tracing.span("inputs"):
            self.flush_pending()
            composition.compact_geom()
            composition._shared.props_interner.compact()
            return self._frame_inputs(composition, width, height, clear_color, channels)

    def _until_fits(self, render, check_caps: bool, caps_attr: str = "_caps",
                    exchange: bool = False):
        """Calls `render()`, which reads the buckets named `caps_attr`, until
        its diagnostics fit them (and with `exchange` the line-sharded
        frame's `_xcap` too), growing them between attempts; returns
        (`render`'s frame or frames, the diagnostics as numpy).  With
        `check_caps=False` it returns the first attempt, its diagnostics
        a device tensor, and reads nothing back."""
        for _ in range(8):  # bounded growth retries
            out, diag = render()
            if not check_caps:
                return out, diag
            with tracing.span("wait"):
                d = diag.cpu().numpy()
            caps = getattr(self, caps_attr)
            xfits = not exchange or d[_pipe.DIAG_XPAIR] <= self._xcap
            if self._fits(d, caps) and xfits:
                self.last_diag = d
                return out, d
            setattr(self, caps_attr, self._grow(d, caps))
            if not xfits:
                self._xcap = 128 * -(-(int(d[_pipe.DIAG_XPAIR]) + 1) // 128)
        raise RuntimeError(f"capacity growth did not converge: {d}")

    # -- the multi-device frames --------------------------------------------

    def _shard_mesh(self, n_shards: int, devices) -> Mesh:
        """The mesh of `n_shards` shards (0: one a device) on the first
        `n_shards` of `devices`; None means every device of the renderer's
        type: each CUDA card, or the one CPU.  A device listed more than once holds
        as many shards, which run in turn."""
        if devices is None:
            devices = (
                [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                if self.device.type == "cuda" else [self.device]
            )
        devices = list(devices)
        n = n_shards or len(devices)
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        mesh = Mesh(devices[:n])
        if mesh.devices[0].type != self.device.type:
            raise ValueError(
                f"a {self.device.type} renderer places no shard on {mesh.devices[0].type}"
            )
        return mesh

    def render_device_sharded(
        self,
        composition: Composition,
        width: int,
        height: int,
        clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
        channels=RGBA,
        n_shards: int = 0,
        check_caps: bool = True,
        devices=None,
        taps=None,  # dict: receives each shard's kernel inputs under its index
    ):
        """Renders with the frame sharded by tile rows over `n_shards`
        devices (`pipeline.render_frame_sharded`; `forma_tpu/renderer.py:
        746-832`): every shard gets the whole scene, and rasterizes, sorts
        and paints only its rows.  `devices` lists the shards' devices
        (None: every device of the renderer's type; fewer than `n_shards`
        raises `ValueError`); one card holds several shards only when it
        is listed as often, for example `["cuda:0"] * 4`.  Returns (the
        shards' u8 frames, each [rows*16, tiles_x*16, C] on its device,
        diag): `torch.cat` of the frames, moved to one device, is the
        JAX package's sharded frame, whose first `height` rows are the image (the tile rows pad
        up to a multiple of the shard count).  The diagnostics are the
        maximum over the shards, so the growth loop of `render_device`
        applies, with `check_caps` as there.  On a CUDA renderer a frame
        replays CUDA graphs (`_sharded_frame`) unless `taps` asks for the
        eager frame; a renderer reuses a graph for every mesh built on the
        same devices."""
        mesh = self._shard_mesh(n_shards, devices)
        inputs, st_host, chans = self._whole_frame_inputs(
            composition, width, height, clear_color, channels
        )
        rows, tiles_x = _shard_rows(height, mesh.size), -(-width // consts.TILE_WIDTH)
        return self._until_fits(lambda: self._sharded_frame(
            _pipe.render_frame_sharded, mesh,
            (*inputs, width, height, rows, tiles_x, self._caps, st_host.features, chans, mesh),
            dict(expand=self.expand, taps=taps), ("_caps", self._caps),
        ), check_caps)

    def render_device_sharded_lines(
        self,
        composition: Composition,
        width: int,
        height: int,
        clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
        channels=RGBA,
        n_shards: int = 0,
        check_caps: bool = True,
        devices=None,
        taps=None,
    ):
        """Renders with the lines and the frame both sharded over
        `n_shards` devices (`pipeline.render_frame_sharded_lines`;
        `forma_tpu/renderer.py:870-989`): each shard rasterizes and sorts
        its own ~1/n of the lines, the segments change places to the
        shards that own their rows, and each shard sorts and paints its
        own.  Arguments and result as `render_device_sharded`, the
        diagnostics with DIAG_XPAIR and DIAG_XRECV.  The per-shard buckets
        start at 1/n of the single-device estimate and the exchange
        capacity at twice a shard's segment slots over n; both grow in
        the loop; a graph captured at smaller ones is dropped.  A scene
        whose [row | slot | tx] key passes 31 bits takes
        `render_device_sharded` instead."""
        mesh = self._shard_mesh(n_shards, devices)
        n = mesh.size
        inputs, st_host, chans = self._whole_frame_inputs(
            composition, width, height, clear_color, channels
        )
        rows, tiles_x = _shard_rows(height, n), -(-width // consts.TILE_WIDTH)
        if _pipe.slot_bits_for(st_host.orders.shape[0], rows * n, tiles_x) == 0:
            return self.render_device_sharded(
                composition, width, height, clear_color, channels, n, check_caps,
                mesh.devices, taps,
            )
        pairs = self._prepare_line_pairs(composition, n)
        if self._lines_n != n:
            c = self._caps
            self._caps_lines = _pipe.Caps(
                vline=_bucket_fine(-(-c.vline // n)),
                run=_bucket_fine(-(-c.run // n)),
                virt=_bucket_fine(-(-c.virt // n)),
                k=c.k,
            )
            est = self._caps_lines.vline * _pipe.K_SEG // n * 2
            self._xcap = max(128 * -(-est // 128), 1024)
            self._lines_n = n
        return self._until_fits(lambda: self._sharded_frame(
            _pipe.render_frame_sharded_lines, mesh,
            (*pairs, *inputs[3:], width, height, rows, tiles_x, self._caps_lines,
             st_host.features, chans, mesh, self._xcap),
            dict(expand=self.expand, taps=taps), ("_caps_lines", self._caps_lines, self._xcap),
        ), check_caps, "_caps_lines", exchange=True)
