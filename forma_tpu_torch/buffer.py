"""Output buffer descriptions: channel mappings and layouts.

A copy of `forma_tpu/buffer.py` (the JAX package's host scene model,
plain numpy): the port imports nothing of the JAX package.

Mirrors `forma/src/cpu/{channel.rs,buffer/}`.  A `Channel` names which source
channel (or constant) lands in each output byte; `LinearLayout` describes a
strided linear buffer.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np


class Channel(enum.Enum):
    Red = 0
    Green = 1
    Blue = 2
    Alpha = 3
    Zero = 4
    One = 5

    def select(self, r, g, b, a):
        if self is Channel.Red:
            return r
        if self is Channel.Green:
            return g
        if self is Channel.Blue:
            return b
        if self is Channel.Alpha:
            return a
        if self is Channel.Zero:
            return np.zeros_like(r)
        return np.ones_like(r)


RGBA = (Channel.Red, Channel.Green, Channel.Blue, Channel.Alpha)
BGRA = (Channel.Blue, Channel.Green, Channel.Red, Channel.Alpha)
RGB0 = (Channel.Red, Channel.Green, Channel.Blue, Channel.Zero)
BGR0 = (Channel.Blue, Channel.Green, Channel.Red, Channel.Zero)
RGB1 = (Channel.Red, Channel.Green, Channel.Blue, Channel.One)
BGR1 = (Channel.Blue, Channel.Green, Channel.Red, Channel.One)


def normalize_channels(channels, clear_color):
    """Alpha -> One upgrade when the clear color is opaque: src-over keeps
    alpha at exactly 1 forever, so the packed alpha byte is a constant and
    the compiled pipeline never materialises the alpha plane
    (`forma/src/cpu/renderer.rs:85-92`)."""
    if clear_color.a == 1.0:
        return tuple(
            Channel.One if ch is Channel.Alpha else ch for ch in channels
        )
    return tuple(channels)


@dataclass
class Rect:
    """Crop rectangle, approximated to the tile grid
    (`forma/src/cpu/renderer.rs:38-53`)."""

    hor: range
    vert: range

    @staticmethod
    def new(horizontal: range, vertical: range) -> "Rect":
        from . import consts

        tw, th = consts.TILE_WIDTH, consts.TILE_HEIGHT
        return Rect(
            hor=range(horizontal.start // tw, -(-horizontal.stop // tw)),
            vert=range(vertical.start // th, -(-vertical.stop // th)),
        )


class Flusher:
    """Post-write hook (`forma/src/cpu/buffer/layout/mod.rs:31-34`): called
    with the written byte region after every render (e.g. cache flush on
    memory-mapped framebuffers)."""

    def flush(self, data: np.ndarray) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class Layout:
    """Buffer layout interface (`forma/src/cpu/buffer/layout/mod.rs:51-163`):
    maps the rendered tile grid onto a user byte buffer and exposes an
    optional `Flusher`.  The TPU backend renders whole frames on device, so
    the per-tile-slice machinery of the reference collapses to `write`."""

    def width(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def height(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def flusher(self) -> Optional[Flusher]:
        return None

    def write(self, buffer: np.ndarray, img: np.ndarray, rect=None) -> None:
        """Writes u8 [h, w, 4] pixels into `buffer`, full frame or a
        tile-aligned sub-rect (`TileFill::{Full,...}` write paths)."""
        raise NotImplementedError

    def write_tiles(self, buffer: np.ndarray, idx: np.ndarray, tiles: np.ndarray) -> None:
        """Writes a compact set of damaged tiles: `idx[i]` is a tile index
        (row-major over the tile grid), `tiles[i]` its pixels as u8
        [TILE_HEIGHT, TILE_WIDTH*4].  Unlisted tiles are left untouched —
        the write side of the reference's `TileWriteOp::None` fast path."""
        raise NotImplementedError


class LinearLayout(Layout):
    """Linear RGBA-strided buffer layout
    (`forma/src/cpu/buffer/layout/mod.rs:167-296`)."""

    def __init__(self, width: int, width_stride: int, height: int, flusher=None):
        assert width * 4 <= width_stride
        self._width = width
        self._width_stride = width_stride
        self._height = height
        self._flusher = flusher

    def width(self) -> int:
        return self._width

    def height(self) -> int:
        return self._height

    def width_stride(self) -> int:
        return self._width_stride

    def flusher(self) -> Optional[Flusher]:
        return self._flusher

    def write(self, buffer: np.ndarray, img: np.ndarray, rect=None) -> None:
        h, w = self._height, self._width
        target = buffer.reshape(h, -1)[:, : w * 4].reshape(h, w, 4)
        if rect is None:
            target[:] = img
            region = buffer
        else:
            y0, y1, x0, x1 = rect
            target[y0:y1, x0:x1] = img
            region = buffer.reshape(h, -1)[y0:y1]
        if self._flusher is not None:
            self._flusher.flush(region)

    def write_tiles(self, buffer: np.ndarray, idx: np.ndarray, tiles: np.ndarray) -> None:
        from . import consts

        th, tw = consts.TILE_HEIGHT, consts.TILE_WIDTH
        h, w = self._height, self._width
        tiles_x = -(-w // tw)
        target = buffer.reshape(h, -1)[:, : w * 4].reshape(h, w, 4)
        tiles4 = tiles.reshape(tiles.shape[0], th, tw, 4)
        for t, px in zip(idx.tolist(), tiles4):
            r, c = divmod(int(t), tiles_x)
            y0, x0 = r * th, c * tw
            y1, x1 = min(y0 + th, h), min(x0 + tw, w)
            target[y0:y1, x0:x1] = px[: y1 - y0, : x1 - x0]
        if self._flusher is not None and len(idx):
            rs = np.asarray(idx) // tiles_x
            y0 = int(rs.min()) * th
            y1 = min((int(rs.max()) + 1) * th, h)
            self._flusher.flush(buffer.reshape(h, -1)[y0:y1])


class BufferLayerCache:
    """Per-buffer damage cache slot (`forma/src/cpu/buffer/mod.rs:113-197`).

    The TPU analog of `CachedTile` (`cpu/painter/mod.rs:629-714`): the
    previous frame and per-tile unit counts stay ON DEVICE; a tile whose
    layer set is unchanged (same count, every layer's is_unchanged bit set,
    same clear color) re-emits its previous pixels and skips all blending
    (`passes/tile_unchanged.rs:24-57`).
    """

    def __init__(self, cache_id: int, owner=None):
        self.id = cache_id
        self.clear_color = None
        self.width: Optional[int] = None
        self.height: Optional[int] = None
        self.channels = None
        self.prev_frame = None  # device u8 [rows*16, tiles_x*16, C]
        self.prev_counts = None  # device i32 [rows * tiles_x]
        # Slot release must not depend on prompt __del__ (reference cycles,
        # interpreter teardown) and must not keep the Renderer alive — the
        # reference uses Weak<SmallBitSet> + Drop (`buffer/mod.rs:99-111`).
        if owner is not None:
            import weakref

            owner_ref = weakref.ref(owner)

            def _release(cache_id=cache_id, owner_ref=owner_ref):
                o = owner_ref()
                if o is not None:
                    o._release_cache_slot(cache_id)

            self._finalizer = weakref.finalize(self, _release)

    def clear(self):
        self.clear_color = None
        self.width = None
        self.height = None
        self.channels = None
        self.prev_frame = None
        self.prev_counts = None



@dataclass
class Buffer:
    """Binds a user byte buffer (numpy u8 [height, width_stride]) to a layout."""

    buffer: np.ndarray
    layout: LinearLayout
    layer_cache: Optional[BufferLayerCache] = None


class BufferBuilder:
    """Fluent builder binding a byte buffer + layout + optional layer cache
    (`forma/src/cpu/buffer/mod.rs:43-97`)."""

    def __init__(self, buffer: np.ndarray, layout: Layout):
        self._buffer = buffer
        self._layout = layout
        self._layer_cache: Optional[BufferLayerCache] = None

    def layer_cache(self, cache: BufferLayerCache) -> "BufferBuilder":
        self._layer_cache = cache
        return self

    def build(self) -> Buffer:
        return Buffer(
            buffer=self._buffer, layout=self._layout, layer_cache=self._layer_cache
        )
