"""Host-side style-table builder.

A copy of `forma_tpu/ops/styles.py`, the numpy host code, with the port's
own `Features`: the JAX package's copy imports `Features` from its
`ops/paint.py`, which loads JAX.

The device-side analog of `gpu/style_map.rs`: serialises layer Props into
flat arrays, deduplicated through the composition's props interner
(`composition/interner.rs:19-60` + `style_map.rs:230-255`) so table rows are
per *distinct* props, with a per-layer `pidx` indirection; texture images
pack into a bounded shelf-allocated atlas (`style_map.rs:29,72-137`); and
the `Features` flags report what the frame uses so the paint kernel can
specialise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..atlas import AtlasAllocator
from ..styling import Fill, Func, GradientType

from .paint import Features


@dataclass
class StyleTables:
    orders: np.ndarray  # u32 [SL] sorted layer ids
    pidx: np.ndarray  # i32 [SL] layer slot -> distinct-props row
    lslot: np.ndarray  # i32 [SL] layer slot -> registry slot (host-side use)
    fill_rule: np.ndarray  # i32 [P]
    func: np.ndarray  # i32 [P] (0 draw, 1 clip)
    clip_n: np.ndarray  # i32 [P]
    is_clipped: np.ndarray  # bool [P]
    blend: np.ndarray  # i32 [P]
    fill_type: np.ndarray  # i32 [P]
    color: np.ndarray  # f32 [P, 4]
    grad: np.ndarray  # f32 [P, 6]
    stops: np.ndarray  # f32 [P, MS, 5]
    tex: np.ndarray  # f32 [P, 10]
    atlas: np.ndarray  # f32 [AH, AW, 4]
    features: Features
    max_stops: int


class StyleMap:
    """Persistent style serialiser: owns the texture atlas across frames so
    image allocations are reused and GC'd instead of re-packed per frame."""

    def __init__(self):
        self.allocator = AtlasAllocator()
        self._atlas_host: np.ndarray | None = None
        self._blitted: Dict[int, Tuple[int, int]] = {}  # id -> (x, y) placed

    def _ensure_atlas(self, images: Dict[int, np.ndarray]) -> np.ndarray:
        """Allocates every image and blits new/moved ones; returns the host
        atlas cropped to the used height."""
        self.allocator.begin_frame()
        if not images:
            return np.zeros((1, 1, 4), np.float32)
        for iid, im in images.items():
            self.allocator.allocate(iid, im.shape[1], im.shape[0])
        if self.allocator.end_frame():
            self._blitted = {}  # entries moved; re-blit everything live
        placements = {}
        width = 0
        for iid, (x, y, _, _) in self.allocator.rects().items():
            placements[iid] = (x, y)
            width = max(width, x + images[iid].shape[1])
        height = self.allocator.used_height
        if (
            self._atlas_host is None
            or self._atlas_host.shape[0] < height
            or self._atlas_host.shape[1] < width
        ):
            grown = np.zeros(
                (max(height, 1), max(width, 1), 4), np.float32
            )
            self._atlas_host = grown
            self._blitted = {}
        for iid, (x, y) in placements.items():
            if self._blitted.get(iid) != (x, y):
                im = images[iid]
                self._atlas_host[y : y + im.shape[0], x : x + im.shape[1]] = im
                self._blitted[iid] = (x, y)
        # Drop blit records for images the allocator GC'd.
        live = set(self.allocator.rects())
        self._blitted = {k: v for k, v in self._blitted.items() if k in live}
        return self._atlas_host

    def build(self, layers, min_stops: int = 4) -> StyleTables:
        """layers: dict[Order, Layer] of the composition."""
        # Per-layer: (order, interned props cell, registry slot), by order.
        entries = [
            (order.as_u32(), layer._props_cell_box[0], layer._slot)
            for order, layer in layers.items()
        ]
        entries.sort(key=lambda e: e[0])
        n = max(len(entries), 1)

        # Distinct props cells in use this frame.
        by_id: Dict[int, object] = {}
        for _, cell, _slot in entries:
            by_id[cell.id] = cell
        distinct = [by_id[i] for i in sorted(by_id)]
        row_of = {cell.id: row for row, cell in enumerate(distinct)}
        p = max(len(distinct), 1)

        # Stop capacity + image set (over distinct props only).
        max_real = 1
        images: Dict[int, np.ndarray] = {}
        image_of: Dict[int, object] = {}
        for cell in distinct:
            props = cell.value
            if props.func.kind == Func.DRAW:
                fill = props.func.style.fill
                if fill.kind == Fill.GRADIENT:
                    max_real = max(max_real, len(fill.gradient.stops))
                elif fill.kind == Fill.TEXTURE:
                    img = fill.texture.image
                    images[img.id] = img.data
                    image_of[img.id] = img
        ms = max(min_stops, 1 << (max_real).bit_length())

        atlas = self._ensure_atlas(images)
        offsets = {
            iid: (x, y) for iid, (x, y, _, _) in self.allocator.rects().items()
        }

        orders = np.full(n, 0xFFFFFFFF, np.uint32)
        pidx = np.zeros(n, np.int32)
        lslot = np.zeros(n, np.int32)
        fill_rule = np.zeros(p, np.int32)
        func = np.zeros(p, np.int32)
        clip_n = np.zeros(p, np.int32)
        is_clipped = np.zeros(p, bool)
        blend = np.zeros(p, np.int32)
        fill_type = np.zeros(p, np.int32)
        color = np.zeros((p, 4), np.float32)
        grad = np.zeros((p, 6), np.float32)
        stops = np.zeros((p, ms, 5), np.float32)
        stops[:, :, 4] = np.inf
        tex = np.zeros((p, 10), np.float32)

        blend_modes = {0}
        has_gradient = has_texture = has_clip = False

        for row, cell in enumerate(distinct):
            props = cell.value
            fill_rule[row] = props.fill_rule.value
            if props.func.kind == Func.CLIP:
                func[row] = 1
                clip_n[row] = props.func.clip
                has_clip = True
                continue
            style = props.func.style
            is_clipped[row] = style.is_clipped
            has_clip |= style.is_clipped
            blend[row] = style.blend_mode.value
            blend_modes.add(style.blend_mode.value)
            fill = style.fill
            fill_type[row] = fill.kind
            if fill.kind == Fill.SOLID:
                color[row] = np.asarray(fill.color.to_array(), np.float32)
            elif fill.kind == Fill.GRADIENT:
                has_gradient = True
                g = fill.gradient
                sx = np.float32(g.start.x)
                sy = np.float32(g.start.y)
                dx = np.float32(g.end.x) - sx
                dy = np.float32(g.end.y) - sy
                dot = np.float32(dx * dx + dy * dy)
                grad[row] = [
                    np.float32(1.0 if g.type == GradientType.Radial else 0.0),
                    sx,
                    sy,
                    dx,
                    dy,
                    np.float32(1.0) / dot,
                ]
                for j, (c, s) in enumerate(g.stops):
                    stops[row, j, :4] = np.asarray(c.to_array(), np.float32)
                    stops[row, j, 4] = np.float32(s)
                # Pad with (last color, +inf) so the device select chain ends
                # on the last color without per-style stop counts.
                last = np.asarray(g.stops[-1][0].to_array(), np.float32)
                for j in range(len(g.stops), ms):
                    stops[row, j, :4] = last
                    stops[row, j, 4] = np.inf
            else:
                has_texture = True
                t = fill.texture
                ax, ay = offsets[t.image.id]
                tex[row] = np.asarray(
                    t.transform.to_array()
                    + [t.image.max_x, t.image.max_y, ax, ay],
                    np.float32,
                )

        for i, (order, cell, slot) in enumerate(entries):
            orders[i] = order
            pidx[i] = row_of[cell.id]
            lslot[i] = slot

        return StyleTables(
            orders=orders,
            pidx=pidx,
            lslot=lslot,
            fill_rule=fill_rule,
            func=func,
            clip_n=clip_n,
            is_clipped=is_clipped,
            blend=blend,
            fill_type=fill_type,
            color=color,
            grad=grad,
            stops=stops,
            tex=tex,
            atlas=atlas,
            features=Features(
                blend_modes=tuple(sorted(blend_modes)),
                has_gradient=has_gradient,
                has_texture=has_texture,
                has_clip=has_clip,
            ),
            max_stops=ms,
        )


def build_style_tables(layers, min_stops: int = 4) -> StyleTables:
    """One-shot convenience wrapper (no cross-frame atlas reuse)."""
    return StyleMap().build(layers, min_stops)
