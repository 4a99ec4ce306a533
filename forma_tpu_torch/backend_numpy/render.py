"""Orchestrates the NumPy oracle pipeline end to end.

Mirrors `cpu::Renderer::render` (`forma/src/cpu/renderer.rs:75-225`) minus the
damage caches: fill view -> rasterize -> sort -> paint -> sRGB pack.
"""

from __future__ import annotations

import numpy as np

from ..buffer import RGBA, Channel
from ..composition import Composition
from ..styling import Color
from . import fills, lines, paint, raster


def render(
    composition: Composition,
    width: int,
    height: int,
    clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
    channels=RGBA,
    crop=None,
) -> np.ndarray:
    """Renders the composition; returns u8 [height, width, 4] in the given
    channel order."""
    composition.compact_geom()
    linear = _paint_layers(composition, composition.layers, width, height,
                           clear_color, crop)
    return pack_srgb(linear, channels)


def render_window(
    composition: Composition,
    width: int,
    height: int,
    crop,
    clear_color: Color = Color(0.0, 0.0, 0.0, 1.0),
    channels=RGBA,
    orders=None,
) -> np.ndarray:
    """The tiles of `crop` (a `Rect`) of `render(composition, width,
    height, clear_color, channels, crop)`, u8 [rows * 16, tiles * 16, 4]
    cut to the frame, with no frame-sized buffer: the frame's size sets
    only the viewport.  `orders` (u32 layer ids), when given, keeps only
    those layers: a caller that knows which layers can reach the crop
    rasterizes no others."""
    composition.compact_geom()
    layers = composition.layers
    if orders is not None:
        keep = set(int(o) for o in orders)
        layers = {o: l for o, l in layers.items() if o.as_u32() in keep}
    linear = _paint_layers(composition, layers, width, height, clear_color, crop,
                           crop_only=True)
    return pack_srgb(linear, channels)


def _paint_layers(composition, layers, width, height, clear_color, crop,
                  crop_only=False) -> np.ndarray:
    """Fill view -> rasterize -> sort -> paint of `layers` (a map from
    Order to Layer of the compacted composition); linear f32 (see
    `paint.paint` for `crop` and `crop_only`)."""
    view = lines.fill_view(
        composition.shared_segment_buffer(),
        width,
        height,
        layers,
        {int(k): v for k, v in composition.geom_id_to_order().items()},
    )
    segs = raster.sort(raster.rasterize(view))
    by_order = {order.as_u32(): layer.props for order, layer in layers.items()}
    return paint.paint(
        segs, lambda lid: by_order[lid], width, height, clear_color, crop,
        crop_only=crop_only,
    )


def pack_srgb(linear: np.ndarray, channels=RGBA) -> np.ndarray:
    """Linear f32 [H, W, 4] -> sRGB u8 [H, W, 4] in channel order
    (`painter/mod.rs:466-483`)."""
    r = fills.linear_to_srgb_approx(linear[..., 0])
    g = fills.linear_to_srgb_approx(linear[..., 1])
    b = fills.linear_to_srgb_approx(linear[..., 2])
    a = linear[..., 3]
    out = np.stack(
        [fills.to_u8(ch.select(r, g, b, a)) for ch in channels], axis=-1
    )
    return out
