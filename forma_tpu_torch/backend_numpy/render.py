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

    view = lines.fill_view(
        composition.shared_segment_buffer(),
        width,
        height,
        composition.layers,
        {int(k): v for k, v in composition.geom_id_to_order().items()},
    )
    segs = raster.sort(raster.rasterize(view))

    by_order = {
        order.as_u32(): layer.props for order, layer in composition.layers.items()
    }

    linear = paint.paint(
        segs, lambda lid: by_order[lid], width, height, clear_color, crop
    )

    return pack_srgb(linear, channels)


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
