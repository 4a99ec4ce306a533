"""Stage 0 -> 1: point chains to line coefficients.

Mirrors `SegmentBuffer::fill_cpu_view` (`forma/src/segment.rs:275-402`):
per line segment, look up its layer, apply the layer transform, cull, and
compute the pixel-grid-intersection coefficients plus the number of pixel
segments the line will emit (its "Manhattan block distance"), followed by an
inclusive prefix sum over those lengths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _f64(v):
    return np.asarray(v, np.float64)

from .. import consts


def _fma(a, b, c):
    """f32 fused multiply-add via exact f64 product (vectorised)."""
    return (_f64(a) * _f64(b) + _f64(c)).astype(np.float32)


@dataclass
class LineView:
    """SoA view of per-line rasterization inputs, one entry per line.

    `lengths` is the inclusive prefix sum of per-line pixel-segment counts.
    """

    orders: np.ndarray  # u32
    x0: np.ndarray  # f32, sub-pixel space
    y0: np.ndarray
    dx: np.ndarray
    dy: np.ndarray
    a: np.ndarray  # f32 |1/dx| (pixel space)
    b: np.ndarray  # f32 |1/dy|
    c: np.ndarray  # f32 first vertical grid crossing parameter
    d: np.ndarray  # f32 first horizontal grid crossing parameter
    lengths: np.ndarray  # u32 inclusive prefix sum


def fill_view(segment_buffer, width, height, layers, geom_id_to_order) -> LineView:
    """layers: dict[Order, Layer]; geom_id_to_order: dict[GeomId, Order|None]."""
    x, y, ids = segment_buffer.flat()
    n_lines = max(len(x) - 1, 0)
    if n_lines == 0:
        return LineView(*[np.zeros(0, dt) for dt in
                          (np.uint32, np.float32, np.float32, np.float32, np.float32,
                           np.float32, np.float32, np.float32, np.float32, np.uint32)])

    p0x = x[:-1].astype(np.float32)
    p0y = y[:-1].astype(np.float32)
    p1x = x[1:].astype(np.float32)
    p1y = y[1:].astype(np.float32)
    line_ids = ids[:-1]

    # Per-geometry lookup tables.
    uniq = np.unique(line_ids)
    g_order = np.zeros(len(uniq), np.uint32)
    g_valid = np.zeros(len(uniq), bool)
    g_t = np.tile(np.asarray([1, 0, 0, 1, 0, 0], np.float32), (len(uniq), 1))
    g_has_t = np.zeros(len(uniq), bool)
    for k, gid_ in enumerate(uniq):
        gid = int(gid_)
        if gid == 0:
            continue
        order = geom_id_to_order.get(gid)
        if order is None:
            continue
        layer = layers.get(order)
        if layer is None or not layer.is_enabled_value or layer.order is None:
            continue
        g_order[k] = layer.order.as_u32()
        g_valid[k] = True
        t = layer.affine_transform_value
        if t is not None:
            g_t[k] = np.asarray(t.as_slice(), np.float32)
            g_has_t[k] = True

    slot = np.searchsorted(uniq, line_ids)
    valid = g_valid[slot]
    orders = g_order[slot]

    t = g_t[slot]
    has_t = g_has_t[slot]
    # transform_point (`segment.rs:30-39`).
    tp0x = _fma(t[:, 0], p0x, _fma(t[:, 2], p0y, t[:, 4]))
    tp0y = _fma(t[:, 1], p0x, _fma(t[:, 3], p0y, t[:, 5]))
    tp1x = _fma(t[:, 0], p1x, _fma(t[:, 2], p1y, t[:, 4]))
    tp1y = _fma(t[:, 1], p1x, _fma(t[:, 3], p1y, t[:, 5]))
    p0x = np.where(has_t, tp0x, p0x)
    p0y = np.where(has_t, tp0y, p0y)
    p1x = np.where(has_t, tp1x, p1x)
    p1y = np.where(has_t, tp1y, p1y)

    # skip_line culling (`segment.rs:41-52`).
    w = np.float32(width)
    h = np.float32(height)
    skip = (
        (p0y == p1y)
        | ((p0y >= h) & (p1y >= h))
        | ((p0x >= w) & (p1x >= w))
        | ((p0y <= 0.0) & (p1y <= 0.0))
    )
    valid &= ~skip

    with np.errstate(divide="ignore", invalid="ignore"):
        dx = (p1x - p0x).astype(np.float32)
        dy = (p1y - p0y).astype(np.float32)
        dx_recip = (np.float32(1.0) / dx).astype(np.float32)
        dy_recip = (np.float32(1.0) / dy).astype(np.float32)

        t_offset_x = np.where(
            dx != 0.0,
            np.maximum(
                (np.ceil(p0x) - p0x) * dx_recip, (np.floor(p0x) - p0x) * dx_recip
            ),
            np.float32(0.0),
        ).astype(np.float32)
        t_offset_y = np.where(
            dy != 0.0,
            np.maximum(
                (np.ceil(p0y) - p0y) * dy_recip, (np.floor(p0y) - p0y) * dy_recip
            ),
            np.float32(0.0),
        ).astype(np.float32)

    a = np.abs(dx_recip)
    b = np.abs(dy_recip)
    c = t_offset_x
    d = t_offset_y

    # Manhattan block distance (`segment.rs:54-88`).
    def integers_between(u, v):
        mn = np.minimum(u, v)
        mx = np.maximum(u, v)
        return np.maximum(
            (np.ceil(mx) - np.floor(mn) - 1.0).astype(np.int64), 0
        ).astype(np.uint32)

    lengths = integers_between(p0x, p1x) + integers_between(p0y, p1y) + np.uint32(1)
    lengths = np.where(valid, lengths, np.uint32(0))

    pw = np.float32(consts.PIXEL_WIDTH)
    zero = np.float32(0.0)
    return LineView(
        orders=np.where(valid, orders, 0).astype(np.uint32),
        x0=np.where(valid, p0x * pw, zero).astype(np.float32),
        y0=np.where(valid, p0y * pw, zero).astype(np.float32),
        dx=np.where(valid, dx * pw, zero).astype(np.float32),
        dy=np.where(valid, dy * pw, zero).astype(np.float32),
        a=np.where(valid, a, zero).astype(np.float32),
        b=np.where(valid, b, zero).astype(np.float32),
        c=np.where(valid, c, zero).astype(np.float32),
        d=np.where(valid, d, zero).astype(np.float32),
        lengths=np.cumsum(lengths, dtype=np.uint32),
    )
