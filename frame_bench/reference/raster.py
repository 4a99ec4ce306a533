"""Lines to sorted pixel segments, in the plain reference.

A frozen copy of the renderer's numpy oracle (forma's `segment.rs`
`fill_cpu_view` and `cpu/rasterizer.rs`): each line is transformed by its
layer's transform, culled, and cut into pixel segments on the 16x16
sub-pixel grid, the i-th segment found in O(1) as the i-th element of the
merged union of the line's vertical and horizontal grid crossings (f64
index estimates, as the reference CPU backend); segments sort by (tile
row, tile column, layer).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PIXEL_WIDTH = 16
PIXEL_SHIFT = 4
TILE = 16
TILE_SHIFT = 4
LAYER_LIMIT = (1 << 21) - 1


def _f64(v):
    return np.asarray(v, np.float64)


def _fma(a, b, c):
    return (_f64(a) * _f64(b) + _f64(c)).astype(np.float32)


@dataclass
class Segments:
    """Pixel segments, one entry each."""

    layer: np.ndarray  # u32
    tile_x: np.ndarray  # i32, >= -1
    tile_y: np.ndarray  # i32, >= -1
    local_x: np.ndarray  # u8
    local_y: np.ndarray  # u8
    double_area: np.ndarray  # i32
    cover: np.ndarray  # i32


def transform_lines(x0, y0, x1, y1, t):
    """Each line's endpoints by its layer's transform `t` (f32 [N, 6] rows
    of ux, uy, vx, vy, tx, ty), with `mul_add` as forma does."""
    def apply(x, y):
        return (_fma(t[:, 0], x, _fma(t[:, 2], y, t[:, 4])),
                _fma(t[:, 1], x, _fma(t[:, 3], y, t[:, 5])))

    return (*apply(x0, y0), *apply(x1, y1))


def rasterize(x0, y0, x1, y1, layer, width, height) -> Segments:
    """The pixel segments of lines (x0, y0) -> (x1, y1) (f32, pixels,
    transformed), each of layer id `layer` (u32), in a width x height
    viewport, sorted."""
    w, h = np.float32(width), np.float32(height)
    valid = ~((y0 == y1) | ((y0 >= h) & (y1 >= h)) | ((x0 >= w) & (x1 >= w))
              | ((y0 <= 0.0) & (y1 <= 0.0)))
    x0, y0, x1, y1, layer = x0[valid], y0[valid], x1[valid], y1[valid], layer[valid]

    with np.errstate(divide="ignore", invalid="ignore"):
        dx = (x1 - x0).astype(np.float32)
        dy = (y1 - y0).astype(np.float32)
        dxr = (np.float32(1.0) / dx).astype(np.float32)
        dyr = (np.float32(1.0) / dy).astype(np.float32)
        c = np.where(dx != 0.0, np.maximum((np.ceil(x0) - x0) * dxr,
                                           (np.floor(x0) - x0) * dxr),
                     np.float32(0.0)).astype(np.float32)
        d = np.where(dy != 0.0, np.maximum((np.ceil(y0) - y0) * dyr,
                                           (np.floor(y0) - y0) * dyr),
                     np.float32(0.0)).astype(np.float32)
    a = np.abs(dxr)
    b = np.abs(dyr)

    def between(u, v):
        return np.maximum((np.ceil(np.maximum(u, v)) - np.floor(np.minimum(u, v))
                           - 1.0).astype(np.int64), 0)

    lengths = between(x0, x1) + between(y0, y1) + 1
    ends = np.cumsum(lengths)
    total = int(ends[-1]) if len(ends) else 0
    if total == 0:
        z = np.zeros(0, np.int32)
        return Segments(z.astype(np.uint32), z, z, z.astype(np.uint8),
                        z.astype(np.uint8), z, z)

    i = np.arange(total, dtype=np.int64)
    li = np.searchsorted(ends, i, side="right")
    seg_i = i - np.where(li > 0, ends[np.maximum(li - 1, 0)], 0)
    a, b, c, d = a[li], b[li], c[li], d[li]

    ii = seg_i - (c != 0.0) - (d != 0.0)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        sum_recip = 1.0 / (_f64(a) + _f64(b))
        a_over = _f64(a) * sum_recip
        b_over = _f64(b) * sum_recip
        cd_over = (_f64(c) - _f64(d)) * sum_recip

    def find(j):
        fi = j.astype(np.float32)
        with np.errstate(invalid="ignore", over="ignore"):
            ja = np.where(np.isfinite(b), np.ceil(b_over * fi.astype(np.float64)
                                                  - cd_over).astype(np.float32), fi)
            jb = np.where(np.isfinite(a), np.ceil(a_over * fi.astype(np.float64)
                                                  + cd_over).astype(np.float32), fi)
            ga = (_f64(a) * _f64(ja) + _f64(c)).astype(np.float32)
            gb = (_f64(b) * _f64(jb) + _f64(d)).astype(np.float32)
        ga = np.where(np.isnan(ga), np.float32(np.inf), ga)
        gb = np.where(np.isnan(gb), np.float32(np.inf), gb)
        return np.minimum(ga, gb)

    t0 = np.maximum(find(ii), np.float32(0.0))
    t1 = np.minimum(find(ii + 1), np.float32(1.0))
    pw = np.float32(PIXEL_WIDTH)
    sx0, sy0, sdx, sdy = x0[li] * pw, y0[li] * pw, dx[li] * pw, dy[li] * pw

    def rnd(v):
        return np.floor(v + np.float32(0.5)).astype(np.int32)

    xa, xb = rnd(_fma(t0, sdx, sx0)), rnd(_fma(t1, sdx, sx0))
    ya, yb = rnd(_fma(t0, sdy, sy0)), rnd(_fma(t1, sdy, sy0))
    border_x = np.minimum(xa, xb) >> PIXEL_SHIFT
    border_y = np.minimum(ya, yb) >> PIXEL_SHIFT
    border = (border_x << PIXEL_SHIFT) + PIXEL_WIDTH
    mult = (np.abs(xb - xa) + 2 * (border - np.maximum(xa, xb))).astype(np.int32)
    cover = (yb - ya).astype(np.int32)
    segs = Segments(
        layer=(layer[li] & np.uint32(LAYER_LIMIT)).astype(np.uint32),
        tile_x=np.maximum(border_x >> TILE_SHIFT, -1).astype(np.int32),
        tile_y=np.maximum(border_y >> TILE_SHIFT, -1).astype(np.int32),
        local_x=(border_x & (TILE - 1)).astype(np.uint8),
        local_y=(border_y & (TILE - 1)).astype(np.uint8),
        double_area=(mult * cover).astype(np.int32),
        cover=cover,
    )
    order = np.lexsort((segs.layer, segs.tile_x, segs.tile_y))
    return Segments(*(getattr(segs, f)[order] for f in segs.__dataclass_fields__))
