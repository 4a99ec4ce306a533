"""Stage 2 + 3: lines to sorted pixel segments.

Mirrors `Rasterizer::{rasterize,sort}` (`forma/src/cpu/rasterizer.rs`): the
workload is sharded per *output* pixel segment via the length prefix sum, and
the i-th pixel segment of a line is found in O(1) as the i-th element of the
merged ordered union of the two arithmetic progressions a*t+c (vertical grid
crossings) and b*t+d (horizontal crossings).

This oracle uses real f64 for the index estimation, exactly like the
reference CPU backend; the device backends replicate it with float-float
arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _f64(v):
    return np.asarray(v, np.float64)

from .. import consts
from .lines import LineView


@dataclass
class PixelSegments:
    """Unpacked SoA pixel segments (conceptually the u64 of
    `forma/src/cpu/pixel_segment.rs`)."""

    layer: np.ndarray  # u32 (21 bits)
    tile_x: np.ndarray  # i32, clamped to >= -1 (bias + max(0))
    tile_y: np.ndarray  # i32, clamped to >= -1
    local_x: np.ndarray  # u8
    local_y: np.ndarray  # u8
    double_area: np.ndarray  # i32 = multiplier * cover
    cover: np.ndarray  # i32

    def __len__(self):
        return len(self.layer)


def _find(i, a_over, b_over, cd_over, a, b, c, d):
    """The i-th element of the merged progressions (`rasterizer.rs:22-61`).

    All *_over operands are f64; a,b,c,d are f32.  NaN guesses lose the min,
    matching Rust's `f32::min` NaN semantics.
    """
    fi = i.astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        ja = np.where(
            np.isfinite(b),
            np.ceil(b_over * fi.astype(np.float64) - cd_over).astype(np.float32),
            fi,
        )
        jb = np.where(
            np.isfinite(a),
            np.ceil(a_over * fi.astype(np.float64) + cd_over).astype(np.float32),
            fi,
        )
        guess_a = (_f64(a) * _f64(ja) + _f64(c)).astype(np.float32)
        guess_b = (_f64(b) * _f64(jb) + _f64(d)).astype(np.float32)
    # Rust f32::min returns the non-NaN operand.
    guess_a = np.where(np.isnan(guess_a), np.float32(np.inf), guess_a)
    guess_b = np.where(np.isnan(guess_b), np.float32(np.inf), guess_b)
    return np.minimum(guess_a, guess_b)


def rasterize(view: LineView) -> PixelSegments:
    lengths = view.lengths
    total = int(lengths[-1]) if len(lengths) else 0
    empty = [np.zeros(0, np.int32)] * 7
    if total == 0:
        return PixelSegments(*empty)

    i = np.arange(total, dtype=np.uint32)
    line_i = np.searchsorted(lengths, i, side="right")
    base = np.where(line_i > 0, lengths[np.maximum(line_i - 1, 0)], 0)
    seg_i = (i - base).astype(np.int64)

    a = view.a[line_i]
    b = view.b[line_i]
    c = view.c[line_i]
    d = view.d[line_i]

    # get_ith_pixel_segment_params (`rasterizer.rs:63-76`).
    ii = seg_i - (c != 0.0) - (d != 0.0)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        sum_recip = 1.0 / (_f64(a) + _f64(b))
        a_over = _f64(a) * sum_recip
        b_over = _f64(b) * sum_recip
        cd_over = (_f64(c) - _f64(d)) * sum_recip

    t0 = _find(ii, a_over, b_over, cd_over, a, b, c, d)
    t1 = _find(ii + 1, a_over, b_over, cd_over, a, b, c, d)
    t0 = np.maximum(t0, np.float32(0.0))
    t1 = np.minimum(t1, np.float32(1.0))

    def fma(x, y, z):
        return (_f64(x) * _f64(y) + _f64(z)).astype(np.float32)

    x0f = fma(t0, view.dx[line_i], view.x0[line_i])
    y0f = fma(t0, view.dy[line_i], view.y0[line_i])
    x1f = fma(t1, view.dx[line_i], view.x0[line_i])
    y1f = fma(t1, view.dy[line_i], view.y0[line_i])

    def round_(v):
        return np.floor(v + np.float32(0.5)).astype(np.int32)

    x0_sub = round_(x0f)
    x1_sub = round_(x1f)
    y0_sub = round_(y0f)
    y1_sub = round_(y1f)

    border_x = np.minimum(x0_sub, x1_sub) >> consts.PIXEL_SHIFT
    border_y = np.minimum(y0_sub, y1_sub) >> consts.PIXEL_SHIFT

    tile_x = border_x >> consts.TILE_WIDTH_SHIFT
    tile_y = border_y >> consts.TILE_HEIGHT_SHIFT
    local_x = (border_x & (consts.TILE_WIDTH - 1)).astype(np.uint8)
    local_y = (border_y & (consts.TILE_HEIGHT - 1)).astype(np.uint8)

    border = (border_x << consts.PIXEL_SHIFT) + consts.PIXEL_WIDTH
    height = y1_sub - y0_sub

    double_area_multiplier = (
        np.abs(x1_sub - x0_sub) + 2 * (border - np.maximum(x0_sub, x1_sub))
    ).astype(np.int32)
    cover = height.astype(np.int32)

    # The bit packing clamps biased tile coordinates at zero
    # (`pixel_segment.rs:47-52`), i.e. tiles left/above the viewport all land
    # on tile -1.
    tile_x = np.maximum(tile_x, -consts.TILE_BIAS)
    tile_y = np.maximum(tile_y, -consts.TILE_BIAS)

    return PixelSegments(
        layer=(view.orders[line_i] & np.uint32(consts.LAYER_LIMIT)).astype(np.uint32),
        tile_x=tile_x.astype(np.int32),
        tile_y=tile_y.astype(np.int32),
        local_x=local_x,
        local_y=local_y,
        double_area=(double_area_multiplier * cover).astype(np.int32),
        cover=cover,
    )


def sort(segs: PixelSegments) -> PixelSegments:
    """Sorts by (tile_y, tile_x, layer); finer key bits are irrelevant because
    accumulation is integer addition (order independent)."""
    order = np.lexsort((segs.layer, segs.tile_x, segs.tile_y))
    return PixelSegments(
        layer=segs.layer[order],
        tile_x=segs.tile_x[order],
        tile_y=segs.tile_y[order],
        local_x=segs.local_x[order],
        local_y=segs.local_y[order],
        double_area=segs.double_area[order],
        cover=segs.cover[order],
    )
