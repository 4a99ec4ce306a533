"""Stage 4: sorted pixel segments to painted tiles.

Mirrors `Painter::paint_tile_row` + `LayerWorkbench::drive_tile_painting`
(`forma/src/cpu/painter/`): tile rows are independent; within a row, tiles are
processed left to right carrying per-layer accumulated covers; within a tile,
layers paint in ascending order with per-layer cover integration, fill-rule
coverage, fill evaluation, clipping and blending in linear space.

The optimizer passes (`layer_workbench/passes/`) are pure fail-fast
optimizations and are skipped here; the output is identical.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _f64(v):
    return np.asarray(v, np.float64)

from .. import consts
from ..styling import FillRule, Func
from . import fills
from .raster import PixelSegments

TW = consts.TILE_WIDTH
TH = consts.TILE_HEIGHT


def _coverage(da: np.ndarray, fill_rule: FillRule) -> np.ndarray:
    """doubled area (i32) -> coverage f32 (`painter/mod.rs:76-94`)."""
    pda = consts.PIXEL_DOUBLE_AREA
    recip = np.float32(1.0 / pda)
    if fill_rule == FillRule.NonZero:
        return np.clip(np.abs(da.astype(np.float32) * recip), 0.0, 1.0).astype(
            np.float32
        )
    folded = pda - np.abs((da & (2 * pda - 1)) - pda)
    return (folded.astype(np.float32) * recip).astype(np.float32)


def _cover_is_empty(cover: np.ndarray, fill_rule: FillRule) -> bool:
    if fill_rule == FillRule.NonZero:
        return bool(np.all(cover == 0))
    return bool(np.all((np.abs(cover) & 31) == 0))


def paint(
    segs: PixelSegments,
    props_of,
    width: int,
    height: int,
    clear_color,
    crop=None,
) -> np.ndarray:
    """Paints sorted pixel segments; returns linear-space f32 [H, W, 4].

    props_of(layer_id) -> Props.  crop is an optional Rect (tile-aligned).
    """
    tiles_x = -(-width // TW)
    rows = -(-height // TH)

    out = np.zeros((rows * TH, tiles_x * TW, 4), dtype=np.float32)
    cc = np.asarray(clear_color.to_array(), dtype=np.float32)
    out[:] = cc

    tile_y = segs.tile_y
    hor = vert = None
    if crop is not None:
        # Rect (tile ranges) or a bare (hor, vert) tuple of tile ranges.
        hor = getattr(crop, "hor", None)
        vert = getattr(crop, "vert", None)
        if hor is None:
            hor, vert = crop

    for row in range(rows):
        if vert is not None and not (vert.start <= row < vert.stop):
            continue
        lo = np.searchsorted(tile_y, row, side="left")
        hi = np.searchsorted(tile_y, row, side="right")
        _paint_row(segs, lo, hi, row, tiles_x, props_of, out, cc, hor)

    return out[:height, :width]


def _paint_row(segs, lo, hi, row, tiles_x, props_of, out, clear, hor):
    tile_x_start = hor.start if hor is not None else 0

    txs = segs.tile_x[lo:hi]
    layers = segs.layer[lo:hi]
    lxs = segs.local_x[lo:hi].astype(np.int64)
    lys = segs.local_y[lo:hi].astype(np.int64)
    das = segs.double_area[lo:hi]
    cvs = segs.cover[lo:hi]

    # Cover carries for everything left of the first painted tile
    # (`painter/mod.rs:500-516`).
    queue: Dict[int, np.ndarray] = {}
    left = txs < tile_x_start
    if left.any():
        for layer in np.unique(layers[left]):
            m = left & (layers == layer)
            cov = np.zeros(TH, np.int32)
            np.add.at(cov, lys[m], cvs[m])
            queue[int(layer)] = cov

    for tx in range(tile_x_start, tiles_x):
        if hor is not None and not (hor.start <= tx < hor.stop):
            continue
        in_tile = txs == tx
        tile_layers = sorted(set(int(l) for l in layers[in_tile]) | set(queue.keys()))

        # Per-tile painter state.
        dst = [
            np.full((TW, TH), clear[ch], dtype=np.float32) for ch in range(4)
        ]  # [x, y]
        clip_mask: Optional[np.ndarray] = None
        clip_last = -1

        next_queue: Dict[int, np.ndarray] = {}
        for layer in tile_layers:
            props = props_of(layer)
            m = in_tile & (layers == layer)

            areas = np.zeros((TW, TH), np.int32)
            covers = np.zeros((TW + 1, TH), np.int32)
            np.add.at(areas, (lxs[m], lys[m]), das[m])
            np.add.at(covers, (lxs[m] + 1, lys[m]), cvs[m])
            carry = queue.get(layer)
            if carry is not None:
                covers[0] += carry

            acc = np.cumsum(covers[:-1], axis=0)  # carry + covers left of px
            da = consts.PIXEL_DOUBLE_WIDTH * acc + areas
            coverage = _coverage(da, props.fill_rule)

            # Clip expiry (`painter/mod.rs:302-306`).
            if clip_mask is not None and clip_last < layer:
                clip_mask = None
                clip_last = -1

            if props.func.kind == Func.CLIP:
                if clip_mask is None:
                    clip_last = layer + props.func.clip
                clip_mask = coverage
            else:
                style = props.func.style
                draw = True
                if style.is_clipped and clip_mask is None:
                    draw = False  # painter/mod.rs:321-323
                if draw:
                    px = (
                        np.arange(TW, dtype=np.float32)[:, None]
                        + np.float32(tx * TW)
                    ) * np.ones((1, TH), np.float32)
                    py = np.arange(TH, dtype=np.float32)[None, :] + np.float32(
                        row * TH
                    ) * np.ones((TW, 1), np.float32)
                    fill = fills.fill_at(style.fill, px, py)
                    src_a = fill[3] * coverage
                    if style.is_clipped:
                        src_a = src_a * clip_mask
                    blended = fills.blend_function(
                        style.blend_mode, dst[0], dst[1], dst[2], fill[0], fill[1], fill[2]
                    )
                    dst = fills.composite(dst, fill, src_a, blended)

            total = covers.sum(axis=0, dtype=np.int32)
            if not _cover_is_empty(total, props.fill_rule):
                next_queue[layer] = total

        queue = next_queue

        # Write tile ([x, y] -> [y, x]).
        y0 = row * TH
        x0 = tx * TW
        for ch in range(4):
            out[y0 : y0 + TH, x0 : x0 + TW, ch] = dst[ch].T
