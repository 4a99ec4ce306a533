"""Sorted pixel segments to painted tiles, and the sRGB pack, in the plain
reference.

A frozen copy of the renderer's numpy oracle (forma's
`cpu/painter/mod.rs`): tile rows are independent; within a row, tiles go
left to right carrying each layer's accumulated cover; within a tile,
layers paint bottom to top: cover integration, the fill rule's coverage,
the fill, and the compositing equation in linear f32.  Only what the
benchmark's scenes use is here: solid fills and the Over blend mode.

`lowp`, when given, is a function that rounds an f32 array to a lower
precision: the coverage, the fill and the accumulated colour are then
held in it between operations, as a paint stage that keeps them in that
type would.  It builds the comparison's control.
"""

from __future__ import annotations

import numpy as np

TILE = 16
PIXEL_DOUBLE_WIDTH = 32
PIXEL_DOUBLE_AREA = 512


def _f64(v):
    return np.asarray(v, np.float64)


def _fma(a, b, c):
    return (_f64(a) * _f64(b) + _f64(c)).astype(np.float32)


def _coverage(da, even_odd: bool):
    recip = np.float32(1.0 / PIXEL_DOUBLE_AREA)
    if not even_odd:
        return np.clip(np.abs(da.astype(np.float32) * recip), 0.0, 1.0).astype(np.float32)
    folded = PIXEL_DOUBLE_AREA - np.abs((da & (2 * PIXEL_DOUBLE_AREA - 1)) - PIXEL_DOUBLE_AREA)
    return (folded.astype(np.float32) * recip).astype(np.float32)


def _composite(dst, src, src_a):
    """Over (`painter/mod.rs:406-447`), dst and src [r, g, b, a]."""
    one = np.float32(1.0)
    inv_dst_a_src_a = (one - dst[3]) * src_a
    inv_src_a = one - src_a
    dst_a_src_a = dst[3] * src_a
    out = [_fma(dst[ch], inv_src_a, _fma(src[ch], inv_dst_a_src_a, src[ch] * dst_a_src_a))
           for ch in range(3)]
    out.append(_fma(dst[3], inv_src_a, src_a))
    return out


def paint_rows(segs, colors, even_odd, width, rows, clear, lowp=None):
    """Linear f32 [len(rows) * 16, tiles * 16, 4]: the tile rows `rows` of
    the frame, painted from sorted segments `segs` (`raster.Segments`);
    `colors` f32 [L, 4] and `even_odd` bool [L] by layer id."""
    keep = lowp or (lambda v: v)
    tiles_x = -(-width // TILE)
    out = np.empty((len(rows) * TILE, tiles_x * TILE, 4), np.float32)
    clear = np.asarray(clear, np.float32)
    for n, row in enumerate(rows):
        lo = np.searchsorted(segs.tile_y, row, side="left")
        hi = np.searchsorted(segs.tile_y, row, side="right")
        _paint_row(segs, lo, hi, tiles_x, colors, even_odd, clear, keep,
                   out[n * TILE:(n + 1) * TILE])
    return out


def _paint_row(segs, lo, hi, tiles_x, colors, even_odd, clear, keep, out):
    """One tile row.  Each (tile, layer) pair that has segments in the tile,
    or a cover carried into it from the left, paints in layer order; the
    pairs of one rank in their tiles paint together, across tiles.

    A layer's carry into a tile is the sum of its covers in every tile to
    the left (tile -1 holds what lies left of the viewport): the painter's
    queue, which drops a layer whose running sum is empty, carries the
    same coverage, since an empty carry adds nothing (nonzero) or a
    multiple of the even-odd period.  A layer painted at zero coverage
    leaves the tile's pixels exactly as they were."""
    tx = segs.tile_x[lo:hi].astype(np.int64)
    m = tx < tiles_x  # segments right of the frame carry nothing leftwards
    tx = tx[m]
    layer = segs.layer[lo:hi][m].astype(np.int64)
    cell = segs.local_x[lo:hi][m].astype(np.int64) * TILE + segs.local_y[lo:hi][m]
    da = segs.double_area[lo:hi][m].astype(np.int64)
    cv = segs.cover[lo:hi][m].astype(np.int64)
    ly = cell % TILE

    dst = np.empty((tiles_x, 4, TILE, TILE), np.float32)  # [tile, channel, x, y]
    dst[:] = clear[None, :, None, None]
    if len(layer):
        ids, j = np.unique(layer, return_inverse=True)
        nl, cols = len(ids), tiles_x + 1  # column 0 is tile -1
        col = tx + 1
        pair = j * cols + col
        cover_rows = np.bincount(pair * TILE + ly, cv, nl * cols * TILE)
        cover_rows = np.rint(cover_rows).astype(np.int64).reshape(nl, cols, TILE)
        carry = np.cumsum(cover_rows, axis=1) - cover_rows  # into each column
        eo = np.asarray(even_odd, bool)[ids]
        live = np.where(eo[:, None], ((np.abs(carry) & 31) != 0).any(axis=2),
                        (carry != 0).any(axis=2))
        live |= np.bincount(pair, minlength=nl * cols).reshape(nl, cols) > 0
        live[:, 0] = False
        pj, pc = np.nonzero(live.T)[::-1]  # by column, then layer: paint order
        index = np.full(nl * cols, -1, np.int64)
        index[pj * cols + pc] = np.arange(len(pj))
        inside = col > 0  # tile -1 only carries
        at = index[pair[inside]] * (TILE * TILE) + cell[inside]
        n = len(pj) * TILE * TILE
        areas = np.bincount(at, da[inside], n)
        covers = np.bincount(at, cv[inside], n)
        areas, covers = (np.rint(v).astype(np.int64).reshape(-1, TILE, TILE)
                         for v in (areas, covers))
        acc = carry[pj, pc][:, None, :] + np.cumsum(covers, axis=1) - covers
        da_px = PIXEL_DOUBLE_WIDTH * acc + areas
        coverage = np.empty(da_px.shape, np.float32)
        for flag in (False, True):
            sel = eo[pj] == flag
            if sel.any():
                coverage[sel] = _coverage(da_px[sel], flag)
        coverage = keep(coverage)
        lid = ids[pj]
        tile = pc - 1
        first = np.r_[True, pc[1:] != pc[:-1]]
        start = np.maximum.accumulate(np.where(first, np.arange(len(pc)), 0))
        rank = np.arange(len(pc)) - start
        for k in range(int(rank.max()) + 1 if len(rank) else 0):
            sel = np.flatnonzero(rank == k)
            t = tile[sel]
            fill = [keep(colors[lid[sel], ch].astype(np.float32))[:, None, None]
                    for ch in range(4)]
            src_a = keep(fill[3] * coverage[sel])
            new = _composite([dst[t, ch] for ch in range(4)], fill, src_a)
            for ch in range(4):
                dst[t, ch] = keep(new[ch])
    for ch in range(4):
        out[:, :, ch] = dst[:, ch].transpose(2, 0, 1).reshape(TILE, tiles_x * TILE)


def linear_to_srgb(v):
    a, b = np.float32(0.201_017_72), np.float32(-0.512_801_47)
    c, d = np.float32(1.344_401), np.float32(-0.030_656_587)
    s = np.sqrt(v).astype(np.float32)
    n = _fma(a, (v * s).astype(np.float32), _fma(b, v, _fma(c, s, d)))
    return np.where(v <= np.float32(0.003_130_8), v * np.float32(12.92), n)


def pack_srgb(linear):
    """Linear f32 [..., 4] RGBA -> sRGB u8 RGBA, ties to even."""
    chans = [linear_to_srgb(linear[..., ch]) for ch in range(3)] + [linear[..., 3]]
    return np.stack([np.rint(np.clip(v * np.float32(255.0), 0.0, 255.0)).astype(np.uint8)
                     for v in chans], axis=-1)


def round_bf16(v):
    """f32 -> the nearest bfloat16 (ties to even), returned as f32."""
    f = np.asarray(v, np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).reshape(f.shape)
