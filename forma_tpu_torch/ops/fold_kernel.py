"""K3: the per-tile paint fold.

Counterpart of `forma_tpu/ops/paint_pallas.py:90-174,177-483`
(`style_layout`, `_gradient_fill`, `paint_fold_pallas`) and of its prep in
`forma_tpu/ops/paint.py:144-305` (`_paint_fold_pallas`), widened with the
texture fills that the JAX package paints on its XLA wave fold
(`paint.py:393-412,969-981`).  Every tile folds its (tile, layer)-sorted
paint units bottom to top:

    coverage = carry + exclusive cover prefix along the pixel row + area,
               under the nonzero or even-odd rule;
    clip state: a clip unit's coverage becomes the tile's clip mask, and
               the clip range it opens expires past its last layer;
    fill = the solid colour, a linear/radial gradient or an atlas texel,
           evaluated at the pixel's integer global coordinates;
    src_a = fill alpha * coverage (* clip mask for clipped draws);
    the unit's blend mode (one of 16) mixes fill with dst, then Over.

Units come from the per-run tables directly, with no unit matrix
gathered: the grid row in run order, addressed by `src_u`; carry_in,
carry_after, the run's tile x and the style row in carry-chain order,
addressed by `src2_u`.  After the packed-key sort the two orders are one
and `src_u == src2_u` (the JAX package's table mode, `paint.py:161-172`;
callers then pass the same tensor twice, and the kernel loads one index);
after the two-key sort they differ (its assembly mode, `paint.py:245-
272`).  A unit is virtual (a gap tile its layer covers without segments)
exactly when its run's tile x differs from the unit's own tile x, since
a virtual unit's owner run lies in an earlier tile of the same row and
layer; JAX reads `virt_u & FLAG_VIRTUAL`, which agrees.  Virtual units
take no grid and the run's carry_after; real units take carry_in.  Clip
frames also read each unit's FLAG_UNCLIPPED bit from `virt_u` (the JAX
package bakes it into an assembled unit matrix instead,
`paint.py:260-270`).

The CUDA kernel (`csrc/fold.cu`) runs one block per tile and two pixels
per thread (the styled, textured and clip folds deepest tiles first:
`tile_order`), with each chunk of a tile's units staged in shared
memory, in four specialisations: solid/Over (none of the fill, blend or
clip code), styled (gradients and blend modes), textured (texture fills,
with gradients and blend modes) and clip (all of it, textures included);
the plain version advances all tiles one unit per step.  Both use the
JAX expression trees op for op, so their f32 results are bit-equal.
Launches count per specialisation: "fold" (solid fills, Over),
"fold_styled" (gradients or blend modes), "fold_tex" (texture fills, no
clips), "fold_clip" (any frame with clips).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import consts

from . import _build
from ._u32 import bits_f32
from .grid_kernel import unpack_grid
from .rasterize import TX_BITS

# Blocks of csrc/fold.cu resident on one SM, at the least (128 threads, at
# most 48 registers): a frame of at most this many tiles per SM starts
# every tile at once, so its fold needs no tile order.
FOLD_BLOCKS_PER_SM = 10

TH = consts.TILE_HEIGHT
TW = consts.TILE_WIDTH
_PDA = consts.PIXEL_DOUBLE_AREA  # 512
_PDW = consts.PIXEL_DOUBLE_WIDTH  # 32
_RECIP = 1.0 / _PDA  # exact in f32
FLAG_UNCLIPPED = 32  # virt_u bit: the draw's governing full clip was dropped


class StyleLayout(NamedTuple):
    """Lane offsets of the per-run style row (i32; f32 payloads as bits);
    -1 marks a lane group the frame's features do not need."""

    fill: int
    fr: int
    blend: int
    ft: int
    func: int
    layer: int
    cend: int
    clipped: int
    grad: int
    stops: int
    tex: int
    width: int


def style_layout(features, ms: int) -> StyleLayout:
    """The feature-dependent style-row layout (`paint_pallas.py:104-123`):
    fill 4 | fill rule 1 | [blend 1] | [fill type 1] | [func, layer id,
    clip range end, clipped: 4] | [gradient 6 | stops 5 * ms] | [texture
    10].  The texture group is the port's own, appended last, so every
    texture-free layout is JAX's; the fill-type lane is present for
    gradients or textures."""
    off = 0
    fill, off = off, off + 4
    fr, off = off, off + 1
    blend = ft = func = layer = cend = clipped = grad = stops = tex = -1
    if tuple(features.blend_modes) != (0,):
        blend, off = off, off + 1
    if features.has_gradient or features.has_texture:
        ft, off = off, off + 1
    if features.has_clip:
        func, off = off, off + 1
        layer, off = off, off + 1
        cend, off = off, off + 1
        clipped, off = off, off + 1
    if features.has_gradient:
        grad, off = off, off + 6
        stops, off = off, off + 5 * ms
    if features.has_texture:
        tex, off = off, off + 10
    return StyleLayout(
        fill, fr, blend, ft, func, layer, cend, clipped, grad, stops, tex, off
    )


def variant(features) -> str:
    """The CUDA specialisation (and launch counter) a frame's features
    select."""
    if features.has_clip:
        return "fold_clip"
    if features.has_texture:
        return "fold_tex"
    if features.has_gradient or tuple(features.blend_modes) != (0,):
        return "fold_styled"
    return "fold"


@functools.lru_cache(maxsize=None)
def _launch_layout(features, ms: int):
    """(launch counter, style layout, the C entry's layout array: lane
    offsets, row width, stop count, texture offset), once per (features,
    ms)."""
    lay = style_layout(features, ms)
    return variant(features), lay, (ctypes.c_int32 * 12)(
        *lay[1:10], lay.width, ms, lay.tex)


def tile_spans(key_u, u_valid, rows: int, tiles_x: int, k_slots: int, skip=None):
    """Per-tile unit spans of the (tile, layer)-sorted units: (ust i32 [T]
    first unit, cnt i32 [T] unit count clamped to k_slots).  Unit tiles
    are nondecreasing (invalid units sort last), so each span is a pair of
    binary searches.  `skip` (bool [T], optional) marks tiles that fold no
    units, those the damage cache or a crop leaves out: their count is 0,
    and the fold leaves them at the clear colour
    (`forma_tpu/ops/paint.py:221-228`)."""
    n_tiles = rows * tiles_x
    rowb = (key_u >> TX_BITS) - 1
    txu = (key_u & ((1 << TX_BITS) - 1)) - 1
    tile_of = torch.where(u_valid, rowb * tiles_x + txu, n_tiles)
    t = torch.arange(n_tiles, dtype=tile_of.dtype, device=key_u.device)
    ust = torch.searchsorted(tile_of, t)
    end = torch.searchsorted(tile_of, t, right=True)
    cnt = torch.clamp(end - ust, max=k_slots)
    if skip is not None:
        cnt = torch.where(skip, 0, cnt)
    return ust.to(torch.int32), cnt.to(torch.int32)


def tile_order(cnt):
    """The order in which the CUDA fold's blocks take the tiles (styled,
    textured and clip folds): by descending unit count, ties by tile
    index; i32 [T], a permutation of 0 .. T - 1, computed on cnt's device
    with no host sync.  Tile depths are skewed and the deepest tiles lie
    in the frame's last tile rows, so in index order they would start last
    and leave the card idle behind them."""
    return torch.argsort(cnt, descending=True, stable=True).to(torch.int32)


def paint_fold(ust, cnt, src_u, src2_u, virt_u, grid, carry_in_s, carry_after_s,
               tx_s, style_s, clear, tiles_x: int, features, ms: int, atlas=None,
               row_lo: int = 0):
    """Folds every tile's units; returns linear f32 [T, 4 * 256]
    (channel-major blocks of 256 pixels, pixel j = (y = j // 16, x = j % 16),
    at global pixel (16 * (t % tiles_x) + x, 16 * (t // tiles_x + row_lo)
    + y): `row_lo` is the global tile row of the frame's first tile row, a
    row-span crop's first row; gradients and textures evaluate there).

    ust, cnt i32 [T]; src_u i32 [U] unit -> its grid row (run order);
    src2_u i32 [U] unit -> run in carry-chain order (the same tensor as
    src_u when the orders are one); virt_u i32 [U] unit flags (read for
    FLAG_UNCLIPPED by clip frames; None otherwise); grid i32 [R, 256];
    carry_in_s, carry_after_s, tx_s and style_s in carry-chain order:
    i32 [R, 16], [R, 16], [R] and [R, style_layout(features, ms).width];
    clear f32 [4];
    atlas f32 [AH, AW, 4], read by texture frames (None otherwise).
    CUDA tensors launch `forma_fold`; CPU tensors take `paint_fold_torch`.
    The styled, textured and clip folds take the tiles in `tile_order`
    unless they all fit the card at once; the solid fold takes them in
    index order: its unit step is cheap enough that the deep tiles' tail
    costs less than the sort (on the H100, PERF.md)."""
    if not grid.is_cuda:
        return paint_fold_torch(ust, cnt, src_u, src2_u, virt_u, grid, carry_in_s,
                                carry_after_s, tx_s, style_s, clear, tiles_x,
                                features, ms, atlas, row_lo)
    counter, lay, layout = _launch_layout(features, ms)
    T = ust.shape[0]
    R = grid.shape[0]
    U = src2_u.shape[0]
    _build.check(ust, "ust", torch.int32, (T,))
    _build.check(cnt, "cnt", torch.int32, (T,))
    _build.check(src_u, "src_u", torch.int32, (U,))
    _build.check(src2_u, "src2_u", torch.int32, (U,))
    if features.has_clip:
        _build.check(virt_u, "virt_u", torch.int32, (U,))
    _build.check(grid, "grid", torch.int32, (R, 256))
    _build.check_aligned(grid, "grid", 8)  # two pixels' words per load
    _build.check(carry_in_s, "carry_in_s", torch.int32, (R, 16))
    _build.check(carry_after_s, "carry_after_s", torch.int32, (R, 16))
    _build.check(tx_s, "tx_s", torch.int32, (R,))
    _build.check(style_s, "style_s", torch.int32, (R, lay.width))
    _build.check(clear, "clear", torch.float32, (4,))
    ah = aw = 0
    if features.has_texture:
        if atlas is None or atlas.dim() != 3:
            raise ValueError("paint_fold: a texture frame needs atlas f32 [AH, AW, 4]")
        ah, aw = atlas.shape[:2]
        _build.check(atlas, "atlas", torch.float32, (ah, aw, 4))
        _build.check_aligned(atlas, "atlas", 16)  # one float4 load per texel
    if U < 1 or R < 1:
        raise ValueError("paint_fold: empty unit or run table")
    out = torch.empty((T, 4 * 256), dtype=torch.float32, device=grid.device)
    if T:
        sms = torch.cuda.get_device_properties(grid.device).multi_processor_count
        deep_first = counter != "fold" and T > sms * FOLD_BLOCKS_PER_SM
        order = tile_order(cnt) if deep_first else None
        _build.launch(
            "forma_fold", counter, None if order is None else order.data_ptr(),
            ust.data_ptr(), cnt.data_ptr(), src_u.data_ptr(), src2_u.data_ptr(),
            virt_u.data_ptr() if features.has_clip else None, grid.data_ptr(),
            carry_in_s.data_ptr(), carry_after_s.data_ptr(), tx_s.data_ptr(),
            style_s.data_ptr(), clear.data_ptr(), layout, T, tiles_x, R, U,
            out.data_ptr(), atlas.data_ptr() if features.has_texture else None,
            ah, aw, row_lo,
        )
    return out


def paint_fold_torch(ust, cnt, src_u, src2_u, virt_u, grid, carry_in_s,
                     carry_after_s, tx_s, style_s, clear, tiles_x: int, features,
                     ms: int, atlas=None, row_lo: int = 0):
    """Plain PyTorch version of `paint_fold`: a loop over k that advances
    every tile by one unit, with the Pallas kernel's expression trees
    (`paint_pallas.py:327-415`) and the wave fold's texture select
    (`paint.py:977-981`).  A step past a tile's count leaves its pixels
    and clip state as they were."""
    # paint imports this module, so its fill and blend trees load here.
    from .paint import _blend, _gradient_at, _texture_at

    lay = style_layout(features, ms)
    has_grad, has_clip = features.has_gradient, features.has_clip
    has_tex = features.has_texture
    dev = grid.device
    T = ust.shape[0]
    R = grid.shape[0]
    U = src2_u.shape[0]
    f32 = torch.float32
    dst = [clear[ch].to(f32).expand(T, 256).clone() for ch in range(4)]
    tile = torch.arange(T, device=dev)
    ttx = tile % tiles_x
    if has_grad or has_tex:
        j = torch.arange(256, device=dev)
        xg = (ttx[:, None] * TW + j % TW).to(f32)
        yg = ((tile // tiles_x + row_lo)[:, None] * TH + j // TW).to(f32)
    if has_clip:
        clipm = torch.zeros((T, 256), dtype=f32, device=dev)
        clip_last = torch.full((T, 1), -1, dtype=torch.int32, device=dev)
    kmax = int(cnt.max()) if T else 0
    for k in range(kmax):
        present = (cnt > k)[:, None]  # [T, 1]
        u = torch.clamp(ust.long() + k, max=U - 1)
        r = torch.clamp(src2_u[u].long(), 0, R - 1)
        g = torch.clamp(src_u[u].long(), 0, R - 1)
        st = style_s[r]  # [T, W]
        virt = (tx_s[r].long() != ttx)[:, None]  # [T, 1]
        area, cover = unpack_grid(grid[g])  # [T, 256] each
        c16 = torch.where(virt, carry_after_s[r], carry_in_s[r])
        cover = torch.where(virt, 0, cover)
        area = torch.where(virt, 0, area)
        cov3 = cover.reshape(T, 16, 16)
        excl = torch.cumsum(cov3, dim=2) - cov3
        ce_exc = (c16[:, :, None] + excl).reshape(T, 256)

        da = _PDW * ce_exc + area
        fr_eo = (st[:, lay.fr] != 0)[:, None]
        nz = torch.clamp(torch.abs(da.to(f32) * _RECIP), 0.0, 1.0)
        folded = _PDA - torch.abs((da & (2 * _PDA - 1)) - _PDA)
        eo = folded.to(f32) * _RECIP
        cov = torch.where(fr_eo, eo, nz)
        cov = cov * present.to(f32)

        if has_clip:
            func = st[:, lay.func, None]
            draw = present & (func == 0)
            layer = st[:, lay.layer, None]
            cend = st[:, lay.cend, None]
            is_clip_unit = present & (func == 1)
            # Clip expiry precedes everything (`painter/mod.rs:302-306`).
            expired = (clip_last >= 0) & (clip_last < layer) & present
            clip_last = torch.where(expired, -1, clip_last)
            new_clip = is_clip_unit & (clip_last < 0)
            clip_last = torch.where(new_clip, cend, clip_last)
            clipm = torch.where(is_clip_unit, cov, clipm)

        fill = [bits_f32(st[:, lay.fill + ch, None]) for ch in range(4)]  # [T, 1]
        if has_grad:
            gm = bits_f32(st[:, lay.grad : lay.grad + 6])
            stops = bits_f32(st[:, lay.stops : lay.stops + 5 * ms]).reshape(T, ms, 5)
            gf = _gradient_at(gm, stops, xg, yg)
            selg = st[:, lay.ft, None] == 1
            fill = [torch.where(selg, g, f) for g, f in zip(gf, fill)]
        if has_tex:
            tf = _texture_at(bits_f32(st[:, lay.tex : lay.tex + 10]), atlas, xg, yg)
            selt = st[:, lay.ft, None] == 2
            fill = [torch.where(selt, t, f) for t, f in zip(tf, fill)]

        src_a = fill[3] * cov
        if has_clip:
            # FLAG_UNCLIPPED: the draw's governing full clip was dropped.
            unclip = (virt_u[u] & FLAG_UNCLIPPED) != 0
            clipped = (st[:, lay.clipped] == 1) & ~unclip
            active = clip_last >= 0
            src_a = torch.where(
                clipped[:, None], torch.where(active, src_a * clipm, 0.0), src_a
            )
            src_a = src_a * draw.to(f32)

        blended = fill[:3]
        if lay.blend >= 0:
            blended = _blend(st[:, lay.blend, None], features.blend_modes,
                             dst[0], dst[1], dst[2], fill[0], fill[1], fill[2])

        dst_a = dst[3]
        inv_dst_a = 1.0 - dst_a
        inv_dst_a_src_a = inv_dst_a * src_a
        inv_src_a = 1.0 - src_a
        dst_a_src_a = dst_a * src_a
        new = [
            dst[ch] * inv_src_a + (fill[ch] * inv_dst_a_src_a + blended[ch] * dst_a_src_a)
            for ch in range(3)
        ] + [dst_a * inv_src_a + src_a]
        dst = [torch.where(present, n, d) for n, d in zip(new, dst)]
    return torch.cat(dst, dim=1)


def fold_tiles(key_u, u_valid, src_u, src2_u, virt_u, grid, carry_in_s,
               carry_after_s, tx_s, style_s, clear, rows: int, tiles_x: int,
               k_slots: int, features, ms: int, atlas=None, plain: bool = False,
               taps=None, row_lo: int = 0, tile_skip=None):
    """Prep + fold; returns the frame's tiles as linear f32 [T, TH, TW, 4]
    (the counterpart of `paint._paint_fold_pallas`, in table mode when
    `src_u is src2_u`, in assembly mode otherwise).  `atlas` is read by
    texture frames only.  `row_lo` is the global tile row of tile row 0;
    `tile_skip` (bool [T]) marks the tiles that fold nothing and stay at
    the clear colour (the damage cache's unchanged tiles, a crop's
    outside).  `plain` runs K3's plain PyTorch version on any device;
    `taps` (a dict) receives K3's inputs under "fold", `row_lo` last."""
    ust, cnt = tile_spans(key_u, u_valid, rows, tiles_x, k_slots, tile_skip)
    src2 = src2_u.to(torch.int32).contiguous()
    src = src2 if src_u is src2_u else src_u.to(torch.int32).contiguous()
    args = (
        ust, cnt, src, src2,
        virt_u.to(torch.int32).contiguous() if features.has_clip else None,
        grid.contiguous(), carry_in_s.contiguous(), carry_after_s.contiguous(),
        tx_s.contiguous(), style_s.contiguous(), clear.contiguous(), tiles_x,
        features, ms, atlas.contiguous() if features.has_texture else None, row_lo,
    )
    if taps is not None:
        taps["fold"] = args
    out = (paint_fold_torch if plain else paint_fold)(*args)
    n_tiles = rows * tiles_x
    return out.reshape(n_tiles, 4, TH, TW).permute(0, 2, 3, 1)
