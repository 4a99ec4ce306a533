"""K3: the per-tile paint fold (table mode, solid fills, Over blending).

Counterpart of `forma_tpu/ops/paint_pallas.py:90-123,177-483`
(`style_layout`, `paint_fold_pallas` with `table_mode=True`) and of its
prep in `forma_tpu/ops/paint.py:144-305` (`_paint_fold_pallas`).  Every
tile folds its (tile, layer)-sorted paint units bottom to top:

    coverage = carry + exclusive cover prefix along the pixel row + area,
               under the nonzero or even-odd rule,
    then a solid fill, Over-blended into linear f32 RGBA.

Units come from the per-run tables directly (grid row, carry_in,
carry_after, run tile x, style row), addressed by `src2_u`.  A unit is
virtual (a gap tile its layer covers without segments) exactly when its
run's tile x differs from the unit's own tile x: virtual units take no
grid and the run's carry_after; real units take carry_in.

The CUDA kernel (`csrc/fold.cu`) runs one block per tile and one thread
per pixel; the plain version advances all tiles one unit per step.  Both
use the expression tree of `paint_pallas.py:327-336,404-415` op for op, so
their f32 results are bit-equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from forma_tpu import consts

from . import _build
from ._u32 import bits_f32
from .grid_kernel import unpack_grid
from .rasterize import TX_BITS

TH = consts.TILE_HEIGHT
TW = consts.TILE_WIDTH
_PDA = consts.PIXEL_DOUBLE_AREA  # 512
_PDW = consts.PIXEL_DOUBLE_WIDTH  # 32
_RECIP = 1.0 / _PDA  # exact in f32


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
    width: int


def style_layout(features, ms: int) -> StyleLayout:
    """The feature-dependent style-row layout (`paint_pallas.py:104-123`)."""
    off = 0
    fill, off = off, off + 4
    fr, off = off, off + 1
    blend = ft = func = layer = cend = clipped = grad = stops = -1
    if tuple(features.blend_modes) != (0,):
        blend, off = off, off + 1
    if features.has_gradient:
        ft, off = off, off + 1
    if features.has_clip:
        func, off = off, off + 1
        layer, off = off, off + 1
        cend, off = off, off + 1
        clipped, off = off, off + 1
    if features.has_gradient:
        grad, off = off, off + 6
        stops, off = off, off + 5 * ms
    return StyleLayout(
        fill, fr, blend, ft, func, layer, cend, clipped, grad, stops, off
    )


SOLID_WIDTH = 5  # style row of a solid/Over frame: rgba bits + fill rule


def tile_spans(key_u, u_valid, rows: int, tiles_x: int, k_slots: int):
    """Per-tile unit spans of the (tile, layer)-sorted units: (ust i32 [T]
    first unit, cnt i32 [T] unit count clamped to k_slots).  Unit tiles
    are nondecreasing (invalid units sort last), so each span is a pair of
    binary searches."""
    n_tiles = rows * tiles_x
    rowb = (key_u >> TX_BITS) - 1
    txu = (key_u & ((1 << TX_BITS) - 1)) - 1
    tile_of = torch.where(u_valid, rowb * tiles_x + txu, n_tiles)
    t = torch.arange(n_tiles, dtype=tile_of.dtype, device=key_u.device)
    ust = torch.searchsorted(tile_of, t)
    end = torch.searchsorted(tile_of, t, right=True)
    cnt = torch.clamp(end - ust, max=k_slots)
    return ust.to(torch.int32), cnt.to(torch.int32)


def paint_fold(ust, cnt, src2_u, grid, carry_in_s, carry_after_s, tx_s,
               style_s, clear, tiles_x: int):
    """Folds every tile's units; returns linear f32 [T, 4 * 256]
    (channel-major blocks of 256 pixels, pixel j = (y = j // 16, x = j % 16)).

    ust, cnt i32 [T]; src2_u i32 [U] unit -> run; grid i32 [R, 256];
    carry_in_s, carry_after_s i32 [R, 16]; tx_s i32 [R]; style_s i32
    [R, 5]; clear f32 [4].  CUDA tensors launch `forma_fold`; CPU tensors
    take `paint_fold_torch`."""
    if not grid.is_cuda:
        return paint_fold_torch(ust, cnt, src2_u, grid, carry_in_s,
                                carry_after_s, tx_s, style_s, clear, tiles_x)
    T = ust.shape[0]
    R = grid.shape[0]
    U = src2_u.shape[0]
    _build.check(ust, "ust", torch.int32, (T,))
    _build.check(cnt, "cnt", torch.int32, (T,))
    _build.check(src2_u, "src2_u", torch.int32, (U,))
    _build.check(grid, "grid", torch.int32, (R, 256))
    _build.check(carry_in_s, "carry_in_s", torch.int32, (R, 16))
    _build.check(carry_after_s, "carry_after_s", torch.int32, (R, 16))
    _build.check(tx_s, "tx_s", torch.int32, (R,))
    _build.check(style_s, "style_s", torch.int32, (R, SOLID_WIDTH))
    _build.check(clear, "clear", torch.float32, (4,))
    if U < 1 or R < 1:
        raise ValueError("paint_fold: empty unit or run table")
    out = torch.empty((T, 4 * 256), dtype=torch.float32, device=grid.device)
    if T:
        _build.launch(
            "forma_fold", "fold",
            ust.data_ptr(), cnt.data_ptr(), src2_u.data_ptr(), grid.data_ptr(),
            carry_in_s.data_ptr(), carry_after_s.data_ptr(), tx_s.data_ptr(),
            style_s.data_ptr(), clear.data_ptr(), T, tiles_x, R, U,
            out.data_ptr(),
        )
    return out


def paint_fold_torch(ust, cnt, src2_u, grid, carry_in_s, carry_after_s, tx_s,
                     style_s, clear, tiles_x: int):
    """Plain PyTorch version of `paint_fold`: a loop over k that advances
    every tile by one unit, with the Pallas kernel's expression tree.
    Steps past a tile's count multiply coverage by 0, which leaves the
    pixels bit-identical."""
    dev = grid.device
    T = ust.shape[0]
    R = grid.shape[0]
    U = src2_u.shape[0]
    dst = clear.to(torch.float32)[None, :, None].repeat(T, 1, 256)  # [T, 4, 256]
    ttx = torch.arange(T, device=dev) % tiles_x
    kmax = int(cnt.max()) if T else 0
    for k in range(kmax):
        present = (cnt > k).to(torch.float32)[:, None]  # [T, 1]
        u = torch.clamp(ust.long() + k, max=U - 1)
        r = torch.clamp(src2_u[u].long(), 0, R - 1)
        virt = (tx_s[r].long() != ttx)[:, None]  # [T, 1]
        area, cover = unpack_grid(grid[r])  # [T, 256] each
        c16 = torch.where(virt, carry_after_s[r], carry_in_s[r])
        cover = torch.where(virt, 0, cover)
        area = torch.where(virt, 0, area)
        cov3 = cover.reshape(T, 16, 16)
        excl = torch.cumsum(cov3, dim=2) - cov3
        ce_exc = (c16[:, :, None] + excl).reshape(T, 256)

        da = _PDW * ce_exc + area
        fr_eo = (style_s[r, 4] != 0)[:, None]
        nz = torch.clamp(torch.abs(da.to(torch.float32) * _RECIP), 0.0, 1.0)
        folded = _PDA - torch.abs((da & (2 * _PDA - 1)) - _PDA)
        eo = folded.to(torch.float32) * _RECIP
        cov = torch.where(fr_eo, eo, nz)
        cov = cov * present

        fill = bits_f32(style_s[r, 0:4])  # [T, 4]
        src_a = fill[:, 3:4] * cov
        dst_a = dst[:, 3]
        inv_dst_a = 1.0 - dst_a
        inv_dst_a_src_a = inv_dst_a * src_a
        inv_src_a = 1.0 - src_a
        dst_a_src_a = dst_a * src_a
        for ch in range(3):
            f = fill[:, ch : ch + 1]
            dst[:, ch] = dst[:, ch] * inv_src_a + (
                f * inv_dst_a_src_a + f * dst_a_src_a
            )
        dst[:, 3] = dst_a * inv_src_a + src_a
    return dst.reshape(T, 4 * 256)


def fold_tiles(key_u, u_valid, src2_u, grid, carry_in_s, carry_after_s, tx_s,
               style_s, clear, rows: int, tiles_x: int, k_slots: int,
               plain: bool = False, taps=None):
    """Table-mode prep + fold; returns the frame's tiles as linear f32
    [T, TH, TW, 4] (the counterpart of `paint._paint_fold_pallas` with
    `presorted=True`).  `plain` runs K3's plain PyTorch version on any
    device; `taps` (a dict) receives K3's inputs."""
    ust, cnt = tile_spans(key_u, u_valid, rows, tiles_x, k_slots)
    args = (
        ust, cnt, src2_u.to(torch.int32).contiguous(), grid.contiguous(),
        carry_in_s.contiguous(), carry_after_s.contiguous(),
        tx_s.contiguous(), style_s.contiguous(), clear.contiguous(), tiles_x,
    )
    if taps is not None:
        taps["fold"] = args
    out = (paint_fold_torch if plain else paint_fold)(*args)
    n_tiles = rows * tiles_x
    return out.reshape(n_tiles, 4, TH, TW).permute(0, 2, 3, 1)
