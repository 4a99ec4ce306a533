"""K4: virtual-line expansion fused with the packed pixel-segment emit.

Counterpart of `forma_tpu/ops/expand_pallas.py:201-380`
(`rasterize_blocks_pallas`): K1's expansion and `_emit_packed`
(`forma_tpu/ops/rasterize.py:77-213`) in one pass, so the expanded
[16, v_cap] params and the emit's temporaries never reach device memory.
The CUDA kernel (`csrc/rasterize.cu`) runs one thread per virtual line
(each warp finds its lines with one search, and each segment boundary's
crossing is found once); its plain version is `expand_params_torch`
followed by `_emit_packed`, which is also the emit of the split path
(`rasterize.rasterize_sort`).

The emit is the i-th-intersection math (`rasterizer.rs:22-76`) over
[k_seg, V] in float-float arithmetic (`ops/ff64.py`); pixel segments pack
as

    key     = ((tile_y + 1) << slot_bits | slot) << tx_bits | (tile_x + 1)
    payload = local_x << 21 | local_y << 17 | (area + 1024) << 6 | (cover + 16)

as the TPU kernel's u32 words, held in int32 tensors [k_seg, V] for the
segment sort (`rasterize.sort_segments`), which orders them as signed.
A valid key fits 31 bits (`check_key_budget`), so invalid slots carry the
sentinel `PACKED_SENTINEL` = 0x7FFFFFFF, which sorts after every valid key
(the u32 sentinel 0xFFFFFFFF would read as -1 and sort first), and the
zero payload.  A payload keeps its 32 bits: `_u32.wrap_i32` stores it,
`& MASK32` reads it back.
"""

from __future__ import annotations

import torch

from .. import consts
from . import _build, ff64
from ._u32 import MASK32, f2i32, wrap_i32
from .expand_kernel import expand_params_torch
from .line_setup import (
    N_PARAMS, PA, PAOH, PAOL, PB, PBOH, PBOL, PC, PCDH, PCDL, PD, PDX, PDY,
    PLEN, PSLOT, PX0, PY0,
)

ZERO_PAYLOAD = (1024 << 6) | 16  # area 0, cover 0
PACKED_SENTINEL = 0x7FFFFFFF  # invalid slot's key in the int32 words


def check_key_budget(rows: int, tiles_x: int, slot_bits: int, tx_bits: int) -> None:
    """Raises unless every valid [row | slot | tx] key fits 31 bits and
    stays below `PACKED_SENTINEL`: the row field (tile_y + 1 <= rows)
    within the bits `pipeline.slot_bits_for` counts, and the tx field
    (tile_x + 1 <= tiles_x) never all ones, as `tx_bits =
    bit_length(tiles_x + 1)` gives."""
    row_bits = (rows + 1).bit_length()
    if (slot_bits < 1 or tx_bits < 1 or row_bits + slot_bits + tx_bits > 31
            or tiles_x + 1 >= (1 << tx_bits)):
        raise ValueError(
            f"packed key: rows={rows} ({row_bits} bits), slot_bits={slot_bits}, "
            f"tx_bits={tx_bits} (tiles_x={tiles_x}) do not fit 31 bits below "
            "the sentinel"
        )


def _find(fi, a_over, b_over, cd_over, a, b, c, d):
    """i-th element of the merged progressions (`rasterizer.rs:32-61`)."""
    ja = torch.where(
        torch.isfinite(b),
        ff64.ceil(ff64.sub(ff64.mul(b_over, ff64.ff(fi)), cd_over)),
        fi,
    )
    jb = torch.where(
        torch.isfinite(a),
        ff64.ceil(ff64.add(ff64.mul(a_over, ff64.ff(fi)), cd_over)),
        fi,
    )
    guess_a = a * ja + c
    guess_b = b * jb + d
    # Rust f32::min returns the non-NaN operand.
    inf = torch.full_like(guess_a, float("inf"))
    guess_a = torch.where(torch.isnan(guess_a), inf, guess_a)
    guess_b = torch.where(torch.isnan(guess_b), inf, guess_b)
    return torch.minimum(guess_a, guess_b)


def _emit_core(col, j, v_live, k_seg: int, rows: int, tiles_x: int, row_lo):
    """Dense per-segment math over [k_seg, V]; `col(i)` is param row i as a
    [V] f32 vector.  Returns (tile_x, tile_y, slot, payload, valid)."""
    slot_v = f2i32(col(PSLOT))
    len_v = f2i32(col(PLEN))

    av = col(PA)[None, :]
    bv = col(PB)[None, :]
    cv = col(PC)[None, :]
    dv = col(PD)[None, :]
    a_over = ff64.FF(col(PAOH)[None, :], col(PAOL)[None, :])
    b_over = ff64.FF(col(PBOH)[None, :], col(PBOL)[None, :])
    cd_over = ff64.FF(col(PCDH)[None, :], col(PCDL)[None, :])

    seg_lo = j * k_seg
    i_rel = seg_lo[None, :] + torch.arange(
        k_seg, dtype=torch.int32, device=j.device
    )[:, None]
    in_range = v_live[None, :] & (i_rel < len_v[None, :])

    # get_ith_pixel_segment_params (`rasterizer.rs:63-76`).
    ii = i_rel - (cv != 0.0).to(torch.int32) - (dv != 0.0).to(torch.int32)
    t0 = torch.clamp(
        _find(ii.float(), a_over, b_over, cd_over, av, bv, cv, dv), min=0.0
    )
    t1 = torch.clamp(
        _find((ii + 1).float(), a_over, b_over, cd_over, av, bv, cv, dv), max=1.0
    )

    x0v = col(PX0)[None, :]
    y0v = col(PY0)[None, :]
    dxv = col(PDX)[None, :]
    dyv = col(PDY)[None, :]
    x0f = t0 * dxv + x0v
    y0f = t0 * dyv + y0v
    x1f = t1 * dxv + x0v
    y1f = t1 * dyv + y0v

    def round_(v):
        return f2i32(torch.floor(v + 0.5))

    x0s, x1s, y0s, y1s = round_(x0f), round_(x1f), round_(y0f), round_(y1f)

    border_x = torch.minimum(x0s, x1s) >> consts.PIXEL_SHIFT
    border_y = torch.minimum(y0s, y1s) >> consts.PIXEL_SHIFT

    tile_x = border_x >> consts.TILE_WIDTH_SHIFT
    tile_y = border_y >> consts.TILE_HEIGHT_SHIFT
    local_x = (border_x & (consts.TILE_WIDTH - 1)).long()
    local_y = (border_y & (consts.TILE_HEIGHT - 1)).long()

    border = (border_x << consts.PIXEL_SHIFT) + consts.PIXEL_WIDTH
    cover = y1s - y0s
    mult = torch.abs(x1s - x0s) + 2 * (border - torch.maximum(x0s, x1s))
    area = mult * cover

    # Tiles left of the viewport clamp to tile -1 (cover-carry catch-all);
    # rows above/below and tiles right of the viewport are dropped
    # (`pixel_segment.rs:47-52`, `painter/mod.rs:732-734`).
    tile_x = torch.clamp(tile_x, min=-1)
    tile_y = tile_y - row_lo
    valid = in_range & (tile_y >= 0) & (tile_y < rows) & (tile_x < tiles_x)

    payload = (
        ((local_x << 21) | (local_y << 17)
         | (((area.long() + 1024) & MASK32) << 6)
         | ((cover.long() + 16) & MASK32))
        & MASK32
    )
    payload = torch.where(valid, payload, torch.full_like(payload, ZERO_PAYLOAD))
    slot = slot_v[None, :].long().expand(i_rel.shape)
    return tile_x, tile_y, slot, payload, valid


def _emit_packed(
    col, j, v_live, k_seg: int, rows: int, tiles_x: int, row_lo,
    slot_bits: int, tx_bits: int,
):
    """_emit_core + the single [rowb | slot | txb] key; returns (packed,
    payload) int32 [k_seg, V], the sentinel where invalid.  Layer slot
    sits above tile_x, so the segment sort yields runs in (row, layer,
    tile_x) carry-chain order."""
    check_key_budget(rows, tiles_x, slot_bits, tx_bits)
    tile_x, tile_y, slot, payload, valid = _emit_core(
        col, j, v_live, k_seg, rows, tiles_x, row_lo
    )
    packed = (
        (((((tile_y.long() + 1) & MASK32) << slot_bits) | slot) << tx_bits)
        | ((tile_x.long() + 1) & MASK32)
    ) & MASK32
    packed = torch.where(valid, packed, torch.full_like(packed, PACKED_SENTINEL))
    return packed.to(torch.int32), wrap_i32(payload)


def rasterize_blocks(
    params, vline_ends, v_total, v_cap: int, k_seg: int, rows: int,
    tiles_x: int, row_lo, slot_bits: int, tx_bits: int,
):
    """Returns (packed, payload) int32 [k_seg, v_cap]: the u32 words, the
    sentinel `PACKED_SENTINEL`.

    params f32 [L, 16] (L >= 1, `line_setup`'s columns); vline_ends int64
    [L] inclusive cumsum of per-line vline counts (dead lines repeat the
    previous end); v_total an int64 0-d tensor on the same device, the
    live vline count (it stays on the device: no host sync).  Vlines
    v >= v_total emit only sentinels.  `row_lo`, the global tile row of
    the frame's row 0, is an int or an int32 0-d tensor on the device
    (the kernel reads it there, so a CUDA graph of the frame takes any
    row span).  CUDA tensors launch `forma_rasterize`; CPU tensors take
    `rasterize_blocks_torch`."""
    if not params.is_cuda:
        return rasterize_blocks_torch(
            params, vline_ends, v_total, v_cap, k_seg, rows, tiles_x, row_lo,
            slot_bits, tx_bits,
        )
    L = params.shape[0]
    if L < 1 or not (0 < v_cap < (1 << 24)) or not (0 < k_seg <= 64):
        raise ValueError(f"rasterize_blocks: L={L}, v_cap={v_cap}, k_seg={k_seg} out of range")
    check_key_budget(rows, tiles_x, slot_bits, tx_bits)
    _build.check(params, "params", torch.float32, (L, N_PARAMS))
    _build.check_aligned(params, "params", 16)  # rows load as uint4
    _build.check(vline_ends, "vline_ends", torch.int64, (L,))
    _build.check(v_total, "v_total", torch.int64, ())
    row_lo = _build.row_lo_tensor(row_lo, params.device)
    packed = torch.empty((k_seg, v_cap), dtype=torch.int32, device=params.device)
    payload = torch.empty_like(packed)
    _build.launch(
        "forma_rasterize", "rasterize",
        params.data_ptr(), vline_ends.data_ptr(), v_total.data_ptr(),
        L, v_cap, k_seg, rows, tiles_x, row_lo.data_ptr(), slot_bits, tx_bits,
        packed.data_ptr(), payload.data_ptr(),
    )
    return packed, payload


def rasterize_blocks_torch(
    params, vline_ends, v_total, v_cap: int, k_seg: int, rows: int,
    tiles_x: int, row_lo, slot_bits: int, tx_bits: int,
):
    """Plain PyTorch version of `rasterize_blocks`: K1's plain expansion,
    then `_emit_packed` (the split path's emit); `row_lo` an int or a 0-d
    tensor, as there."""
    pt, j = expand_params_torch(params, vline_ends, v_cap)
    v_live = torch.arange(v_cap, device=params.device) < v_total
    return _emit_packed(
        lambda i: pt[i], j, v_live, k_seg, rows, tiles_x, row_lo,
        slot_bits, tx_bits,
    )
