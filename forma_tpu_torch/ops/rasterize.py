"""Device rasterizer: lines -> sorted packed pixel segments.

Counterpart of `forma_tpu/ops/rasterize.py:77-289,379-392` on the packed
single-key path:

1. Lines expand into virtual lines of at most `k_seg` pixel segments each
   (K1, `expand_kernel.expand_params`).
2. The i-th-intersection math (`rasterizer.rs:22-76`) runs densely over
   [k_seg, V] in float-float arithmetic (`ops/ff64.py`).
3. One unstable sort orders the packed [row | slot | tx] key with its
   payload; invalid slots carry the sentinel and sort last.

Pixel segments pack as

    key     = ((tile_y + 1) << slot_bits | slot) << tx_bits | (tile_x + 1)
    payload = local_x << 21 | local_y << 17 | (area + 1024) << 6 | (cover + 16)

all u32 values held in int64 (`_u32.py`).
"""

from __future__ import annotations

import torch

from forma_tpu import consts

from . import ff64
from ._u32 import MASK32, SENTINEL, f2i32
from .expand_kernel import expand_params, expand_params_torch
from .line_setup import (
    PA, PAOH, PAOL, PB, PBOH, PBOL, PC, PCDH, PCDL, PD, PDX, PDY, PLEN,
    PSLOT, PX0, PY0,
)

TX_BITS = 13  # tile_x + 1 in the canonical key_hi (max 4096 tiles of 16)
ZERO_PAYLOAD = (1024 << 6) | 16  # area 0, cover 0


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


def _emit_core(col, j, v_live, k_seg: int, rows: int, tiles_x: int, row_lo: int):
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
    col, j, v_live, k_seg: int, rows: int, tiles_x: int, row_lo: int,
    slot_bits: int, tx_bits: int,
):
    """_emit_core + the single-u32 [rowb | slot | txb] key; sentinel where
    invalid.  Layer slot sits above tile_x, so the segment sort yields
    runs in (row, layer, tile_x) carry-chain order."""
    tile_x, tile_y, slot, payload, valid = _emit_core(
        col, j, v_live, k_seg, rows, tiles_x, row_lo
    )
    packed = (
        (((((tile_y.long() + 1) & MASK32) << slot_bits) | slot) << tx_bits)
        | ((tile_x.long() + 1) & MASK32)
    ) & MASK32
    packed = torch.where(valid, packed, torch.full_like(packed, SENTINEL))
    return packed, payload


def _expand_emit_packed(
    params, lengths, vline_ends, v_total,
    v_cap: int, k_seg: int, rows: int, tiles_x: int, row_lo: int,
    slot_bits: int, tx_bits: int, plain: bool = False, taps=None,
):
    """K1 expansion + packed emit; returns flat unsorted (packed, payload)
    int64 [k_seg * v_cap].  `plain` runs K1's plain PyTorch version on any
    device; `taps` (a dict) receives K1's inputs."""
    args = (params, vline_ends, v_cap)
    if taps is not None:
        taps["expand"] = args
    PT, j = (expand_params_torch if plain else expand_params)(*args)
    v_live = torch.arange(v_cap, device=params.device) < v_total
    packed, payload = _emit_packed(
        lambda i: PT[i], j, v_live, k_seg, rows, tiles_x, row_lo,
        slot_bits, tx_bits,
    )
    return packed.reshape(-1), payload.reshape(-1)


def unpack_packed_keys(packed, slot_bits: int, tx_bits: int):
    """Packed [rowb | slot | txb] -> (key_hi, key_lo) in the canonical
    (rowb << TX_BITS | txb, layer slot) form the runs stage consumes."""
    invalid = packed == SENTINEL
    txb = packed & ((1 << tx_bits) - 1)
    rowb = packed >> (slot_bits + tx_bits)
    key_hi = torch.where(
        invalid, torch.full_like(packed, SENTINEL), (rowb << TX_BITS) | txb
    )
    key_lo = torch.where(
        invalid,
        torch.zeros_like(packed),
        (packed >> tx_bits) & ((1 << slot_bits) - 1),
    )
    return key_hi, key_lo


def rasterize_sort(
    params, slots, lengths, vline_ends, v_total,
    v_cap: int, k_seg: int, rows: int, tiles_x: int,
    row_lo: int = 0, slot_bits: int = 0, plain: bool = False, taps=None,
):
    """Returns sorted (key_hi, key_lo, payload) int64 [v_cap * k_seg].

    Only the packed single-key path is ported; `slot_bits == 0` (layer
    slots too wide to pack) raises.  The sort is unstable: segments with
    equal keys are summed by the grid accumulation, so their order is
    irrelevant (`forma_tpu/ops/rasterize.py:374-378`)."""
    if slot_bits <= 0:
        raise NotImplementedError(
            "the two-key sort path (slot_bits == 0) is not ported yet: "
            "ROADMAP.md section 1, item 10 (wide-key fallback)"
        )
    tx_bits = max((tiles_x + 1).bit_length(), 1)
    packed, payload = _expand_emit_packed(
        params, lengths, vline_ends, v_total,
        v_cap, k_seg, rows, tiles_x, row_lo, slot_bits, tx_bits,
        plain=plain, taps=taps,
    )
    packed, order = torch.sort(packed, stable=False)
    payload = payload[order]
    key_hi, key_lo = unpack_packed_keys(packed, slot_bits, tx_bits)
    return key_hi, key_lo, payload


def unpack_payload(payload):
    """payload -> (local_x, local_y, area, cover) i32."""
    lx = ((payload >> 21) & 15).to(torch.int32)
    ly = ((payload >> 17) & 15).to(torch.int32)
    area = ((payload >> 6) & 0x7FF).to(torch.int32) - 1024
    cover = (payload & 63).to(torch.int32) - 16
    return lx, ly, area, cover
