"""Device rasterizer: lines -> sorted pixel segments.

Counterpart of `forma_tpu/ops/rasterize.py:64-96,188-392`:

1. Lines expand into virtual lines of at most `k_seg` pixel segments each,
   and each virtual line emits its segments: the i-th-intersection math
   (`rasterizer.rs:22-76`) in float-float arithmetic, keys and payloads
   (`rasterize_kernel.py`).
2. The segments sort by key, their payloads gathered along.

Two key forms, chosen by `slot_bits` (`pipeline.slot_bits_for`):

- Packed (`slot_bits > 0`): one [row | slot | tx] key of at most 31 bits.
  Two paths compute the same segments: `expand="fused"` runs K4
  (`rasterize_kernel.rasterize_blocks`), `expand="split"` runs K1
  (`expand_kernel.expand_params`) and the emit in PyTorch; the JAX package
  picks between them with `FORMA_EXPAND`, the port takes the caller's
  argument.  One unstable sort orders the key with its payload, both the
  TPU kernel's 32-bit words in int32 tensors; invalid slots carry the
  sentinel 0x7FFFFFFF and sort last.  The sorted words then widen to the
  int64 (key_hi, key_lo, payload) of u32 values that the runs stage takes
  (`_u32.py`), the u32 sentinel in key_hi.
- Two keys (`slot_bits == 0`, layer slots too wide to pack): key_hi =
  (row + 1) << TX_BITS | (tx + 1) and key_lo = the layer slot
  (`_emit_two_key`).  K4 packs only the one-word key (as the JAX package's
  fused branch, `forma_tpu/ops/rasterize.py:311`), so a two-key frame
  always takes K1 and the emit in PyTorch, whatever `expand` says: the
  JAX package's own route on its chip (backend "pallas",
  `forma_tpu/ops/rasterize.py:334-372`).  The pair sorts as one int64 key
  (`sort_two_key`).  Runs then arrive in (row, tx, layer) order, and the
  runs stage re-sorts them into carry-chain order
  (`runs.run_data(presorted=False)`).
"""

from __future__ import annotations

import torch

from .. import consts
from ._u32 import MASK32, SENTINEL
from .expand_kernel import expand_params, expand_params_torch
from .rasterize_kernel import (
    PACKED_SENTINEL, _emit_core, _emit_packed, rasterize_blocks,
    rasterize_blocks_torch,
)

TX_BITS = 13  # tile_x + 1 in the canonical key_hi (max 4096 tiles of 16)
EXPAND_PATHS = ("fused", "split")
# The two-key sort's combined int64 key is key_hi << SLOT_FIELD_BITS |
# key_lo: a valid key_hi is below 2^25 ((2049 << 13) | 4097 at the
# format's limits) and a slot below 2^21, so it fits 46 bits, and the
# sentinel maps to int64's maximum, above every valid key (the u32
# sentinel shifted left by 21 would not fit, and by 32 would sort first).
SLOT_FIELD_BITS = consts.LAYER_LIMIT.bit_length()  # 21
TWO_KEY_SENTINEL = (1 << 63) - 1


def _expand(params, vline_ends, v_total, v_cap: int, plain: bool, taps):
    """K1 (or its plain version): (col, j, v_live) for an emit, where
    `col(i)` is param row i over the v_cap vlines; `taps` (a dict)
    receives K1's inputs under "expand"."""
    args = (params, vline_ends, v_cap)
    if taps is not None:
        taps["expand"] = args
    pt, j = (expand_params_torch if plain else expand_params)(*args)
    v_live = torch.arange(v_cap, device=params.device) < v_total
    return (lambda i: pt[i]), j, v_live


def _expand_emit_packed(
    params, lengths, vline_ends, v_total,
    v_cap: int, k_seg: int, rows: int, tiles_x: int, row_lo,
    slot_bits: int, tx_bits: int, expand: str = "fused", plain: bool = False,
    taps=None,
):
    """Expansion + packed emit through `expand`'s path; returns flat
    unsorted (packed, payload) int32 [k_seg * v_cap].  `plain` runs the
    kernel's plain PyTorch version on any device; `taps` (a dict) receives
    the kernel's inputs."""
    if expand == "fused":
        args = (params, vline_ends, v_total, v_cap, k_seg, rows, tiles_x,
                row_lo, slot_bits, tx_bits)
        if taps is not None:
            taps["rasterize"] = args
        packed, payload = (rasterize_blocks_torch if plain else rasterize_blocks)(*args)
    else:  # "split" (rasterize_sort checks `expand`)
        col, j, v_live = _expand(params, vline_ends, v_total, v_cap, plain, taps)
        packed, payload = _emit_packed(
            col, j, v_live, k_seg, rows, tiles_x, row_lo, slot_bits, tx_bits,
        )
    return packed.reshape(-1), payload.reshape(-1)


def unpack_packed_keys(packed, payload, slot_bits: int, tx_bits: int):
    """Sorted int32 words -> int64 (key_hi, key_lo, payload) of u32 values:
    the packed [rowb | slot | txb] in the canonical (rowb << TX_BITS | txb,
    layer slot) form the runs stage consumes, `SENTINEL` in key_hi where
    the key was `PACKED_SENTINEL`, and the payload's 32 bits."""
    # Fields are cut from the int32 words (a valid key is non-negative) and
    # widen only where int64 is needed; the sentinel's garbage fields are
    # overwritten in place.
    invalid = packed == PACKED_SENTINEL
    key_hi = (packed >> (slot_bits + tx_bits)).long() << TX_BITS
    key_hi |= packed & ((1 << tx_bits) - 1)
    key_hi.masked_fill_(invalid, SENTINEL)
    key_lo = ((packed >> tx_bits) & ((1 << slot_bits) - 1)).long()
    key_lo.masked_fill_(invalid, 0)
    return key_hi, key_lo, payload.long() & MASK32


def sort_segments(packed, payload, slot_bits: int, tx_bits: int):
    """One unstable sort of the int32 keys, the payload gathered along, then
    `unpack_packed_keys`.  Segments with equal keys are summed by the grid
    accumulation, so their order is irrelevant
    (`forma_tpu/ops/rasterize.py:374-378`)."""
    packed, order = torch.sort(packed, stable=False)
    return unpack_packed_keys(packed, payload[order], slot_bits, tx_bits)


def _emit_two_key(col, j, v_live, k_seg: int, rows: int, tiles_x: int, row_lo):
    """_emit_core + the two-key form (`forma_tpu/ops/rasterize.py:216-226`):
    (key_hi, key_lo, payload) int64 [k_seg, V] of u32 values, key_hi =
    (tile_y + 1) << TX_BITS | (tile_x + 1) and key_lo the layer slot;
    `SENTINEL` and 0 where invalid."""
    tile_x, tile_y, slot, payload, valid = _emit_core(
        col, j, v_live, k_seg, rows, tiles_x, row_lo
    )
    key_hi = ((tile_y.long() + 1) << TX_BITS) | (tile_x.long() + 1)
    key_hi = torch.where(valid, key_hi, torch.full_like(key_hi, SENTINEL))
    key_lo = torch.where(valid, slot, torch.zeros_like(slot))
    return key_hi, key_lo, payload


def sort_two_key(key_hi, key_lo, payload):
    """One unstable sort of (key_hi, key_lo) as one int64 key (`key_hi <<
    SLOT_FIELD_BITS | key_lo`, `TWO_KEY_SENTINEL` where key_hi is the
    sentinel), the payload gathered along; returns the sorted (key_hi,
    key_lo, payload) int64 of u32 values, `SENTINEL` and 0 where invalid.
    The JAX package sorts the pair as two keys (`jax.lax.sort(...,
    num_keys=2)`); equal pairs are summed by the grid accumulation, so
    their payloads' order is irrelevant."""
    key = torch.where(
        key_hi != SENTINEL, (key_hi << SLOT_FIELD_BITS) | key_lo,
        torch.full_like(key_hi, TWO_KEY_SENTINEL),
    )
    key, order = torch.sort(key, stable=False)
    invalid = key == TWO_KEY_SENTINEL
    key_hi = (key >> SLOT_FIELD_BITS).masked_fill_(invalid, SENTINEL)
    key_lo = (key & consts.LAYER_LIMIT).masked_fill_(invalid, 0)
    return key_hi, key_lo, payload[order]


def rasterize_sort(
    params, slots, lengths, vline_ends, v_total,
    v_cap: int, k_seg: int, rows: int, tiles_x: int,
    row_lo=0, slot_bits: int = 0, expand: str = "fused",
    plain: bool = False, taps=None,
):
    """Returns sorted (key_hi, key_lo, payload) int64 [v_cap * k_seg] of u32
    values.

    `slot_bits > 0`: the packed key through `expand`'s path, then
    `sort_segments`.  `slot_bits == 0`: the two-key route, K1 and the
    emit in PyTorch whatever `expand` says (K4 packs only the one-word
    key), then `sort_two_key`.  Both sorts are unstable.  `plain` runs
    each kernel's plain PyTorch version on any device; `taps` (a dict)
    receives each kernel's inputs."""
    if expand not in EXPAND_PATHS:
        raise ValueError(f"expand must be one of {EXPAND_PATHS}, got {expand!r}")
    if taps is not None:
        taps["rasterize_sort"] = (params, slots, lengths, vline_ends, v_total, v_cap,
                                  k_seg, rows, tiles_x, row_lo, slot_bits)
    if slot_bits <= 0:
        col, j, v_live = _expand(params, vline_ends, v_total, v_cap, plain, taps)
        key_hi, key_lo, payload = _emit_two_key(
            col, j, v_live, k_seg, rows, tiles_x, row_lo
        )
        return sort_two_key(key_hi.reshape(-1), key_lo.reshape(-1), payload.reshape(-1))
    tx_bits = max((tiles_x + 1).bit_length(), 1)
    packed, payload = _expand_emit_packed(
        params, lengths, vline_ends, v_total,
        v_cap, k_seg, rows, tiles_x, row_lo, slot_bits, tx_bits,
        expand=expand, plain=plain, taps=taps,
    )
    return sort_segments(packed, payload, slot_bits, tx_bits)


def unpack_payload(payload):
    """payload -> (local_x, local_y, area, cover) i32."""
    lx = ((payload >> 21) & 15).to(torch.int32)
    ly = ((payload >> 17) & 15).to(torch.int32)
    area = ((payload >> 6) & 0x7FF).to(torch.int32) - 1024
    cover = (payload & 63).to(torch.int32) - 16
    return lx, ly, area, cover
