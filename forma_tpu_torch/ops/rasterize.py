"""Device rasterizer: lines -> sorted pixel segments.

Counterpart of `forma_tpu/ops/rasterize.py:64-96,188-392`:

1. Lines expand into virtual lines of at most `k_seg` pixel segments each,
   and each virtual line emits its segments: the i-th-intersection math
   (`rasterizer.rs:22-76`) in float-float arithmetic, keys and payloads
   (`rasterize_kernel.py`).
2. The segments sort by key, their payloads gathered along.

Two routes, chosen by `slot_bits` (`pipeline.slot_bits_for`):

- Packed (`slot_bits > 0`): one [row | slot | tx] key of at most 31 bits,
  expanded and emitted by K4 (`rasterize_kernel.rasterize_blocks`).  One
  unstable sort orders the key with its payload, both the TPU kernel's
  32-bit words in int32 tensors; invalid slots carry the sentinel
  0x7FFFFFFF and sort last.  The sorted words then widen to the int64
  (key_hi, key_lo, payload) of u32 values that the runs stage takes
  (`_u32.py`), the u32 sentinel in key_hi.
- Two keys (`slot_bits == 0`, layer slots too wide to pack): key_hi =
  (row + 1) << TX_BITS | (tx + 1) and key_lo = the layer slot.  K4 packs
  only the one-word key (as the JAX package's fused branch,
  `forma_tpu/ops/rasterize.py:311`), so a two-key frame takes K1
  (`expand_kernel.expand_params`) and the two-key emit kernel
  (`rasterize_kernel.emit_two_key`), which writes each segment as the
  pair combined into one int64 key with its u32 payload word: the JAX
  package's own route on its chip (backend "pallas",
  `forma_tpu/ops/rasterize.py:334-372`).  One unstable sort orders the
  int64 key, the payload gathered along (`sort_two_key`).  Runs then
  arrive in (row, tx, layer) order, and the runs stage re-sorts them into
  carry-chain order (`runs.run_data(presorted=False)`).  The route stamps
  its own stages (`tracing`): `expand`, `emit` and `key_sort`.
"""

from __future__ import annotations

import torch

from .. import consts, tracing
from ._u32 import MASK32, SENTINEL
from .expand_kernel import expand_params, expand_params_torch
from .rasterize_kernel import (
    PACKED_SENTINEL, SLOT_FIELD_BITS, TWO_KEY_SENTINEL, TX_BITS, emit_two_key,
    emit_two_key_torch, rasterize_blocks, rasterize_blocks_torch,
)


def _expand_emit_two_key(
    params, vline_ends, v_total, v_cap: int, k_seg: int, rows: int, tiles_x: int,
    row_lo, plain: bool, taps, stamp,
):
    """K1, then the two-key emit (or their plain versions), each stamped
    as its stage: flat unsorted (key int64, payload int32) [k_seg * v_cap];
    `taps` (a dict) receives K1's inputs under "expand" and the emit's
    under "emit_two_key"."""
    args = (params, vline_ends, v_cap)
    if taps is not None:
        taps["expand"] = args
    pt, j = (expand_params_torch if plain else expand_params)(*args)
    stamp("expand")
    args = (pt, j, v_total, k_seg, rows, tiles_x, row_lo)
    if taps is not None:
        taps["emit_two_key"] = args
    key, payload = (emit_two_key_torch if plain else emit_two_key)(*args)
    stamp("emit")
    return key.reshape(-1), payload.reshape(-1)


def _expand_emit_packed(
    params, vline_ends, v_total, v_cap: int, k_seg: int, rows: int, tiles_x: int,
    row_lo, slot_bits: int, tx_bits: int, plain: bool = False, taps=None,
):
    """K4 (or its plain version): flat unsorted (packed, payload) int32
    [k_seg * v_cap]; `taps` (a dict) receives K4's inputs under
    "rasterize"."""
    args = (params, vline_ends, v_total, v_cap, k_seg, rows, tiles_x,
            row_lo, slot_bits, tx_bits)
    if taps is not None:
        taps["rasterize"] = args
    packed, payload = (rasterize_blocks_torch if plain else rasterize_blocks)(*args)
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


def sort_two_key(key, payload):
    """One unstable sort of the two-key emit's combined int64 keys, the
    int32 payload words gathered along; returns the sorted (key_hi,
    key_lo, payload) int64 of u32 values, `SENTINEL` and 0 where the key
    is `TWO_KEY_SENTINEL`.  The JAX package sorts the pair as two keys
    (`jax.lax.sort(..., num_keys=2)`); equal pairs are summed by the grid
    accumulation, so their payloads' order is irrelevant."""
    key, order = torch.sort(key, stable=False)
    invalid = key == TWO_KEY_SENTINEL
    key_hi = (key >> SLOT_FIELD_BITS).masked_fill_(invalid, SENTINEL)
    key_lo = (key & consts.LAYER_LIMIT).masked_fill_(invalid, 0)
    return key_hi, key_lo, payload[order].long() & MASK32


def rasterize_sort(
    params, slots, lengths, vline_ends, v_total,
    v_cap: int, k_seg: int, rows: int, tiles_x: int,
    row_lo=0, slot_bits: int = 0, plain: bool = False, taps=None,
    stamp=tracing.no_mark,  # the frame's stage stamps (`tracing.marker`)
):
    """Returns sorted (key_hi, key_lo, payload) int64 [v_cap * k_seg] of u32
    values.

    `slot_bits > 0`: the packed key from K4, then `sort_segments`.
    `slot_bits == 0`: the two-key route, K1 and the two-key emit kernel
    (K4 packs only the one-word key), then `sort_two_key`, each stamped as
    its stage (`expand`, `emit`, `key_sort`); the packed key stamps
    nothing here.  Both sorts are unstable.  `plain` runs each kernel's plain
    PyTorch version on any device; `taps` (a dict) receives each kernel's
    inputs."""
    if taps is not None:
        taps["rasterize_sort"] = (params, slots, lengths, vline_ends, v_total, v_cap,
                                  k_seg, rows, tiles_x, row_lo, slot_bits)
    if slot_bits <= 0:
        key, payload = _expand_emit_two_key(
            params, vline_ends, v_total, v_cap, k_seg, rows, tiles_x, row_lo,
            plain, taps, stamp,
        )
        out = sort_two_key(key, payload)
        stamp("key_sort")
        return out
    tx_bits = max((tiles_x + 1).bit_length(), 1)
    packed, payload = _expand_emit_packed(
        params, vline_ends, v_total, v_cap, k_seg, rows, tiles_x, row_lo,
        slot_bits, tx_bits, plain=plain, taps=taps,
    )
    return sort_segments(packed, payload, slot_bits, tx_bits)


def unpack_payload(payload):
    """payload -> (local_x, local_y, area, cover) i32."""
    lx = ((payload >> 21) & 15).to(torch.int32)
    ly = ((payload >> 17) & 15).to(torch.int32)
    area = ((payload >> 6) & 0x7FF).to(torch.int32) - 1024
    cover = (payload & 63).to(torch.int32) - 16
    return lx, ly, area, cover
