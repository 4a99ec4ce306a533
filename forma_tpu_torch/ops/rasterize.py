"""Device rasterizer: lines -> sorted packed pixel segments.

Counterpart of `forma_tpu/ops/rasterize.py:64-96,188-289,305-333,379-392`
on the packed single-key path:

1. Lines expand into virtual lines of at most `k_seg` pixel segments each,
   and each virtual line emits its packed segments: the i-th-intersection
   math (`rasterizer.rs:22-76`) in float-float arithmetic, keys and
   payloads (`rasterize_kernel.py`).  Two paths compute the same segments:
   `expand="fused"` runs K4 (`rasterize_kernel.rasterize_blocks`),
   `expand="split"` runs K1 (`expand_kernel.expand_params`) and the emit
   in PyTorch.  The JAX package picks between them with `FORMA_EXPAND`;
   the port takes the caller's argument.
2. One unstable sort orders the packed [row | slot | tx] key with its
   payload, both the TPU kernel's 32-bit words in int32 tensors; invalid
   slots carry the sentinel 0x7FFFFFFF and sort last.  The sorted words
   then widen to the int64 (key_hi, key_lo, payload) of u32 values that
   the runs stage takes (`_u32.py`), the u32 sentinel in key_hi.
"""

from __future__ import annotations

import torch

from ._u32 import MASK32, SENTINEL
from .expand_kernel import expand_params, expand_params_torch
from .rasterize_kernel import (
    PACKED_SENTINEL, _emit_packed, rasterize_blocks, rasterize_blocks_torch,
)

TX_BITS = 13  # tile_x + 1 in the canonical key_hi (max 4096 tiles of 16)
EXPAND_PATHS = ("fused", "split")


def _expand_emit_packed(
    params, lengths, vline_ends, v_total,
    v_cap: int, k_seg: int, rows: int, tiles_x: int, row_lo: int,
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
    elif expand == "split":
        args = (params, vline_ends, v_cap)
        if taps is not None:
            taps["expand"] = args
        pt, j = (expand_params_torch if plain else expand_params)(*args)
        v_live = torch.arange(v_cap, device=params.device) < v_total
        packed, payload = _emit_packed(
            lambda i: pt[i], j, v_live, k_seg, rows, tiles_x, row_lo,
            slot_bits, tx_bits,
        )
    else:
        raise ValueError(f"expand must be one of {EXPAND_PATHS}, got {expand!r}")
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


def rasterize_sort(
    params, slots, lengths, vline_ends, v_total,
    v_cap: int, k_seg: int, rows: int, tiles_x: int,
    row_lo: int = 0, slot_bits: int = 0, expand: str = "fused",
    plain: bool = False, taps=None,
):
    """Returns sorted (key_hi, key_lo, payload) int64 [v_cap * k_seg] of u32
    values.

    Only the packed single-key path is ported; `slot_bits == 0` (layer
    slots too wide to pack) raises.  The sort is unstable
    (`sort_segments`)."""
    if slot_bits <= 0:
        raise NotImplementedError(
            "the two-key sort path (slot_bits == 0) is not ported yet: "
            "ROADMAP.md section 1, item 10 (wide-key fallback)"
        )
    if taps is not None:
        taps["rasterize_sort"] = (params, slots, lengths, vline_ends, v_total, v_cap,
                                  k_seg, rows, tiles_x, row_lo, slot_bits)
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
