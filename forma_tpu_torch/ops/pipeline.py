"""The single-device frame pipeline.

Counterpart of `forma_tpu/ops/pipeline.py:34-342,569-587`: `render_frame`
runs every stage (line setup, virtual-line expansion, rasterize, sort,
runs, carries, units, occlusion culling, paint, sRGB) with static
capacity buckets, and returns the packed frame with a small diagnostics
vector (actual totals vs capacities); the renderer reads both once and
re-renders with bigger buckets on overflow.

Ported: uncached, uncropped frames for solid, gradient and texture
fills, the 16 blend modes and clips, on both sort keys: the packed
single key (`slot_bits > 0`) and, where [row | slot | tx] passes 31 bits,
the two-key route (`slot_bits == 0`: K1 and the emit in PyTorch, the
int64 two-key sort, the runs re-sorted into carry-chain order, and K3
reading each unit's grid row by `src_u`), as the JAX package routes them
(`forma_tpu/ops/pipeline.py:98-110,123,147`).  The damage cache and crop
are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import consts
from . import line_setup as _ls
from . import paint as _paint
from . import rasterize as _raster
from . import runs as _runs
from . import srgb as _srgb
from ._u32 import from_numpy
from .paint import Features

K_SEG = 8  # pixel segments per virtual line


class Caps(NamedTuple):
    """Static capacity buckets for one pipeline configuration."""

    vline: int = 512  # virtual lines (each up to K_SEG pixel segments)
    run: int = 512
    virt: int = 512
    k: int = 4


# Indices into the diagnostics vector (DIAG_DMG reads 0: no damage cache).
DIAG_VLINES, DIAG_RUNS, DIAG_VIRT, DIAG_K, DIAG_SEGS, DIAG_DMG = range(6)


def slot_bits_for(n_slots: int, rows: int, tiles_x: int) -> int:
    """Bits for the layer slot in the packed single-u32 sort key; 0 when
    [row | slot | tx] cannot fit 31 bits (the two-key path)."""
    slot_bits = max((n_slots - 1).bit_length(), 1)
    row_bits = (rows + 1).bit_length()
    tx_bits = max((tiles_x + 1).bit_length(), 1)
    if row_bits + tx_bits + slot_bits > 31:
        return 0
    return slot_bits


def _core(
    px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
    width: int, height: int, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels,
    expand: str = "fused", plain: bool = False, taps=None,
):
    params, slots, lengths, vline_ends = _ls.line_setup(
        px, py, line_slot, g_slot, g_valid, g_t, g_has_t, width, height,
        k_seg=K_SEG,
    )
    v_total = vline_ends[-1]
    total_segs = lengths.sum(dtype=torch.int64)

    slot_bits = slot_bits_for(st["orders"].shape[0], rows, tiles_x)
    key_hi, key_lo, payload = _raster.rasterize_sort(
        params, slots, lengths, vline_ends,
        torch.clamp(v_total, max=caps.vline),
        caps.vline, K_SEG, rows, tiles_x, 0,
        slot_bits=slot_bits, expand=expand, plain=plain, taps=taps,
    )
    return _back(
        key_hi, key_lo, payload, v_total, total_segs,
        st, clear, rows, tiles_x, caps, features, channels,
        presorted=slot_bits > 0, plain=plain, taps=taps,
    )


def _back(
    key_hi, key_lo, payload,  # sorted segment stream
    v_total, total_segs,  # diagnostics scalars from the front half
    st, clear, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels,
    presorted: bool = False,  # sorted by the packed key: runs arrive in
    #                           carry-chain order, and src_u == src2_u
    plain: bool = False, taps=None,
):
    """Everything after the segment sort: runs, carries, units, the
    occlusion pass, paint, sRGB."""
    run_id, num_runs, new_run = _runs.extract_runs(key_hi, key_lo)

    st_opaque = (
        (st["func"] == 0)
        & (st["fill_type"] == 0)
        & (st["color"][:, 3] == 1.0)
        & (st["blend"] == 0)
        & (~st["is_clipped"])
    )
    st_isclip = st["func"] == 1
    st_solid = (st["func"] == 0) & (st["fill_type"] == 0) & (~st["is_clipped"])

    rd = _runs.run_data(
        key_hi, key_lo, payload, run_id, new_run,
        torch.clamp(num_runs, max=caps.run),
        st["pidx"], st["fill_rule"], st_opaque, st_isclip, st_solid,
        caps.run, tiles_x,
        style_pack=_paint.style_pack_for_fold(
            features,
            st["orders"], st["pidx"], st["fill_rule"], st["func"],
            st["clip_n"], st["is_clipped"], st["blend"], st["fill_type"],
            st["color"], st["grad"], st["stops"], st["tex"],
        ),
        presorted=presorted, plain=plain, taps=taps,
    )

    key_u, layer_u, src_u, src2_u, virt_u, k_u, u_valid, _ = (
        _runs.build_units(
            rd["run_hi"], rd["run_layer"], rd["r_valid"], rd["real_flags"],
            rd["inv"], rd["key2_s"], rd["tx_s"], rd["gap_flags_s"],
            rd["span"], rd["cumspan"],
            torch.clamp(rd["v_total"], max=caps.virt),
            caps.virt,
        )
    )

    # Layer-workbench passes fused into one keep mask + ONE unit re-sort;
    # the occlusion analysis may run on the pre-clip-pass list
    # (`forma_tpu/ops/paint.py:644-650`).
    keep = _paint.cull_units_keep(key_u, virt_u, k_u, u_valid)
    if features.has_clip:
        # Trivial-clip elimination (`passes/skip_trivial_clips.rs`).
        slot_u = torch.clamp(layer_u.long(), max=st["orders"].shape[0] - 1)
        pi_u = st["pidx"][slot_u].long()
        id_u = st["orders"][slot_u] & consts.LAYER_LIMIT
        cend_u = id_u + st["clip_n"][pi_u]
        clipped_u = st["is_clipped"][pi_u] & (st["func"][pi_u] == 0)
        keep_c, virt_u = _paint.skip_trivial_clips_keep(
            key_u, virt_u, u_valid, id_u, cend_u, clipped_u
        )
        keep &= keep_c
    key_u, layer_u, src_u, src2_u, virt_u, k_u, u_valid, k_needed = (
        _paint._renumber_units(key_u, layer_u, src_u, src2_u, virt_u, keep)
    )

    # Presorted, src_u == src2_u: passing src2_u for both keeps the fold
    # in table mode, one index load per unit.
    frame = _paint.paint(
        key_u, u_valid, src2_u if presorted else src_u, src2_u, virt_u,
        rd["grid"], rd["carry_in_s"],
        rd["carry_after_s"], rd["style_s"], rd["tx_s"], clear,
        rows, tiles_x, caps.k, features, st["stops"].shape[1], st["atlas"],
        plain=plain, taps=taps,
    )
    packed = _srgb.pack_srgb(frame, channels)

    diag = torch.stack(
        [
            v_total.long(),
            num_runs.long(),
            rd["v_total"].long(),
            k_needed.long(),
            total_segs.long(),
            torch.zeros((), dtype=torch.int64, device=packed.device),
        ]
    )
    return packed, diag


def render_frame(
    px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
    width: int, height: int, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels,
    expand: str = "fused",  # "fused" (K4) or "split" (K1 + PyTorch emit)
    plain: bool = False,  # run every kernel's plain PyTorch version
    taps=None,  # dict: receives each kernel's input tuple when given
):
    """Single-device render of tile rows [0, rows); returns (u8 frame
    [rows*16, tiles_x*16, C], int64 [6] diagnostics)."""
    return _core(
        px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
        width, height, rows, tiles_x, caps, features, channels,
        expand=expand, plain=plain, taps=taps,
    )


def style_tables_device(st, device) -> dict:
    """Host StyleTables -> a dict of tensors on `device` (u32 as int64)."""
    names = (
        "orders", "pidx", "fill_rule", "func", "clip_n", "is_clipped",
        "blend", "fill_type", "color", "grad", "stops", "tex", "atlas",
    )
    return {n: from_numpy(getattr(st, n), device) for n in names}
