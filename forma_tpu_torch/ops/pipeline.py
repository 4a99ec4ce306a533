"""The single-device frame pipeline.

Counterpart of `forma_tpu/ops/pipeline.py:34-342,569-587`: `render_frame`
runs every stage (line setup, virtual-line expansion, rasterize, sort,
runs, carries, units, occlusion culling, paint, sRGB) with static
capacity buckets, and returns the packed frame with a small diagnostics
vector (actual totals vs capacities); the renderer reads both once and
re-renders with bigger buckets on overflow.

Ported: the packed single-key path (`slot_bits > 0`) of solid/Over
frames, uncached and uncropped.  The rest raises `NotImplementedError`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    plain: bool = False, taps=None,
):
    _paint.require_slice(features)
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
        slot_bits=slot_bits, plain=plain, taps=taps,
    )
    return _back(
        key_hi, key_lo, payload, v_total, total_segs,
        st, clear, rows, tiles_x, caps, features, channels,
        plain=plain, taps=taps,
    )


def _back(
    key_hi, key_lo, payload,  # sorted segment stream
    v_total, total_segs,  # diagnostics scalars from the front half
    st, clear, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels,
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
            features, st["pidx"], st["fill_rule"], st["color"]
        ),
        plain=plain, taps=taps,
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

    # Layer-workbench occlusion pass + ONE unit re-sort.
    keep = _paint.cull_units_keep(key_u, virt_u, k_u, u_valid)
    key_u, layer_u, src_u, src2_u, virt_u, k_u, u_valid, k_needed = (
        _paint._renumber_units(key_u, layer_u, src_u, src2_u, virt_u, keep)
    )

    frame = _paint.paint(
        key_u, u_valid, src2_u, rd["grid"], rd["carry_in_s"],
        rd["carry_after_s"], rd["style_s"], rd["tx_s"], clear,
        rows, tiles_x, caps.k, plain=plain, taps=taps,
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
    plain: bool = False,  # run every kernel's plain PyTorch version
    taps=None,  # dict: receives each kernel's input tuple when given
):
    """Single-device render of tile rows [0, rows); returns (u8 frame
    [rows*16, tiles_x*16, C], int64 [6] diagnostics)."""
    return _core(
        px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
        width, height, rows, tiles_x, caps, features, channels,
        plain=plain, taps=taps,
    )


def style_tables_device(st, device) -> dict:
    """Host StyleTables -> a dict of tensors on `device` (u32 as int64)."""
    names = (
        "orders", "pidx", "fill_rule", "func", "clip_n", "is_clipped",
        "blend", "fill_type", "color", "grad", "stops", "tex", "atlas",
    )
    return {n: from_numpy(getattr(st, n), device) for n in names}
