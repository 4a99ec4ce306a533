"""Device paint: unit culling and the per-tile fold over run-indexed grids.

Counterpart of `forma_tpu/ops/paint.py:85-141,331-338,551-567,624-780` for
the port's slice: solid fills, Over blending, no clips, on the presorted
packed-key path, where the fold runs in table mode (K3,
`fold_kernel.fold_tiles`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from forma_tpu import consts

from ._u32 import SENTINEL, f32_bits
from .fold_kernel import SOLID_WIDTH, fold_tiles, style_layout
from .runs import _roll1, sort_units

TH = consts.TILE_HEIGHT
TW = consts.TILE_WIDTH

# virt_u flag bits (see runs.run_data / build_units).
FLAG_VIRTUAL = 1
FLAG_FULL_OPAQUE = 2
FLAG_CLIP = 4
FLAG_FULL_SOLID = 8  # full cover + solid fill: scalar-foldable
FLAG_FULL_CLIP = 16  # full-cover clip: all-pass, droppable
FLAG_UNCLIPPED = 32  # draw whose governing clip was a dropped full clip


class Features(NamedTuple):
    """Static per-frame feature set (`forma_tpu/ops/paint.py:331-338`)."""

    blend_modes: Tuple[int, ...] = (0,)
    has_gradient: bool = False
    has_texture: bool = False
    has_clip: bool = False


def require_slice(features: Features) -> None:
    """Raises for frames the port's slice does not cover yet."""
    if features != Features():
        raise NotImplementedError(
            f"frame features {features} are not ported yet: only solid fills "
            "with Over blending render; gradients, blend modes, clips and "
            "textures are ROADMAP.md section 1, item 9 (feature breadth)"
        )


def style_pack_for_fold(features: Features, st_pidx, st_fill_rule, st_color):
    """Per-layer-slot style rows in the fold's lane layout, i32 [SL, 5]
    for a solid/Over frame: rgba f32 bits | fill rule (ONE [P]-row matrix
    and one gather by pidx)."""
    require_slice(features)
    lay = style_layout(features, 1)
    assert lay.width == SOLID_WIDTH
    p_mat = torch.cat([f32_bits(st_color), st_fill_rule[:, None]], dim=1)
    return p_mat[st_pidx.long()]


def _seg_cummax(gid, values):
    """Segmented prefix max of non-negative `values` within equal-gid
    groups (gid nondecreasing): one cummax over gid-major packed keys."""
    key = gid.long() << 32
    return torch.cummax(key | values.long(), 0).values - key


def cull_units_keep(key_u, virt_u, k_u, u_valid):
    """Occlusion-pass analysis (`skip_fully_covered_layers.rs:27-119`):
    keeps every unit at or above the topmost full-cover opaque unit of its
    tile; tiles containing a clip unit keep everything."""
    new_tile = key_u != _roll1(key_u)
    new_tile[0] = True
    full_opaque = ((virt_u & FLAG_FULL_OPAQUE) != 0) & u_valid
    is_clip = ((virt_u & FLAG_CLIP) != 0) & u_valid

    def rev(x):
        return torch.flip(x, (0,))

    # Reverse-segmented cummax of (full_opaque ? k+1 : 0): for each unit,
    # the highest full-opaque slot at or after it within its tile.
    tail_new = torch.roll(new_tile, -1, 0)
    tail_new[-1] = True  # last of each group
    gid_r = torch.cumsum(rev(tail_new), 0)
    fo_k1 = torch.where(full_opaque, k_u.long() + 1, 0)
    k_top1 = rev(_seg_cummax(gid_r, rev(fo_k1)))

    gid_f = torch.cumsum(new_tile, 0)
    clip_v = is_clip.long()
    clip_fwd = _seg_cummax(gid_f, clip_v)
    clip_rev = rev(_seg_cummax(gid_r, rev(clip_v)))
    tile_has_clip = (clip_fwd | clip_rev) > 0

    return u_valid & ((k_u.long() + 1 >= k_top1) | tile_has_clip)


def _renumber_units(key_u, layer_u, src_u, src2_u, virt_u, keep):
    """Drops units where ~keep, re-sorts, recomputes per-tile slots."""
    key2 = torch.where(keep, key_u, torch.full_like(key_u, SENTINEL))
    return sort_units(key2, layer_u, src_u, src2_u, virt_u)


def paint(
    key_u,  # int64 [U] (u32 values) unit (tile) keys, (tile, layer)-sorted
    u_valid,  # bool [U]
    src2_u,  # i32 [U] run index per unit
    grid,  # i32 [R, 256] packed area|cover
    carry_in_s,  # i32 [R, 16]
    carry_after_s,  # i32 [R, 16]
    style_s,  # i32 [R, 5] per-run style rows
    tx_s,  # i32 [R] per-run tile x
    clear,  # f32 [4]
    rows: int,
    tiles_x: int,
    k_slots: int,
    plain: bool = False,
    taps=None,
):
    """Returns the painted frame of a solid/Over frame as linear f32
    [rows*16, tiles_x*16, 4]."""
    frame_t = fold_tiles(
        key_u, u_valid, src2_u, grid, carry_in_s, carry_after_s, tx_s,
        style_s, clear, rows, tiles_x, k_slots, plain=plain, taps=taps,
    )
    frame = frame_t.reshape(rows, tiles_x, TH, TW, 4)
    return frame.permute(0, 2, 1, 3, 4).reshape(rows * TH, tiles_x * TW, 4)
