"""Device paint: unit passes and the per-tile fold over run-indexed grids.

Counterpart of `forma_tpu/ops/paint.py:85-141,331-611,624-780`; the fold
(K3, `fold_kernel.fold_tiles`) reads the per-run tables directly, on
either sort key: solid, gradient and texture fills, the 16 blend modes
and clip masks.  The JAX package paints texture frames on its XLA
wave fold (`paint.py:969-981`); the port samples the atlas inside K3.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import consts

from ._u32 import SENTINEL, f2i32, f32_bits
from .fold_kernel import FLAG_UNCLIPPED, fold_tiles, style_layout
from .runs import _roll1, sort_units

TH = consts.TILE_HEIGHT
TW = consts.TILE_WIDTH

# virt_u flag bits (see runs.run_data / build_units).
FLAG_VIRTUAL = 1
FLAG_FULL_OPAQUE = 2
FLAG_CLIP = 4
FLAG_FULL_SOLID = 8  # full cover + solid fill: scalar-foldable
FLAG_FULL_CLIP = 16  # full-cover clip: all-pass, droppable
# FLAG_UNCLIPPED (32, from fold_kernel, which reads it): a draw whose
# governing clip was a dropped full clip.


class Features(NamedTuple):
    """Static per-frame feature set (`forma_tpu/ops/paint.py:331-338`)."""

    blend_modes: Tuple[int, ...] = (0,)
    has_gradient: bool = False
    has_texture: bool = False
    has_clip: bool = False


def style_pack_for_fold(
    features,
    st_orders, st_pidx, st_fill_rule, st_func, st_clip_n, st_is_clipped,
    st_blend, st_fill_type, st_color, st_grad, st_stops, st_tex,
):
    """Per-layer-slot style rows in the fold's feature-dependent lane
    layout (`fold_kernel.style_layout`), i32 [SL, lay.width]: one [P]-row
    matrix and one gather by pidx; clip frames then get the per-slot layer
    id and clip range end (`forma_tpu/ops/paint.py:85-141`).  Texture
    frames append the f32 bits of `st_tex` [P, 10], a group JAX's layout
    lacks (its Pallas fold never sees textures)."""
    P = st_color.shape[0]
    ms = st_stops.shape[1]
    lay = style_layout(features, ms)
    i32 = torch.int32
    cols = [f32_bits(st_color), st_fill_rule[:, None].to(i32)]
    if lay.blend >= 0:
        cols.append(st_blend[:, None].to(i32))
    if lay.ft >= 0:
        cols.append(st_fill_type[:, None].to(i32))
    if lay.func >= 0:
        cols.extend([
            st_func[:, None].to(i32),
            torch.zeros((P, 1), dtype=i32, device=st_color.device),  # layer id
            st_clip_n[:, None].to(i32),  # becomes cend below
            st_is_clipped[:, None].to(i32),
        ])
    if lay.grad >= 0:
        cols.extend([f32_bits(st_grad), f32_bits(st_stops.reshape(P, 5 * ms))])
    if lay.tex >= 0:
        cols.append(f32_bits(st_tex))
    sl = torch.cat(cols, dim=1)[st_pidx.long()]  # the one gather
    if lay.func < 0:
        return sl
    layer_id = (st_orders & consts.LAYER_LIMIT).to(i32)
    return torch.cat(
        [
            sl[:, : lay.layer],
            layer_id[:, None],
            (layer_id + sl[:, lay.cend])[:, None],
            sl[:, lay.clipped :],
        ],
        dim=1,
    )


# -- fills and blend modes (`forma_tpu/ops/paint.py:353-529`) -----------------
# Per-unit parameters are [T, 1] columns against [T, P] pixels.  Every
# expression keeps the JAX tree, and Python constants enter as f32 (as
# JAX's weak types do), so `csrc/fold.cu` can round op for op alike.


def _gradient_at(grad, stops, xg, yg):
    """grad [T, 6] = (type, sx, sy, dx, dy, dot_recip); stops [T, MS, 5].

    Stops are host-padded with (last colour, +inf), so a padded segment's
    `local_t` is NaN or inf; only the `acc ^ (t < end_stop)` mask chain
    keeps it out of the result."""
    gtype, sx, sy, gdx, gdy, dot_recip = (grad[:, i, None] for i in range(6))
    tx = (xg - sx) * gdx * dot_recip
    t_lin = (yg - sy) * gdy * dot_recip + tx
    px = xg - sx
    py = yg - sy
    t_rad = torch.sqrt((py * py + px * px) * dot_recip)
    t = torch.where(gtype == 1, t_rad, t_lin)

    ms = stops.shape[1]
    zero = torch.zeros_like(t)
    mask = t <= stops[:, 0, 4, None]
    chans = [torch.where(mask, stops[:, 0, ch, None], zero) for ch in range(4)]
    acc = mask
    for i in range(1, ms):
        start_stop = stops[:, i - 1, 4, None]
        end_stop = stops[:, i, 4, None]
        m = acc ^ (t < end_stop)
        local_t = (t - start_stop) * (1.0 / (end_stop - start_stop))
        for ch in range(4):
            sc = stops[:, i - 1, ch, None]
            ec = stops[:, i, ch, None]
            v = local_t * ec + (-local_t * sc + sc)
            chans[ch] = torch.where(m, v, chans[ch])
        acc = acc | m
    return chans


def _texture_at(tex, atlas, xg, yg):
    """tex [T, 10] = (ux, uy, vx, vy, tx, ty, max_x, max_y, ax, ay); atlas
    f32 [AH, AW, 4] linear.  f32 -> i32 converts as XLA does (`f2i32`:
    NaN -> 0, saturating), and the gather clamps its indices into the
    atlas as JAX's does (the atlas offsets are never negative)."""
    ux, uy, vx, vy, ttx, tty, max_x, max_y = (tex[:, i, None] for i in range(8))
    ax = f2i32(tex[:, 8, None]).long()
    ay = f2i32(tex[:, 9, None]).long()

    sx = xg * ux + (vx * yg + ttx)
    sy = xg * uy + (vy * yg + tty)
    # Saturating f32 -> u32: negatives clamp to zero; NaN stays NaN -> 0.
    ix = f2i32(torch.clamp(torch.trunc(torch.minimum(sx, max_x)), min=0.0)).long()
    iy = f2i32(torch.clamp(torch.trunc(torch.minimum(sy, max_y)), min=0.0)).long()
    ah, aw = atlas.shape[:2]
    texel = atlas[torch.clamp(ay + iy, 0, ah - 1), torch.clamp(ax + ix, 0, aw - 1)]
    return [texel[..., ch] for ch in range(4)]


def _lum(r, g, b):
    return r * 0.3 + (g * 0.59 + b * 0.11)


def _clip_color(r, g, b):
    lum = _lum(r, g, b)
    n = torch.minimum(r, torch.minimum(g, b))
    x = torch.maximum(r, torch.maximum(g, b))
    l_1 = lum - 1.0
    x_l_recip = 1.0 / (x - lum)
    l_n_recip_l = (1.0 / (lum - n)) * lum

    def one(ch):
        low = torch.where(n < 0.0, l_n_recip_l * (ch - lum) + lum, ch)
        high = x_l_recip * (lum * (l_1 - ch) + ch) + lum
        return torch.where(x > 1.0, high, low)

    return [one(r), one(g), one(b)]


def _set_lum(r, g, b, lum):
    d = lum - _lum(r, g, b)
    return _clip_color(r + d, g + d, b + d)


def _set_sat(sat_dst, r, g, b):
    mn = torch.minimum(r, torch.minimum(g, b))
    mx = torch.maximum(r, torch.maximum(g, b))
    mid = r + g + b - mn - mx
    lt = mn < mx
    sat_mid = torch.where(lt, (sat_dst * mid - sat_dst * mn) / (mx - mn), 0.0)
    sat_max = torch.where(lt, sat_dst, 0.0)

    def one(ch):
        return torch.where(ch == mx, sat_max, torch.where(ch == mn, 0.0, sat_mid))

    return [one(r), one(g), one(b)]


def _chroma(r, g, b):
    return torch.maximum(r, torch.maximum(g, b)) - torch.minimum(r, torch.minimum(g, b))


def _blend_one(mode, dr, dg, db, sr, sg, sb):
    """Blend mode `mode` of dst (dr, dg, db) and src (sr, sg, sb); `jnp.minimum
    (1.0, x)` is `clamp(x, max=1.0)`, NaN-propagating like it."""
    pairs = ((dr, sr), (dg, sg), (db, sb))
    if mode == 0:  # Over
        return [sr, sg, sb]
    if mode == 1:  # Multiply
        return [d * s for d, s in pairs]
    if mode == 2:  # Screen
        return [d + s - d * s for d, s in pairs]
    if mode in (3, 8):  # Overlay / HardLight
        out = []
        for d, s in pairs:
            lo = d * s * 2.0
            hi = 2.0 * (d + s - (d * s + 0.5))
            sel = d <= 0.5 if mode == 3 else s <= 0.5
            out.append(torch.where(sel, lo, hi))
        return out
    if mode == 4:  # Darken
        return [torch.minimum(d, s) for d, s in pairs]
    if mode == 5:  # Lighten
        return [torch.maximum(d, s) for d, s in pairs]
    if mode == 6:  # ColorDodge
        return [
            torch.where(s == 1.0, 1.0, torch.clamp(d / (1.0 - s), max=1.0))
            for d, s in pairs
        ]
    if mode == 7:  # ColorBurn
        return [
            torch.where(s == 0.0, 0.0, 1.0 - torch.clamp((1.0 - d) / s, max=1.0))
            for d, s in pairs
        ]
    if mode == 9:  # SoftLight
        out = []
        for d, s in pairs:
            dd = torch.where(
                d <= 0.25, ((16.0 * d - 12.0) * d + 4.0) * d, torch.sqrt(d)
            )
            lo = d * (1.0 - d) * (2.0 * s - 1.0) + d
            hi = (dd - d) * (2.0 * s - 1.0) + d
            out.append(torch.where(s <= 0.5, lo, hi))
        return out
    if mode == 10:  # Difference
        return [torch.abs(d - s) for d, s in pairs]
    if mode == 11:  # Exclusion
        return [-2.0 * d * s + d + s for d, s in pairs]
    if mode == 12:  # Hue
        r, g, b = _set_sat(_chroma(dr, dg, db), sr, sg, sb)
        return _set_lum(r, g, b, _lum(dr, dg, db))
    if mode == 13:  # Saturation
        r, g, b = _set_sat(_chroma(sr, sg, sb), dr, dg, db)
        return _set_lum(r, g, b, _lum(dr, dg, db))
    if mode == 14:  # Color
        return _set_lum(sr, sg, sb, _lum(dr, dg, db))
    if mode == 15:  # Luminosity
        return _set_lum(dr, dg, db, _lum(sr, sg, sb))
    raise ValueError(mode)


def _blend(blend_code, modes, dr, dg, db, sr, sg, sb):
    """The select tree over the frame's modes; blend_code [T, 1] i32."""
    blended = [sr, sg, sb]
    for mode in modes:
        if mode == 0:
            continue
        res = _blend_one(mode, dr, dg, db, sr, sg, sb)
        sel = blend_code == mode
        blended = [torch.where(sel, r, o) for r, o in zip(res, blended)]
    return blended


# -- unit passes ----------------------------------------------------------------


def _seg_cummax(gid, values):
    """Segmented prefix max of non-negative `values` within equal-gid
    groups (gid nondecreasing): one cummax over gid-major packed keys."""
    key = gid.long() << 32
    return torch.cummax(key | values.long(), 0).values - key


def _seg_last(gid, valid):
    """Per position, the index of the most recent `valid` position in its
    gid group, or -1: the segmented forward fill of positions
    (`forma_tpu/ops/paint.py:535-548`, `_seg_ffill` of an iota); a gather
    by it fills any other value."""
    iota1 = torch.arange(1, gid.shape[0] + 1, device=gid.device)
    return _seg_cummax(gid, torch.where(valid, iota1, 0)) - 1


def cull_units_keep(key_u, virt_u, k_u, u_valid):
    """Occlusion-pass analysis (`skip_fully_covered_layers.rs:27-119`):
    keeps every unit at or above the topmost full-cover opaque unit of its
    tile; tiles containing a clip unit keep everything."""
    new_tile = key_u != _roll1(key_u)
    new_tile[:1].fill_(True)
    full_opaque = ((virt_u & FLAG_FULL_OPAQUE) != 0) & u_valid
    is_clip = ((virt_u & FLAG_CLIP) != 0) & u_valid

    def rev(x):
        return torch.flip(x, (0,))

    # Reverse-segmented cummax of (full_opaque ? k+1 : 0): for each unit,
    # the highest full-opaque slot at or after it within its tile.
    tail_new = torch.roll(new_tile, -1, 0)
    tail_new[-1:].fill_(True)  # last of each group
    gid_r = torch.cumsum(rev(tail_new), 0)
    fo_k1 = torch.where(full_opaque, k_u.long() + 1, 0)
    k_top1 = rev(_seg_cummax(gid_r, rev(fo_k1)))

    gid_f = torch.cumsum(new_tile, 0)
    clip_v = is_clip.long()
    clip_fwd = _seg_cummax(gid_f, clip_v)
    clip_rev = rev(_seg_cummax(gid_r, rev(clip_v)))
    tile_has_clip = (clip_fwd | clip_rev) > 0

    return u_valid & ((k_u.long() + 1 >= k_top1) | tile_has_clip)


def skip_trivial_clips_keep(key_u, virt_u, u_valid, id_u, cend_u, clipped_u):
    """`skip_trivial_clips_pass` analysis (`passes/skip_trivial_clips.rs:
    27-112`, `forma_tpu/ops/paint.py:569-611`): clipped draws outside any
    active clip range drop; clip units no clipped draw references drop;
    full-cover clips drop too and the draws they govern get FLAG_UNCLIPPED.
    Returns (keep, virt_u with FLAG_UNCLIPPED); the caller renumbers once,
    together with the occlusion pass.

    id_u / cend_u: layer id and clip range end per unit; clipped_u: the
    unit is a clipped draw."""
    n = key_u.shape[0]
    is_clip = ((virt_u & FLAG_CLIP) != 0) & u_valid
    full_clip = is_clip & ((virt_u & FLAG_FULL_CLIP) != 0)

    new_tile = key_u != _roll1(key_u)
    new_tile[:1].fill_(True)
    gid = torch.cumsum(new_tile, 0)

    # One forward fill of the last clip's position; gathers by it replace
    # JAX's two other forward fills.
    last_clip_pos = _seg_last(gid, is_clip)
    pos = last_clip_pos.clamp(min=0)
    has_clip = last_clip_pos >= 0
    last_clip_end = torch.where(has_clip, cend_u[pos], -1)
    last_clip_full = has_clip & full_clip[pos]

    orphan = clipped_u & u_valid & (~has_clip | (id_u > last_clip_end))
    governed = clipped_u & u_valid & ~orphan
    gov_by_full = governed & last_clip_full
    virt_u = virt_u | torch.where(gov_by_full, FLAG_UNCLIPPED, 0).to(virt_u.dtype)

    used = torch.zeros(n + 1, dtype=torch.int32, device=key_u.device)
    used.scatter_reduce_(
        0, torch.where(governed & ~gov_by_full, last_clip_pos, n),
        torch.ones(n, dtype=torch.int32, device=key_u.device), reduce="amax",
    )
    unused_clip = is_clip & (used[:n] == 0)

    keep = u_valid & ~(orphan | unused_clip | full_clip)
    return keep, virt_u


def _renumber_units(key_u, layer_u, src_u, src2_u, virt_u, keep):
    """Drops units where ~keep, re-sorts, recomputes per-tile slots."""
    key2 = torch.where(keep, key_u, torch.full_like(key_u, SENTINEL))
    return sort_units(key2, layer_u, src_u, src2_u, virt_u)


def paint(
    key_u,  # int64 [U] (u32 values) unit (tile) keys, (tile, layer)-sorted
    u_valid,  # bool [U]
    src_u,  # i32 [U] run index per unit (run order: the grid row)
    src2_u,  # i32 [U] run index per unit (carry-chain order: carry, style, tx)
    virt_u,  # i32 [U] FLAG_* bits per unit (FLAG_UNCLIPPED read by clip frames)
    grid,  # i32 [R, 256] packed area|cover
    carry_in_s,  # i32 [R, 16]
    carry_after_s,  # i32 [R, 16]
    style_s,  # i32 [R, W] per-run style rows (style_layout(features, ms))
    tx_s,  # i32 [R] per-run tile x
    clear,  # f32 [4]
    rows: int,
    tiles_x: int,
    k_slots: int,
    features: Features,
    ms: int,  # gradient stop capacity
    atlas=None,  # f32 [AH, AW, 4] linear texture atlas (texture frames)
    plain: bool = False,
    taps=None,
    row_lo=0,  # global tile row of tile row 0 (a row-span crop)
    tile_skip=None,  # bool [T]: tiles to skip (damage cache / crop)
):
    """Returns the painted frame as linear f32 [rows*16, tiles_x*16, 4];
    skipped tiles stay at the clear colour, and the caller re-emits their
    previous pixels."""
    frame_t = fold_tiles(
        key_u, u_valid, src_u, src2_u, virt_u, grid, carry_in_s, carry_after_s,
        tx_s, style_s, clear, rows, tiles_x, k_slots, features, ms, atlas,
        plain=plain, taps=taps, row_lo=row_lo, tile_skip=tile_skip,
    )
    frame = frame_t.reshape(rows, tiles_x, TH, TW, 4)
    return frame.permute(0, 2, 1, 3, 4).reshape(rows * TH, tiles_x * TW, 4)
