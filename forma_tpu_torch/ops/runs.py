"""Run extraction, cover-carry chains and paint-unit expansion.

Counterpart of `forma_tpu/ops/runs.py:100-433`.  The reference's
sequential tile walk with per-layer carried covers
(`painter/mod.rs:486-568`) becomes three data-parallel steps over the
sorted segments:

1. Runs: (tile_y, tile_x, layer) groups; their areas and covers sum into
   per-run 16x16 packed grids (K2, `grid_kernel.grid_build`), which also
   emits each run's keys.
2. Carry chains: a segmented prefix sum of the cover row sums over runs in
   (row, layer, tile_x) order gives every run's carry-in.  After the
   packed-key sort the runs already arrive in that order
   (`presorted=True`); after the two-key sort they arrive in (row, tile_x,
   layer) order and one int64 sort re-orders them, its inverse
   permutation taking each run to its place there.
3. Virtual units: tiles a layer fully covers between two of its runs paint
   from the carry alone (`layer_workbench/mod.rs:196-234`).
"""

from __future__ import annotations

import torch

from .. import consts

from ._u32 import MASK32, SENTINEL
from .grid_kernel import grid_build, grid_build_torch
from .rasterize import TWO_KEY_SENTINEL, TX_BITS, unpack_payload

TW = consts.TILE_WIDTH
LAYER_MASK = consts.LAYER_LIMIT


def _roll1(x: torch.Tensor) -> torch.Tensor:
    """jnp.roll(x, 1): previous element, wrapping."""
    return torch.roll(x, 1, 0)


def extract_runs(key_hi, key_lo):
    """Per-segment run ids over the sorted keys; returns (run_id i64,
    num_runs (0-d, incl. the sentinel run), new_run bool)."""
    new_run = (key_hi != _roll1(key_hi)) | (key_lo != _roll1(key_lo))
    new_run[:1].fill_(True)
    run_id = torch.cumsum(new_run, 0) - 1
    return run_id, run_id[-1] + 1, new_run


def _first_of_group(new_group: torch.Tensor) -> torch.Tensor:
    iota = torch.arange(new_group.shape[0], device=new_group.device)
    return torch.cummax(torch.where(new_group, iota, 0), 0).values


def run_data(
    key_hi, key_lo, payload, run_id, new_run, num_runs,
    st_pidx,  # i32 [SL] layer slot -> distinct-props row
    st_fill_rule,  # i32 [P]
    st_opaque,  # bool [P] solid, alpha 1, Over, draw, not clipped
    st_isclip,  # bool [P]
    st_solid,  # bool [P] solid-fill draw, not clipped
    run_cap: int,
    tiles_x: int,
    style_pack,  # i32 [SL, SW] per-slot style rows (paint.style_pack_for_fold)
    presorted: bool = False,  # segments sorted by the packed [row|slot|tx] key
    plain: bool = False,  # K2's plain PyTorch version on any device
    taps=None,  # dict: receives K2's inputs, and the stage's under "run_data"
):
    """Per-run grids and carry chains.  Returns a dict of per-run arrays:
    `run_hi`, `run_layer`, `r_valid`, `real_flags` and `grid` in run order,
    `inv` (run -> its position in carry-chain order), and the rest in
    carry-chain (row, layer, tile_x) order.

    `presorted`: runs already arrive in carry-chain order (the packed-key
    sort), so that order IS the run order and `inv` the identity.
    Otherwise (the two-key sort) the runs sort by the int64 key `key2 <<
    TX_BITS | txb` (`forma_tpu/ops/runs.py:235-249`), invalid runs last
    under `TWO_KEY_SENTINEL`; the valid keys are unique, so the unstable
    sort gives JAX's permutation on every valid run."""
    dev = key_hi.device
    if taps is not None:
        taps["run_data"] = (key_hi, key_lo, payload, run_id, new_run, num_runs, st_pidx,
                            st_fill_rule, st_opaque, st_isclip, st_solid, run_cap,
                            tiles_x, style_pack)
    lx, ly, area, cover = unpack_payload(payload)
    rid = torch.clamp(run_id, max=run_cap - 1).to(torch.int32)
    cell = ly * TW + lx
    args = (
        rid, cell.to(torch.int32), area, cover,
        key_hi.contiguous(), key_lo.contiguous(), run_cap,
    )
    if taps is not None:
        taps["grid"] = args
    grid, rowcov, runkeys = (grid_build_torch if plain else grid_build)(*args)

    r = torch.arange(run_cap, device=dev)
    run_hi = runkeys[:, 0]
    run_layer = runkeys[:, 1]
    r_valid = (r < num_runs) & (run_hi != SENTINEL)
    sentinel = torch.full_like(run_hi, SENTINEL)
    run_hi = torch.where(r_valid, run_hi, sentinel)

    rowb = run_hi >> TX_BITS  # biased row + 1
    txb = run_hi & ((1 << TX_BITS) - 1)  # biased tile_x + 1
    key2 = torch.where(r_valid, ((rowb << 21) | run_layer) & MASK32, sentinel)
    txb_key = torch.where(r_valid, txb, sentinel)
    if presorted:
        key2_s, txb_s, rowcov_s = key2, txb_key, rowcov.long()
        inv = r.to(torch.int32)
    else:
        # key2 < 2^32 and txb < 2^TX_BITS: the pair fits 45 bits.
        key = torch.where(r_valid, (key2 << TX_BITS) | txb,
                          torch.full_like(key2, TWO_KEY_SENTINEL))
        orig = torch.sort(key, stable=False).indices
        key2_s, txb_s = key2[orig], txb_key[orig]
        inv = torch.empty(run_cap, dtype=torch.int32, device=dev)
        inv[orig] = r.to(torch.int32)  # the inverse permutation
        rowcov_s = rowcov[orig].long()

    new_group = key2_s != _roll1(key2_s)
    new_group[:1].fill_(True)
    # Scanned along the innermost dim: PyTorch's CUDA scan over the outer
    # dim of an [R, 16] tensor runs ~16 threads wide (113 ms at paris
    # scale on the H100, against well under a millisecond transposed).
    cum = torch.cumsum(rowcov_s.t().contiguous(), 1).t()
    excl = cum - rowcov_s
    gfirst = _first_of_group(new_group)
    carry_in_s = excl - excl[gfirst]
    carry_after_s = carry_in_s + rowcov_s

    valid_s = key2_s != SENTINEL
    tx_s = (txb_s - 1).to(torch.int32)  # wraps the sentinel like the u32 cast
    next_same = torch.roll(key2_s, -1, 0) == key2_s
    next_same[-1:].fill_(False)
    tx_next = torch.roll(tx_s, -1, 0)
    span = torch.where(next_same, tx_next - tx_s - 1, (tiles_x - 1) - tx_s)
    span = torch.clamp(span, min=0)

    # A gap only paints if the carry is non-empty under the layer's fill
    # rule (`painter/mod.rs:187-198`); per-run style bits arrive with the
    # fold's style row in ONE gather by slot.
    slot_s = torch.clamp(key2_s & LAYER_MASK, max=st_pidx.shape[0] - 1)
    sl_flags = (
        st_fill_rule[st_pidx]
        | (st_isclip[st_pidx].to(torch.int32) << 1)
        | (st_opaque[st_pidx].to(torch.int32) << 2)
        | (st_solid[st_pidx].to(torch.int32) << 3)
    )
    packed_s = torch.cat([sl_flags[:, None], style_pack], dim=1)[slot_s]
    f_s = packed_s[:, 0]
    style_s = packed_s[:, 1:].contiguous()
    fr_eo = (f_s & 1) == 1
    isclip_s = (f_s & 2) != 0
    opaque_s = (f_s & 4) != 0
    solid_s = (f_s & 8) != 0
    empty_nz = (carry_after_s == 0).all(dim=1)
    empty_eo = ((carry_after_s.abs() & 31) == 0).all(dim=1)
    empty = torch.where(fr_eo, empty_eo, empty_nz)
    span = torch.where(valid_s & ~empty, span, torch.zeros_like(span))
    cumspan = torch.cumsum(span, 0)

    # Unit flags for the occlusion pass (`skip_fully_covered_layers.rs`,
    # `Cover::is_full`, `painter/mod.rs:200-214`).
    ac = carry_after_s.abs()
    full_nz = (ac == consts.PIXEL_WIDTH).all(dim=1)
    full_eo = ((ac & 31) == consts.PIXEL_WIDTH).all(dim=1)
    full_s = torch.where(fr_eo, full_eo, full_nz)
    gap_flags_s = (
        (full_s & opaque_s).to(torch.int32) * 2  # FLAG_FULL_OPAQUE
        | isclip_s.to(torch.int32) * 4  # FLAG_CLIP
        | (full_s & solid_s).to(torch.int32) * 8  # FLAG_FULL_SOLID
        | (full_s & isclip_s).to(torch.int32) * 16  # FLAG_FULL_CLIP
    )
    real_flags = isclip_s.to(torch.int32) * 4
    if not presorted:
        real_flags = torch.empty_like(real_flags).index_copy_(0, orig, real_flags)

    return dict(
        run_hi=run_hi,
        run_layer=run_layer,
        r_valid=r_valid,
        real_flags=real_flags,
        grid=grid,
        style_s=style_s,
        inv=inv,
        key2_s=key2_s,
        tx_s=tx_s,
        carry_in_s=carry_in_s.to(torch.int32),
        carry_after_s=carry_after_s.to(torch.int32),
        gap_flags_s=gap_flags_s,
        span=span,
        cumspan=cumspan,
        v_total=cumspan[-1],
    )


def build_units(
    run_hi, run_layer, r_valid, real_flags, inv, key2_s, tx_s, gap_flags_s,
    span, cumspan, v_total, v_cap: int,
):
    """Merges real runs and virtual (gap) units into one (tile, layer)
    order.  Returns (key_u, layer_u, src_u, src2_u, virt_u, k_u, u_valid,
    k_needed); keys are int64 holding u32 values."""
    run_cap = run_hi.shape[0]
    dev = run_hi.device

    # Real paint units: runs in painted tiles (biased tile_x > 0).
    txb = run_hi & ((1 << TX_BITS) - 1)
    real_key = torch.where(r_valid & (txb > 0), run_hi, torch.full_like(run_hi, SENTINEL))
    real_src = torch.arange(run_cap, dtype=torch.int32, device=dev)

    # Virtual units: scatter each gap run's start into the gap index
    # space; a prefix max recovers the owner.
    vj = torch.arange(v_cap, dtype=torch.int64, device=dev)
    v_valid = vj < v_total
    starts = cumspan - span  # exclusive
    sidx = torch.arange(run_cap, dtype=torch.int64, device=dev)
    start_pos = torch.where((span > 0) & (starts < v_cap), starts, v_cap)
    owner = torch.zeros(v_cap + 1, dtype=torch.int64, device=dev)
    owner.scatter_reduce_(0, start_pos, sidx, reduce="amax")
    owner = torch.cummax(owner[:v_cap], 0).values
    off = vj - starts[owner]
    v_tx = tx_s[owner].long() + 1 + off
    v_flags = gap_flags_s[owner] | 1  # FLAG_VIRTUAL
    v_key2 = key2_s[owner]
    v_rowb = v_key2 >> 21
    v_layer = v_key2 & LAYER_MASK
    v_key = torch.where(
        v_valid,
        ((v_rowb << TX_BITS) | ((v_tx + 1) & MASK32)) & MASK32,
        torch.full_like(v_key2, SENTINEL),
    )

    key_u = torch.cat([real_key, v_key])
    layer_u = torch.cat([run_layer, v_layer])
    src_u = torch.cat([real_src, owner.to(torch.int32)])
    src2_u = torch.cat([inv, owner.to(torch.int32)])
    virt_u = torch.cat([real_flags, v_flags])
    return sort_units(key_u, layer_u, src_u, src2_u, virt_u)


def sort_units(key_u, layer_u, src_u, src2_u, virt_u):
    """Sorts units by (key, layer) and numbers each unit's slot k within
    its tile.  (key, layer) pairs are unique per valid unit, so the sort
    may be unstable; key < 2^32 and layer < 2^21 pack into one int64."""
    _, order = torch.sort((key_u << 21) | (layer_u & LAYER_MASK), stable=False)
    key_u = key_u[order]
    layer_u = layer_u[order]
    src_u = src_u[order]
    src2_u = src2_u[order]
    virt_u = virt_u[order]
    new_tile = key_u != _roll1(key_u)
    new_tile[:1].fill_(True)
    first = _first_of_group(new_tile)
    k = (torch.arange(key_u.shape[0], device=key_u.device) - first).to(torch.int32)
    u_valid = key_u != SENTINEL
    k_needed = torch.where(u_valid, k, -1).max() + 1
    return key_u, layer_u, src_u, src2_u, virt_u, k, u_valid, k_needed
