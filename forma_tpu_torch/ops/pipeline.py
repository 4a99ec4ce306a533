"""The single-device frame pipeline.

Counterpart of `forma_tpu/ops/pipeline.py:34-382,569-587`: `render_frame`
runs every stage (line setup, virtual-line expansion, rasterize, sort,
runs, carries, units, occlusion culling, paint, sRGB) with static
capacity buckets, and returns the packed frame with a small diagnostics
vector (actual totals vs capacities); the renderer reads both once and
re-renders with bigger buckets on overflow.  `render_frame_cached` is the
damage-cached frame: unchanged tiles re-emit the previous frame's pixels
and the changed tiles come back compacted for a small readback.

Every frame takes either sort key: the packed single key (`slot_bits >
0`) and, where [row | slot | tx] passes 31 bits, the two-key route
(`slot_bits == 0`: K1 and the emit in PyTorch, the int64 two-key sort,
the runs re-sorted into carry-chain order, and K3 reading each unit's
grid row by `src_u`), as the JAX package routes them
(`forma_tpu/ops/pipeline.py:98-110,123,147`).  A row-span crop renders
tile rows [row_lo, row_lo + rows): the rasterizer shifts them to the
frame's rows, and K3 evaluates fills at the global rows.

`row_lo`, the crop bounds (`crop_x`, `crop_y`) and `cache_ok` may each
be a Python value or an int32 0-d tensor on the frame's device, as JAX
traces them: K4 and K3 read `row_lo` in device memory, the crop masks
compare elementwise and `cache_ok` masks the unchanged tiles, so one CUDA
graph of a frame (`forma_tpu_torch.graphs`) serves every row span, crop
rectangle and cache state.  The statics (sizes, caps, features,
channels, expand, and whether a crop is given) are Python values.

`render_frame_sharded` and `render_frame_sharded_lines` are the two
multi-device frames over a `mesh.Mesh` (`forma_tpu/ops/pipeline.py:
377-566`), in the JAX package's single-controller form: one call drives
every shard on its device, in pieces of one call a card (`row_shards`;
`line_front`, then the exchange, then `line_back`).  Nothing here reads
a device value on the host (`tests/test_torch_graphs.py` and
`tests/test_torch_sharded.py` hold the frames to it): that is what lets a
frame, or one card's piece of it, be captured as a CUDA graph.

`render_frame` and `render_frame_cached` stamp their stage boundaries
(`tracing.marker`: on a card, nodes of the captured graph), unless
`plain`; the sharded frames stamp nothing.  On the two-key route the
stamps split the work: `expand` (K1), `emit` (the two-key emit) and
`key_sort` (the int64 sort and its unpack) in place of `rasterize_sort`,
and `carry_sort` (`run_data`'s re-sort of the runs) out of `runs`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import consts, tracing
from . import line_setup as _ls
from . import paint as _paint
from . import rasterize as _raster
from . import runs as _runs
from . import srgb as _srgb
from ._u32 import from_numpy
from .paint import Features
from .rasterize_kernel import PACKED_SENTINEL, ZERO_PAYLOAD

K_SEG = 8  # pixel segments per virtual line


class Caps(NamedTuple):
    """Static capacity buckets for one pipeline configuration."""

    vline: int = 512  # virtual lines (each up to K_SEG pixel segments)
    run: int = 512
    virt: int = 512
    k: int = 4


# Indices into the diagnostics vector.  DIAG_DMG (the number of changed
# tiles) is meaningful only for cached frames; it reads 0 elsewhere.
DIAG_VLINES, DIAG_RUNS, DIAG_VIRT, DIAG_K, DIAG_SEGS, DIAG_DMG = range(6)
# The line-sharded frame's two more entries: the largest block one shard
# addressed to one destination (against the exchange capacity `xcap`), and
# the most segments one shard received (the back half's share of the
# work: ideally the frame's segments over the mesh size).
DIAG_XPAIR, DIAG_XRECV = 6, 7

# Static capacity of the compact damaged-tile readback (bytes per cached
# frame at most DMG_CAP * TILE_HEIGHT * TILE_WIDTH * C).  Not a growth
# bucket: a frame with more damage falls back to a whole-frame readback.
DMG_CAP = 1024


def _unit_tiles(key_u, u_valid, tiles_x: int, n_tiles: int):
    """Each unit's tile index (frame rows), n_tiles for invalid units: the
    key arithmetic of `fold_kernel.tile_spans`."""
    rowb = (key_u >> _raster.TX_BITS) - 1
    txu = (key_u & ((1 << _raster.TX_BITS) - 1)) - 1
    return torch.where(u_valid, rowb * tiles_x + txu, n_tiles)


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
    row_lo=0, cache=None, crop_x=None, crop_y=None,
    expand: str = "fused", plain: bool = False, taps=None,
    stamps: bool = False,  # stamp the stage boundaries (`tracing.marker`)
):
    stamp = tracing.marker(px.device, stamps)
    stamp()
    params, slots, lengths, vline_ends = _ls.line_setup(
        px, py, line_slot, g_slot, g_valid, g_t, g_has_t, width, height,
        k_seg=K_SEG,
    )
    v_total = vline_ends[-1]
    total_segs = lengths.sum(dtype=torch.int64)
    stamp("line_setup")

    slot_bits = slot_bits_for(st["orders"].shape[0], rows, tiles_x)
    key_hi, key_lo, payload = _raster.rasterize_sort(
        params, slots, lengths, vline_ends,
        torch.clamp(v_total, max=caps.vline),
        caps.vline, K_SEG, rows, tiles_x, row_lo,
        slot_bits=slot_bits, expand=expand, plain=plain, taps=taps, stamp=stamp,
    )
    if slot_bits > 0:  # the two-key route stamped its own stages
        stamp("rasterize_sort")
    return _back(
        key_hi, key_lo, payload, v_total, total_segs,
        st, clear, rows, tiles_x, caps, features, channels,
        row_lo=row_lo, cache=cache, crop_x=crop_x, crop_y=crop_y,
        presorted=slot_bits > 0, plain=plain, taps=taps, stamp=stamp,
    )


def _back(
    key_hi, key_lo, payload,  # sorted segment stream
    v_total, total_segs,  # diagnostics scalars from the front half
    st, clear, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels,
    row_lo=0,  # global tile row of the frame's tile row 0
    cache=None,  # (prev_frame u8, prev_counts i32 [T], st_unchanged bool [SL], cache_ok)
    crop_x=None,  # (tile_x_lo, tile_x_hi): tiles outside paint nothing
    crop_y=None,  # (tile_row_lo, tile_row_hi): rows outside paint nothing
    presorted: bool = False,  # sorted by the packed key: runs arrive in
    #                           carry-chain order, and src_u == src2_u
    plain: bool = False, taps=None,
    stamp=tracing.no_mark,  # `_core`'s stage stamps (`tracing.marker`)
):
    """Everything after the segment sort: runs, carries, units, the
    occlusion pass, paint, sRGB; with `cache`, the tile-unchanged test,
    the re-emit of the previous frame and the damaged-tile compaction
    (`forma_tpu/ops/pipeline.py:113-316`)."""
    if taps is not None:
        taps["scan"] = []  # this frame's scans, in call order
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
        presorted=presorted, plain=plain, taps=taps, stamp=stamp,
    )
    stamp("runs")

    key_u, layer_u, src_u, src2_u, virt_u, k_u, u_valid, _ = (
        _runs.build_units(
            rd["run_hi"], rd["run_layer"], rd["r_valid"], rd["real_flags"],
            rd["inv"], rd["key2_s"], rd["tx_s"], rd["gap_flags_s"],
            rd["span"], rd["cumspan"],
            torch.clamp(rd["v_total"], max=caps.virt),
            caps.virt, plain=plain, taps=taps,
        )
    )
    stamp("units")

    n_tiles = rows * tiles_x
    dev = key_u.device
    counts = tile_unch = None
    if cache is not None:
        # tile_unchanged (`passes/tile_unchanged.rs:24-57`): a tile whose
        # unit count matches the cached count and whose every layer is
        # unchanged re-emits the previous frame's pixels.  Counts are
        # taken before the cull, so they do not depend on its decisions.
        prev_frame, prev_counts, st_unchanged, cache_ok = cache
        tile_of = _unit_tiles(key_u, u_valid, tiles_x, n_tiles)
        counts = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
        counts.index_add_(0, tile_of, torch.ones_like(tile_of, dtype=torch.int32))
        counts = counts[:n_tiles]
        slot_u = torch.clamp(layer_u.long(), max=st["orders"].shape[0] - 1)
        unch_u = torch.where(u_valid, st_unchanged[slot_u].to(torch.int32), 1)
        all_unch = torch.ones(n_tiles + 1, dtype=torch.int32, device=dev)
        all_unch.scatter_reduce_(0, tile_of, unch_u, reduce="amin")
        tile_unch = (counts == prev_counts) & (all_unch[:n_tiles] == 1)
        tile_unch = tile_unch & (cache_ok != 0)

    # Layer-workbench passes fused into one keep mask + ONE unit re-sort;
    # the occlusion analysis may run on the pre-clip-pass list
    # (`forma_tpu/ops/paint.py:644-650`).
    keep = _paint.cull_units_keep(key_u, virt_u, k_u, u_valid, plain=plain, taps=taps)
    if features.has_clip:
        # Trivial-clip elimination (`passes/skip_trivial_clips.rs`).
        slot_u = torch.clamp(layer_u.long(), max=st["orders"].shape[0] - 1)
        pi_u = st["pidx"][slot_u].long()
        id_u = st["orders"][slot_u] & consts.LAYER_LIMIT
        cend_u = id_u + st["clip_n"][pi_u]
        clipped_u = st["is_clipped"][pi_u] & (st["func"][pi_u] == 0)
        keep_c, virt_u = _paint.skip_trivial_clips_keep(
            key_u, virt_u, u_valid, id_u, cend_u, clipped_u, plain=plain, taps=taps
        )
        keep &= keep_c
    key_u, layer_u, src_u, src2_u, virt_u, k_u, u_valid, k_needed = (
        _paint._renumber_units(key_u, layer_u, src_u, src2_u, virt_u, keep,
                               plain=plain, taps=taps)
    )

    tile_skip = tile_unch
    out_of_crop = None
    if crop_x is not None or crop_y is not None:
        # Tiles outside the crop never paint (`cpu/renderer.rs:38-53`);
        # covers still carry, since carries come from the run chains.
        t = torch.arange(n_tiles, device=dev)
        out_of_crop = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
        if crop_x is not None:
            tx_t = t % tiles_x
            out_of_crop |= (tx_t < crop_x[0]) | (tx_t >= crop_x[1])
        if crop_y is not None:
            row_t = t // tiles_x
            out_of_crop |= (row_t < crop_y[0]) | (row_t >= crop_y[1])
        tile_skip = out_of_crop if tile_skip is None else tile_skip | out_of_crop

    if tile_skip is not None:
        # The fold depth the painted tiles need.
        kmax_t = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
        kmax_t.scatter_reduce_(
            0, _unit_tiles(key_u, u_valid, tiles_x, n_tiles), k_u.long() + 1,
            reduce="amax",
        )
        k_needed = torch.where(tile_skip, 0, kmax_t[:n_tiles]).max()
    stamp("cull")

    # Presorted, src_u == src2_u: passing src2_u for both keeps the fold
    # in table mode, one index load per unit.
    frame = _paint.paint(
        key_u, u_valid, src2_u if presorted else src_u, src2_u, virt_u,
        rd["grid"], rd["carry_in_s"],
        rd["carry_after_s"], rd["style_s"], rd["tx_s"], clear,
        rows, tiles_x, caps.k, features, st["stops"].shape[1], st["atlas"],
        plain=plain, taps=taps, row_lo=row_lo, tile_skip=tile_skip,
    )
    stamp("paint")
    packed = _srgb.pack_srgb(frame, channels)

    n_dmg = torch.zeros((), dtype=torch.int64, device=dev)
    dmg = None
    if cache is not None:
        stamp("srgb")
        # Unchanged and out-of-crop tiles re-emit the previous frame's
        # pixels, so the frame returned is the next cache state.
        reemit = tile_unch if out_of_crop is None else tile_unch | out_of_crop
        pix = reemit.reshape(rows, 1, tiles_x, 1).expand(
            rows, consts.TILE_HEIGHT, tiles_x, consts.TILE_WIDTH
        ).reshape(rows * consts.TILE_HEIGHT, tiles_x * consts.TILE_WIDTH, 1)
        packed = torch.where(pix, prev_frame, packed)

        # Damage-aware readback: the changed tiles, compacted, so the host
        # reads kilobytes, not the frame (the transfer side of the
        # reference's TileWriteOp::None).  Past DMG_CAP tiles the caller
        # reads the whole frame instead.
        changed = ~reemit
        n_dmg = changed.sum(dtype=torch.int64)
        pos = torch.cumsum(changed, 0) - 1
        tgt = torch.where(changed & (pos < DMG_CAP), pos, DMG_CAP)
        dmg_idx = torch.full((DMG_CAP + 1,), n_tiles, dtype=torch.int32, device=dev)
        dmg_idx.scatter_(0, tgt, torch.arange(n_tiles, dtype=torch.int32, device=dev))
        dmg_idx = dmg_idx[:DMG_CAP]
        tiles8 = (
            packed.reshape(rows, consts.TILE_HEIGHT, tiles_x, -1)
            .permute(0, 2, 1, 3)
            .reshape(n_tiles, consts.TILE_HEIGHT, -1)
        )
        dmg_tiles = tiles8[torch.clamp(dmg_idx.long(), max=n_tiles - 1)]
        dmg = (dmg_idx, dmg_tiles)

    diag = torch.stack(
        [
            v_total.long(),
            num_runs.long(),
            rd["v_total"].long(),
            k_needed.long(),
            total_segs.long(),
            n_dmg,
        ]
    )
    stamp("srgb" if cache is None else "damage", last=True)
    if cache is not None:
        return packed, diag, counts, dmg
    return packed, diag


def render_frame(
    px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
    width: int, height: int, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels,
    row_lo=0,  # first tile row to render (a row-span crop): int or int32 0-d tensor
    crop_x=None,  # (tile_x_lo, tile_x_hi): tile columns to paint, ints or 0-d tensors
    expand: str = "fused",  # "fused" (K4) or "split" (K1 + PyTorch emit)
    plain: bool = False,  # run every kernel's plain PyTorch version
    taps=None,  # dict: receives each kernel's input tuple when given
):
    """Single-device render of tile rows [row_lo, row_lo + rows); returns
    (u8 frame [rows*16, tiles_x*16, C], int64 [6] diagnostics).  Unless
    `plain`, the stages stamp their boundaries (`tracing`)."""
    return _core(
        px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
        width, height, rows, tiles_x, caps, features, channels,
        row_lo=row_lo, crop_x=crop_x, expand=expand, plain=plain, taps=taps,
        stamps=not plain,
    )


def render_frame_cached(
    px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
    prev_frame, prev_counts, st_unchanged,
    cache_ok,  # bool or int32 0-d tensor: False marks every tile changed
    width: int, height: int, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels,
    crop_x=None,  # (tile_x_lo, tile_x_hi): paint crop, default full; ints or 0-d tensors
    crop_y=None,  # (tile_row_lo, tile_row_hi): paint crop, default full; the same
    expand: str = "fused", plain: bool = False, taps=None,
):
    """Damage-aware render: unchanged tiles re-emit `prev_frame` pixels and
    add nothing to the fold depth; with a crop, out-of-crop tiles re-emit
    them too.  Returns (u8 frame, diag, per-tile unit counts i32 [T] to
    keep for the next frame, (dmg_idx i32 [DMG_CAP], dmg_tiles u8
    [DMG_CAP, TILE_HEIGHT, TILE_WIDTH * C])): the first diag[DIAG_DMG]
    entries are the changed tiles' indices and pixels.  `cache_ok` False
    (no usable previous frame, a bool or an int32 0-d tensor) marks every
    tile changed.  Unless `plain`, the stages stamp their boundaries
    (`tracing`), the damaged tiles' compaction as `damage`."""
    return _core(
        px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
        width, height, rows, tiles_x, caps, features, channels,
        cache=(prev_frame, prev_counts, st_unchanged, cache_ok),
        crop_x=crop_x, crop_y=crop_y, expand=expand, plain=plain, taps=taps,
        stamps=not plain,
    )


def _shard_taps(taps, i: int):
    """Shard i's own taps dict inside `taps` (keyed by shard index)."""
    return None if taps is None else taps.setdefault(i, {})


def _per_card(mesh, run, fn, args, kwargs) -> list:
    """Calls `run(fn, device, args(shards), kwargs + shards)` once for each
    card of `mesh`, `shards` the indices of the card's shards; `fn`
    returns one result a shard.  Returns the results in shard order."""
    out = [None] * mesh.size
    for dev, shards in mesh.cards():
        for i, r in zip(shards, run(fn, dev, args(shards), dict(kwargs, shards=shards))):
            out[i] = r
    return out


def row_shards(
    px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
    width: int, height: int, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels,
    shards: tuple, expand: str = "fused", plain: bool = False, taps=None,
):
    """Row shards `shards` of `render_frame_sharded`, all on the inputs'
    device: shard i runs the whole `_core` on tile rows [i * rows, (i + 1)
    * rows).  Returns one (u8 frame, int64 [6] diag) a shard."""
    return tuple(
        _core(
            px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
            width, height, rows, tiles_x, caps, features, channels,
            row_lo=i * rows, expand=expand, plain=plain, taps=_shard_taps(taps, i),
        )
        for i in shards
    )


def render_frame_sharded(
    px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear,
    width: int, height: int, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels, mesh,
    expand: str = "fused", plain: bool = False, taps=None, run=None,
):
    """Framebuffer-sharded render over `mesh` (`forma_tpu/ops/pipeline.py:
    377-417`): every input replicates to every shard's device, and shard i
    runs the whole `_core` on tile rows [i * rows, (i + 1) * rows); the
    rasterizer drops the segments outside them.  `rows` is the padded
    per-shard tile-row count (the frame's rows over the mesh size, rounded
    up).  Returns (the shards' u8 frames [rows*16, tiles_x*16, C], each on
    its device; the int64 [6] diagnostics, their elementwise maximum over
    the shards, on shard 0's device).  `torch.cat` of the frames (on one
    device) is the JAX package's frame: its first `height` rows are the
    image.  `taps` (a dict) receives each shard's kernel inputs under the
    shard's index.

    Each card's shards run in one call of `row_shards` through
    `run(fn, device, args, kwargs)`: by default `mesh.run`, eagerly on the
    card; the renderer passes one that replays the card's CUDA graph of
    that call, where the shards lie on several cards."""
    out = _per_card(
        mesh, run or mesh.run, row_shards,
        lambda _: (px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear),
        dict(width=width, height=height, rows=rows, tiles_x=tiles_x, caps=caps,
             features=features, channels=channels, expand=expand, plain=plain, taps=taps),
    )
    return tuple(f for f, _ in out), mesh.pmax([d for _, d in out])


def _exchange_blocks(packed, payload, n: int, rows: int, shift: int, xcap: int):
    """Cuts one shard's sorted segment stream into its n exchange blocks
    (`forma_tpu/ops/pipeline.py:501-534`): block d holds the segments of
    destination d's tile rows [d * rows, (d + 1) * rows), at most `xcap`,
    the rest of its slots the sentinel and the zero payload.  The stream
    is sorted by its global row field (`packed >> shift` = tile row + 1),
    so each destination's segments are one contiguous slice, found by a
    binary search of its first key; each block is a gather at a clamped
    start with a keep mask, all on the device.  Returns (keys, payloads)
    int32 [n, xcap] and the largest destination's segment count."""
    dev = packed.device
    d = torch.arange(n + 1, dtype=torch.int32, device=dev)
    # Destination d's first key, and past the last destination's rows the
    # first sentinel: (rows_total + 1) << shift lies below it.
    edges = torch.searchsorted(packed, (d * rows + 1) << shift)
    starts, ends = edges[:-1, None], edges[1:, None]
    start = torch.clamp(starts, max=packed.shape[0] - xcap)
    gidx = start + torch.arange(xcap, device=dev)
    keep = (gidx >= starts) & (gidx < ends)
    blk_k = torch.where(keep, packed[gidx], PACKED_SENTINEL)
    blk_p = torch.where(keep, payload[gidx], ZERO_PAYLOAD)
    return blk_k, blk_p, (ends - starts).max()


def line_front(
    p0x, p0y, p1x, p1y, line_slot, g_slot, g_valid, g_t, g_has_t,
    width: int, height: int, rows: int, tiles_x: int, caps: Caps,
    n: int, xcap: int, slot_bits: int,
    shards: tuple, expand: str = "fused", plain: bool = False, taps=None,
):
    """The front half of line shards `shards` of
    `render_frame_sharded_lines`, all on the inputs' device: shard i takes
    the i-th n-th of the pair arrays, runs line setup on them and the
    packed emit at the frame's global tile rows (`rows * n` rows from row
    0), sorts locally and cuts the sorted stream into one block of `xcap`
    slots per destination (`_exchange_blocks`).  Returns one (keys,
    payloads int32 [n, xcap], its vline total, its segments, the largest
    block's segment count) a shard."""
    tx_bits = max((tiles_x + 1).bit_length(), 1)
    own = [t.reshape(n, -1) for t in (p0x, p0y, p1x, p1y, line_slot)]
    out = []
    for i in shards:
        params, _, lengths, vline_ends = _ls.line_setup_pairs(
            *(t[i] for t in own), g_slot, g_valid, g_t, g_has_t,
            width, height, k_seg=K_SEG,
        )
        v_total = vline_ends[-1]
        packed, payload = _raster._expand_emit_packed(
            params, lengths, vline_ends, torch.clamp(v_total, max=caps.vline),
            caps.vline, K_SEG, rows * n, tiles_x, 0, slot_bits, tx_bits,
            expand=expand, plain=plain, taps=_shard_taps(taps, i),
        )
        # Ascending keys are ascending global rows: grouped by destination.
        packed, order = torch.sort(packed, stable=False)
        k, p, max_pair = _exchange_blocks(
            packed, payload[order], n, rows, slot_bits + tx_bits, xcap)
        out.append((k, p, v_total, lengths.sum(dtype=torch.int64), max_pair))
    return tuple(out)


def line_back(
    recv_k, recv_p, v_totals, max_pairs,  # one each a shard of `shards`
    total_segs, st, clear, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels, slot_bits: int,
    shards: tuple, plain: bool = False, taps=None,
):
    """The back half of line shards `shards` of
    `render_frame_sharded_lines`, all on the inputs' device: shard i
    re-biases the rows of the segments it received (`recv_k`, `recv_p`,
    what `mesh.all_to_all` gave it) to its own, sorts them and runs
    `_back` on its tile rows [i * rows, (i + 1) * rows), with its front
    half's vline total and the frame's segments (`total_segs`, the sum
    over the shards).  Returns one (u8 frame, int64 [8] diag) a shard."""
    tx_bits = max((tiles_x + 1).bit_length(), 1)
    shift = slot_bits + tx_bits
    out = []
    for i, k, p, v_total, max_pair in zip(shards, recv_k, recv_p, v_totals, max_pairs):
        row_lo = i * rows
        k = torch.where(k == PACKED_SENTINEL, k, k - (row_lo << shift))
        recv_valid = (k != PACKED_SENTINEL).sum(dtype=torch.int64)
        key_hi, key_lo, payload = _raster.sort_segments(k, p, slot_bits, tx_bits)
        frame, diag = _back(
            key_hi, key_lo, payload, v_total, total_segs,
            st, clear, rows, tiles_x, caps, features, channels,
            row_lo=row_lo, presorted=True, plain=plain, taps=_shard_taps(taps, i),
        )
        out.append((frame, torch.cat([diag, max_pair[None], recv_valid[None]])))
    return tuple(out)


def render_frame_sharded_lines(
    p0x, p0y, p1x, p1y, line_slot,  # [L] line-endpoint pairs, shard i's the i-th L/n
    g_slot, g_valid, g_t, g_has_t, st, clear,
    width: int, height: int, rows: int, tiles_x: int,
    caps: Caps, features: Features, channels, mesh,
    xcap: int,  # per-(source, destination) exchange block capacity, a multiple of 128
    expand: str = "fused", plain: bool = False, taps=None, run=None,
):
    """Line-sharded render over `mesh` (`forma_tpu/ops/pipeline.py:
    420-566`): the lines shard as well as the frame, so line setup, the
    expansion and emit, and the segment sort each do ~1/n of the work.

    Shard i takes the i-th n-th of the pair arrays (the renderer permutes
    them round-robin) and runs the front half (`line_front`); the blocks
    change places (`mesh.all_to_all`) and the shards' segment counts sum
    (`mesh.psum`); each shard then runs the back half (`line_back`) on its
    tile rows [i * rows, (i + 1) * rows).  Needs the packed key: raises
    `ValueError` where [row | slot | tx] passes 31 bits at `rows * n` rows
    (the row-sharded frame takes such scenes).  `caps` are per shard.
    Returns what `render_frame_sharded` returns, with the diagnostics'
    DIAG_SEGS the sum over the shards and two more entries, DIAG_XPAIR (a
    block that passes `xcap` drops segments, and the frame is invalid
    until the caller grows `xcap`) and DIAG_XRECV.  Each half of a card's
    shards is one call through `run`, as in `render_frame_sharded`; the
    exchange and the sums run between them."""
    n = mesh.size
    slot_bits = slot_bits_for(st["orders"].shape[0], rows * n, tiles_x)
    if slot_bits == 0:
        raise ValueError(
            "the line-sharded frame needs the packed key; use render_frame_sharded"
        )
    # A shard sends no destination more than its own segment slots, which
    # also keeps every block's start in range.
    xcap = min(xcap, caps.vline * K_SEG)
    if xcap % 128 or line_slot.shape[0] % n:
        raise ValueError(f"xcap {xcap} must be a multiple of 128 and the lines "
                         f"{line_slot.shape[0]} of the mesh size {n}")
    run = run or mesh.run
    fronts = _per_card(
        mesh, run, line_front,
        lambda _: (p0x, p0y, p1x, p1y, line_slot, g_slot, g_valid, g_t, g_has_t),
        dict(width=width, height=height, rows=rows, tiles_x=tiles_x, caps=caps, n=n,
             xcap=xcap, slot_bits=slot_bits, expand=expand, plain=plain, taps=taps),
    )
    recv_k = mesh.all_to_all([f[0] for f in fronts])
    recv_p = mesh.all_to_all([f[1] for f in fronts])
    total_segs = mesh.psum([f[3] for f in fronts])
    backs = _per_card(
        mesh, run, line_back,
        lambda s: (tuple(recv_k[i] for i in s), tuple(recv_p[i] for i in s),
                   tuple(fronts[i][2] for i in s), tuple(fronts[i][4] for i in s),
                   total_segs, st, clear),
        dict(rows=rows, tiles_x=tiles_x, caps=caps, features=features, channels=channels,
             slot_bits=slot_bits, plain=plain, taps=taps),
    )
    return tuple(f for f, _ in backs), mesh.pmax([d for _, d in backs])


def style_tables_device(st, device) -> dict:
    """Host StyleTables -> a dict of tensors on `device` (u32 as int64)."""
    names = (
        "orders", "pidx", "fill_rule", "func", "clip_n", "is_clipped",
        "blend", "fill_type", "color", "grad", "stops", "tex", "atlas",
    )
    return {n: from_numpy(getattr(st, n), device) for n in names}
