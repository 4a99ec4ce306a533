"""K4 of the PyTorch port (`forma_tpu_torch/ops/rasterize_kernel.py`): the
fused expand + packed emit's plain PyTorch version against the JAX
package's `_emit_packed` and `rasterize_blocks_pallas`, on the same
params (one numpy scene through both packages' `line_setup`), in the
cases of `tests/test_expand_pallas.py`: runs of dead lines, and a shard's
`row_lo` with `v_cap` not a multiple of the Pallas block.

K4 emits the u32 words in int32 tensors, the key sentinel 0x7FFFFFFF (a
valid key fits 31 bits); they compare with JAX's u32 arrays once widened
to the u32 values, the sentinel mapped to 0xFFFFFFFF.  Outputs compare
element by element in the [k_seg, v_cap] layout: bit-equal
to JAX run op by op (`jax.disable_jit()`), and against the jitted Pallas
kernel in interpret mode with at most 0.01% of the elements of the two
outputs differing, because XLA may contract an f32 mul+add and move an
ff64 ceil by one (`tests/test_torch_rasterize.py`).  These long lines
(up to ~1,300 segments) flip more often than short ones: 153 of 2,850,816
elements differ in the first case, almost all payloads of segment 0."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forma_tpu.ops import line_setup as jls
from forma_tpu.ops import rasterize as jras
from forma_tpu.ops.expand_pallas import VB, rasterize_blocks_pallas
from forma_tpu_torch.ops import _build, line_setup, rasterize
from forma_tpu_torch.ops.pipeline import slot_bits_for
from forma_tpu_torch.ops.rasterize_kernel import (
    PACKED_SENTINEL, check_key_budget, rasterize_blocks,
)
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

K_SEG = 8
SLOT_BITS, TX_BITS = 6, 7


def _case(seed, L, with_dead_runs, width=512, height=256):
    """Random line-setup inputs (incl. runs of dead lines), as numpy."""
    rng = np.random.default_rng(seed)
    n = L + 1
    px = (rng.standard_normal(n) * width * 0.7).astype(np.float32)
    py = (rng.standard_normal(n) * height * 0.7).astype(np.float32)
    line_slot = np.zeros(L, np.int32)
    if with_dead_runs:
        line_slot[100:400] = -1  # long culled stretches
        line_slot[: L // 3] = np.where(
            rng.random(L // 3) < 0.6, -1, line_slot[: L // 3]
        )
    g = (
        np.asarray([3], np.int32), np.asarray([True]),
        np.asarray([[1, 0, 0, 1, 0, 0]], np.float32), np.asarray([False]),
    )
    args = (px, py, line_slot, *g)
    port = line_setup.line_setup(*map(torch.from_numpy, args), width, height, k_seg=K_SEG)
    with jax.disable_jit():
        want = jls.line_setup(*map(jnp.asarray, args), width, height, k_seg=K_SEG)
    params, _, lengths, ends = port
    np.testing.assert_array_equal(
        params.numpy().view(np.uint32), np.asarray(want[0]).view(np.uint32)
    )
    np.testing.assert_array_equal(ends.numpy(), np.asarray(want[3]).astype(np.int64))
    return params, lengths, ends


def _jax_emit_eager(params, ends, v_total, v_cap, rows, tiles_x, row_lo):
    """JAX's gather expansion + `_emit_packed`, run op by op."""
    P = jnp.asarray(params.numpy())
    vline_ends = jnp.asarray(ends.numpy().astype(np.uint32))
    with jax.disable_jit():
        iota_v = jnp.arange(v_cap, dtype=jnp.uint32)
        v_live = iota_v < jnp.uint32(v_total)
        e = jnp.minimum(vline_ends, jnp.uint32(v_cap)).astype(jnp.int32)
        line_id = jnp.cumsum(
            jnp.zeros(v_cap + 1, jnp.int32).at[e].add(1, mode="drop")[:-1]
        )
        base = jax.lax.cummax(
            jnp.zeros(v_cap + 1, jnp.uint32).at[e].max(vline_ends, mode="drop")[:-1]
        )
        li = jnp.minimum(line_id, P.shape[0] - 1)
        j = (iota_v - base).astype(jnp.int32)
        Pv = P[li]
        out = jras._emit_packed(
            lambda i: Pv[:, i], j, v_live, K_SEG, rows, tiles_x,
            jnp.int32(row_lo), SLOT_BITS, TX_BITS,
        )
    return [np.asarray(x).astype(np.int64) for x in out]


def _u32_values(packed, payload):
    """K4's int32 words -> their u32 values as int64, as JAX's uint32."""
    key = packed.astype(np.int64)
    key[packed == PACKED_SENTINEL] = 0xFFFFFFFF
    return key, payload.view(np.uint32).astype(np.int64)


@pytest.mark.parametrize(
    "seed, L, dead, rows, row_lo, vcap_pad",
    [
        (7, 3000, False, 16, 0, VB),
        (8, 3000, True, 16, 0, VB),
        (11, 200, False, 8, 4, 512),
    ],
    ids=["live_lines", "dead_line_runs", "row_lo_4_vcap_not_block_multiple"],
)
def test_rasterize_blocks_matches_jax(seed, L, dead, rows, row_lo, vcap_pad):
    params, lengths, ends = _case(seed, L, dead)
    v_total = int(ends[-1])
    v_cap = -(-v_total // VB) * VB + vcap_pad
    assert (v_cap % VB != 0) == (vcap_pad % VB != 0)
    tiles_x = 32

    got = rasterize_blocks(
        params, ends, torch.tensor(v_total), v_cap, K_SEG, rows, tiles_x,
        row_lo, SLOT_BITS, TX_BITS,
    )
    got = [x.numpy() for x in got]
    assert all(x.shape == (K_SEG, v_cap) and x.dtype == np.int32 for x in got)
    assert (got[0] != -1).all()  # no u32 sentinel, which would sort first
    got = _u32_values(*got)
    n_valid = int((got[0] != 0xFFFFFFFF).sum())
    assert n_valid > 1000  # the scene really rasterizes
    assert (got[0][:, v_total:] == 0xFFFFFFFF).all()  # padding vlines emit nothing
    assert got[0][got[0] != 0xFFFFFFFF].max() < PACKED_SENTINEL

    eager = _jax_emit_eager(params, ends, v_total, v_cap, rows, tiles_x, row_lo)
    for g, w in zip(got, eager):
        np.testing.assert_array_equal(g, w)

    pallas = rasterize_blocks_pallas(
        jnp.asarray(params.numpy()), jnp.asarray(lengths.numpy() > 0),
        jnp.asarray(ends.numpy().astype(np.uint32)), jnp.uint32(v_total),
        jnp.int32(row_lo), v_cap, K_SEG, rows, tiles_x, SLOT_BITS, TX_BITS,
        interpret=True,
    )
    differ = sum(int((g != np.asarray(w).astype(np.int64)).sum()) for g, w in zip(got, pallas))
    assert differ <= 1e-4 * 2 * K_SEG * v_cap, differ


def test_packed_route_emits_without_launches():
    """`rasterize_sort` on the packed key emits the scene's segments; on
    the CPU it launches no kernel."""
    params, lengths, ends = _case(3, 800, True, width=256, height=128)
    slots = torch.zeros_like(lengths)
    v_cap = int(ends[-1]) + 300
    before = dict(_build.LAUNCHES)
    kh, _, _ = rasterize.rasterize_sort(
        params, slots, lengths, ends, ends[-1], v_cap, K_SEG, 8, 16, 0,
        slot_bits=SLOT_BITS,
    )
    assert int((kh != 0xFFFFFFFF).sum()) > 1000
    assert _build.LAUNCHES == before


def test_params_alignment_check():
    """K4 loads each params row as one 16-byte vector: the wrapper refuses
    a view whose data pointer is off that boundary (a contiguous view with
    a storage offset of one float passes every other check)."""
    base = torch.zeros(4 * 16 + 1, dtype=torch.float32)
    _build.check_aligned(base[:64].view(4, 16), "params", 16)
    off = base[1:].view(4, 16)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.check_aligned(off, "params", 16)


@pytest.mark.parametrize(
    "rows, tiles_x, n_slots",
    [
        (1, 1, 2),
        (8, 16, 3),
        (68, 120, 1 << 17),  # 1920x1080 at the full 31 bits: 7 + 7 + 17
        (135, 240, 1 << 15),  # 3840x2160 at the full 31 bits: 8 + 8 + 15
        (16, 32, 1 << 20),  # 512x256 at the full 31 bits: 5 + 6 + 20
        (62, 126, 1 << 17),  # tiles_x + 1 = 2^7 - 1: the tx field's widest
    ],
)
def test_valid_keys_stay_below_the_sentinel(rows, tiles_x, n_slots):
    """Every key that `slot_bits_for` admits is below `PACKED_SENTINEL`,
    and the sentinel sorts after it as an int32; one more slot than the
    31 bits hold makes `slot_bits_for` refuse the packed key."""
    slot_bits = slot_bits_for(n_slots, rows, tiles_x)
    tx_bits = max((tiles_x + 1).bit_length(), 1)
    assert slot_bits > 0
    check_key_budget(rows, tiles_x, slot_bits, tx_bits)
    # Each field at its least and greatest: tile_y + 1 in [1, rows], the
    # slot in [0, n_slots), tile_x + 1 in [0, tiles_x] (tile -1 is the
    # cover-carry tile).
    keys = [
        ((ty << slot_bits | s) << tx_bits) | tx
        for ty in (1, rows) for s in (0, n_slots - 1) for tx in (0, tiles_x)
    ]
    assert max(keys) < PACKED_SENTINEL
    words = torch.tensor(keys + [PACKED_SENTINEL] + keys[::-1], dtype=torch.int32)
    assert torch.sort(words, stable=False).values[-1] == PACKED_SENTINEL
    assert (torch.sort(words).values[:-1] < PACKED_SENTINEL).all()
    full = (rows + 1).bit_length() + slot_bits + tx_bits == 31
    if full:
        assert slot_bits_for((1 << slot_bits) + 1, rows, tiles_x) == 0
        with pytest.raises(ValueError, match="31 bits"):
            check_key_budget(rows, tiles_x, slot_bits + 1, tx_bits)


# A 512x256 frame whose [row | slot | tx] key takes all 31 bits: 16 tile
# rows (5 bits), 32 tiles across (6 bits), 20 bits of layer slot.
BUDGET_W, BUDGET_H = 512, 256
BUDGET_ROWS, BUDGET_TILES_X, BUDGET_SLOT_BITS = 16, 32, 20


@pytest.fixture(scope="module")
def budget_frame():
    """Line setup and JAX's sorted streams (run op by op) of a frame at the
    31-bit key budget, with layer slots up to 2^20 - 1 and lines reaching
    the last tile row and column: on the packed key and on the two-key
    route (`slot_bits` 0), keyed by `slot_bits`."""
    rng = np.random.default_rng(31)
    L = 400
    px = (rng.random(L + 1) * BUDGET_W * 1.2 - BUDGET_W * 0.1).astype(np.float32)
    py = (rng.random(L + 1) * BUDGET_H * 1.2 - BUDGET_H * 0.1).astype(np.float32)
    px[::50], py[::50] = BUDGET_W - 3.5, BUDGET_H - 2.5  # the last tile
    line_slot = rng.integers(-1, 4, size=L).astype(np.int32)
    g_slot = np.asarray([(1 << BUDGET_SLOT_BITS) - 1, 0, 1 << 19, 77], np.int32)
    g = (g_slot, np.ones(4, bool), np.tile(np.asarray([1, 0, 0, 1, 0, 0], np.float32), (4, 1)),
         np.zeros(4, bool))
    args = (px, py, line_slot, *g)
    out = [np.array(x) for x in jls.line_setup(
        *map(jnp.asarray, args), BUDGET_W, BUDGET_H, k_seg=K_SEG)]
    params, slots, lengths, ends = out
    v_total = int(ends[-1])
    v_cap = v_total + 100
    assert slot_bits_for(int(g_slot.max()) + 1, BUDGET_ROWS, BUDGET_TILES_X) == BUDGET_SLOT_BITS
    with jax.disable_jit():
        want = {sb: [np.asarray(x).astype(np.int64) for x in jras.rasterize_sort(
            *map(jnp.asarray, (params, slots, lengths, ends)), jnp.uint32(v_total),
            v_cap, K_SEG, BUDGET_ROWS, BUDGET_TILES_X, 0, slot_bits=sb)]
            for sb in (BUDGET_SLOT_BITS, 0)}
    port_args = (*map(torch.from_numpy, (params, slots, lengths, ends.astype(np.int64))),
                 torch.tensor(v_total), v_cap)
    return port_args, want


@pytest.mark.parametrize("slot_bits", [BUDGET_SLOT_BITS, 0], ids=["fused", "two_key"])
def test_rasterize_sort_at_the_key_budget_matches_jax(budget_frame, slot_bits):
    """`rasterize_sort` at a key of exactly 31 bits, packed (K4) and on
    the two-key route (K1 and the two-key emit), against JAX's (op by op)
    with the same `slot_bits`: the same sorted keys and, per key, the same
    payloads.  The stream reaches the key's top fields: the largest slot
    and the last tile row."""
    port_args, wants = budget_frame
    want = wants[slot_bits]
    got = [x.numpy() for x in rasterize.rasterize_sort(
        *port_args, K_SEG, BUDGET_ROWS, BUDGET_TILES_X, 0, slot_bits=slot_bits)]
    assert all(x.dtype == np.int64 for x in got)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert Counter(zip(got[0].tolist(), got[1].tolist(), got[2].tolist())) == Counter(
        zip(want[0].tolist(), want[1].tolist(), want[2].tolist()))
    valid = got[0] != 0xFFFFFFFF
    assert valid.sum() > 1000 and (~valid).sum() >= 100 * K_SEG
    assert got[1][valid].max() == (1 << BUDGET_SLOT_BITS) - 1
    assert (got[0][valid] >> rasterize.TX_BITS).max() == BUDGET_ROWS
