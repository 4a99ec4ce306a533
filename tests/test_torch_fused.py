"""K4 of the PyTorch port (`forma_tpu_torch/ops/rasterize_kernel.py`): the
fused expand + packed emit's plain PyTorch version against the JAX
package's `_emit_packed` and `rasterize_blocks_pallas`, on the same
params (one numpy scene through both packages' `line_setup`), in the
cases of `tests/test_expand_pallas.py`: runs of dead lines, and a shard's
`row_lo` with `v_cap` not a multiple of the Pallas block.

Outputs compare element by element in the [k_seg, v_cap] layout: bit-equal
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
from forma_tpu_torch.ops.rasterize_kernel import rasterize_blocks

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
    assert all(x.shape == (K_SEG, v_cap) and x.dtype == np.int64 for x in got)
    n_valid = int((got[0] != 0xFFFFFFFF).sum())
    assert n_valid > 1000  # the scene really rasterizes
    assert (got[0][:, v_total:] == 0xFFFFFFFF).all()  # padding vlines emit nothing

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


def test_fused_and_split_paths_agree_without_launches():
    """`rasterize_sort(expand="fused")` and `(expand="split")` give the same
    segment multiset; on the CPU neither launches a kernel."""
    params, lengths, ends = _case(3, 800, True, width=256, height=128)
    slots = torch.zeros_like(lengths)
    v_cap = int(ends[-1]) + 300
    before = dict(_build.LAUNCHES)
    out = {}
    for expand in ("fused", "split"):
        kh, kl, pay = rasterize.rasterize_sort(
            params, slots, lengths, ends, ends[-1], v_cap, K_SEG, 8, 16, 0,
            slot_bits=SLOT_BITS, expand=expand,
        )
        out[expand] = Counter(zip(kh.tolist(), kl.tolist(), pay.tolist()))
    assert out["fused"] == out["split"]
    assert sum(n for k, n in out["fused"].items() if k[0] != 0xFFFFFFFF) > 1000
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="expand"):
        rasterize.rasterize_sort(
            params, slots, lengths, ends, ends[-1], v_cap, K_SEG, 8, 16, 0,
            slot_bits=SLOT_BITS, expand="bogus",
        )


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
