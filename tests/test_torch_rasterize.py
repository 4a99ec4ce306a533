"""Line setup, ff64 and the packed rasterize + sort of the PyTorch port
against the JAX package, on the same numpy inputs.

XLA may contract an f32 mul+add under jit, which can move an ff64 ceil by
one on rare elements (`docs/ARCHITECTURE.md:446-452`); PyTorch rounds op
by op.  So float results are held bit-equal against JAX run op by op
(`jax.disable_jit()`), and against the jitted path within 0.01% of
segments.  The segment sort is unstable, so sorted streams compare as
multisets."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forma_tpu.ops import ff64 as jff64
from forma_tpu.ops import line_setup as jls
from forma_tpu.ops import rasterize as jras
from forma_tpu_torch.ops import ff64, line_setup, rasterize

W, H = 256, 128
ROWS, TILES_X = H // 16, W // 16
SLOT_BITS = 6


def _scene(seed, L=600):
    """Random point chains over 4 geometries (one with no transform, one
    invalid) with culled stretches."""
    rng = np.random.default_rng(seed)
    px = (rng.standard_normal(L + 1) * W * 0.6 + W / 2).astype(np.float32)
    py = (rng.standard_normal(L + 1) * H * 0.6 + H / 2).astype(np.float32)
    px[::37] = px[1::37][: len(px[::37])]  # some vertical lines
    py[5::41] = py[6::41][: len(py[5::41])]  # some horizontal lines
    line_slot = rng.integers(-1, 4, size=L).astype(np.int32)
    line_slot[100:160] = -1
    g_slot = np.asarray([3, 0, 9, 1], np.int32)
    g_valid = np.asarray([True, True, False, True])
    a = 0.3
    g_t = np.asarray(
        [
            [1, 0, 0, 1, 0, 0],
            [np.cos(a), np.sin(a), -np.sin(a), np.cos(a), 5.5, -3.25],
            [1, 0, 0, 1, 0, 0],
            [0.75, 0.1, -0.2, 0.9, 17.0, 2.0],
        ],
        np.float32,
    )
    g_has_t = np.asarray([False, True, False, True])
    return px, py, line_slot, g_slot, g_valid, g_t, g_has_t


def _jax_line_setup(args):
    return [np.array(x) for x in jls.line_setup(*map(jnp.asarray, args), W, H, k_seg=8)]


def _port_line_setup(args):
    out = line_setup.line_setup(*map(torch.from_numpy, args), W, H, k_seg=8)
    return [x.numpy() for x in out]


def test_ff64_ops_match_jax_op_by_op():
    rng = np.random.default_rng(0)
    n = 4096
    vals = [
        (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
        for _ in range(4)
    ]
    vals[1][::97] = np.inf
    xj = jff64.FF(jnp.asarray(vals[0]), jnp.asarray(vals[1] * 1e-8))
    yj = jff64.FF(jnp.asarray(vals[2]), jnp.asarray(vals[3] * 1e-8))
    xt = ff64.FF(torch.from_numpy(vals[0]), torch.from_numpy(vals[1] * 1e-8))
    yt = ff64.FF(torch.from_numpy(vals[2]), torch.from_numpy(vals[3] * 1e-8))
    with jax.disable_jit():
        for op in ("add", "sub", "mul", "div"):
            rj = getattr(jff64, op)(xj, yj)
            rt = getattr(ff64, op)(xt, yt)
            for a, b in zip(rj, rt):
                np.testing.assert_array_equal(
                    np.asarray(a).view(np.uint32), b.numpy().view(np.uint32), err_msg=op
                )
        np.testing.assert_array_equal(
            np.asarray(jff64.ceil(xj)).view(np.uint32),
            ff64.ceil(xt).numpy().view(np.uint32),
        )


@pytest.mark.parametrize("seed", [1, 2])
def test_line_setup_matches_jax(seed):
    args = _scene(seed)
    params, slots, lengths, ends = _port_line_setup(args)
    j_params, j_slots, j_lengths, j_ends = _jax_line_setup(args)
    np.testing.assert_array_equal(lengths, j_lengths)
    np.testing.assert_array_equal(slots, j_slots)
    assert ends.dtype == np.int64
    np.testing.assert_array_equal(ends, j_ends.astype(np.int64))
    with jax.disable_jit():
        e_params = np.asarray(
            jls.line_setup(*map(jnp.asarray, args), W, H, k_seg=8)[0]
        )
    np.testing.assert_array_equal(params.view(np.uint32), e_params.view(np.uint32))


def _multiset(key_hi, key_lo, payload):
    return Counter(zip(key_hi.tolist(), key_lo.tolist(), payload.tolist()))


def test_rasterize_sort_matches_jax():
    args = _scene(3)
    j_params, j_slots, j_lengths, j_ends = _jax_line_setup(args)
    v_total = int(j_ends[-1])
    v_cap = v_total + 300  # padding vlines beyond the total
    port = rasterize.rasterize_sort(
        torch.from_numpy(j_params), torch.from_numpy(j_slots),
        torch.from_numpy(j_lengths), torch.from_numpy(j_ends.astype(np.int64)),
        torch.tensor(v_total), v_cap, 8, ROWS, TILES_X, 0, slot_bits=SLOT_BITS,
    )
    port = [x.numpy() for x in port]
    assert all(x.shape == (v_cap * 8,) for x in port)
    # Sorted by key: the unpacked key_hi stream is nondecreasing in the
    # packed order, i.e. (row, slot, tx) -> key_hi rows nondecreasing.
    assert (np.diff(port[0] >> 13) >= 0).all()

    jargs = (
        jnp.asarray(j_params), jnp.asarray(j_slots), jnp.asarray(j_lengths),
        jnp.asarray(j_ends), jnp.uint32(v_total),
    )
    with jax.disable_jit():
        eager = [np.asarray(x).astype(np.int64) for x in jras.rasterize_sort(
            *jargs, v_cap, 8, ROWS, TILES_X, 0, slot_bits=SLOT_BITS)]
    jitted = [np.asarray(x).astype(np.int64) for x in jras.rasterize_sort(
        *jargs, v_cap, 8, ROWS, TILES_X, 0, slot_bits=SLOT_BITS)]

    mp = _multiset(*port)
    assert mp == _multiset(*eager)
    diff = sum(((mp - _multiset(*jitted)) + (_multiset(*jitted) - mp)).values())
    assert diff <= 1e-4 * v_cap * 8, diff
    n_valid = int((port[0] != 0xFFFFFFFF).sum())
    assert n_valid > 1000  # the scene really rasterizes


def test_two_key_path_not_ported():
    args = _scene(4, L=20)
    p, s, l, e = (torch.from_numpy(x) for x in _port_line_setup(args))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rasterize.rasterize_sort(p, s, l, e, e[-1], 512, 8, ROWS, TILES_X, 0, slot_bits=0)
