"""K2 of the PyTorch port (`forma_tpu_torch/ops/grid_kernel.py`): the
plain PyTorch version against the JAX Pallas kernel `grid_build_pallas`
with run keys (interpret mode) and a numpy scatter, on the same inputs
(the cases of `tests/test_grid_pallas.py`).  Grid, rowcov and run keys
must be bit-equal on the valid rows; the port's rows past the last run
are zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forma_tpu.ops.grid_pallas import B, grid_build_pallas
from forma_tpu_torch.ops import _build
from forma_tpu_torch.ops.grid_kernel import grid_build, grid_build_torch


def _make(N, R, NV, seed):
    rng = np.random.default_rng(seed)
    run_len = rng.geometric(1.0 / 6.0, size=R)
    rid = np.repeat(np.arange(R), run_len)[:NV]
    NV = len(rid)
    n_runs = int(rid[-1]) + 1
    rid = np.concatenate([rid, np.full(N - NV, min(n_runs, R - 1))])
    cell = rng.integers(0, 256, size=N).astype(np.int32)
    area = rng.integers(-1024, 1024, size=N).astype(np.int32)
    cover = rng.integers(-16, 17, size=N).astype(np.int32)
    area[NV:] = 0
    cover[NV:] = 0
    return rid.astype(np.int32), cell, area, cover, n_runs


def _keys(rid, R, n_runs, seed, hi_bits=32):
    rng = np.random.default_rng(100 + seed)
    kh = rng.integers(0, 2**hi_bits, size=R, dtype=np.uint64).astype(np.uint32)
    kl = rng.integers(0, 2**32, size=R, dtype=np.uint64).astype(np.uint32)
    kh[min(n_runs, R - 1)] = 0xFFFFFFFF  # the sentinel run
    return kh, kl, kh[rid], kl[rid]


def _check(rid, cell, area, cover, key_hi, key_lo, R, n_runs, kh, kl):
    grid, rowcov, runkeys = (
        x.numpy()
        for x in grid_build_torch(
            *(torch.from_numpy(a) for a in (rid, cell, area, cover)),
            torch.from_numpy(key_hi.astype(np.int64)),
            torch.from_numpy(key_lo.astype(np.int64)), R,
        )
    )
    assert grid.shape == (R, 256) and grid.dtype == np.int32
    assert rowcov.shape == (R, 16) and runkeys.shape == (R, 2)
    rows = min(n_runs + 1, R)  # rows past the last run id: Pallas leaves them undefined

    # numpy scatter reference
    ref = np.zeros((R, 256), np.int64)
    np.add.at(ref, (rid, cell), area.astype(np.int64) * 65536 + cover)
    np.testing.assert_array_equal(grid.astype(np.int64) & 0xFFFFFFFF, ref & 0xFFFFFFFF)
    cov = ((grid.astype(np.int64) & 0xFFFF) ^ 0x8000) - 0x8000
    np.testing.assert_array_equal(rowcov, cov.reshape(R, 16, 16).sum(axis=2))
    np.testing.assert_array_equal(runkeys[:rows, 0], kh[:rows])
    np.testing.assert_array_equal(runkeys[:rows, 1], kl[:rows])
    assert (runkeys[rows:] == 0).all() and (grid[rows:] == 0).all()

    # the Pallas kernel
    pg, prc, prk = (
        np.asarray(x)
        for x in grid_build_pallas(
            jnp.asarray(rid), jnp.asarray(cell), jnp.asarray(area),
            jnp.asarray(cover), run_cap=R, interpret=True,
            key_hi=jnp.asarray(key_hi), key_lo=jnp.asarray(key_lo),
        )
    )
    np.testing.assert_array_equal(grid[:rows], pg[:rows])
    np.testing.assert_array_equal(rowcov[:rows], prc[:rows])
    np.testing.assert_array_equal(runkeys[:rows], prk[:rows].astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_random_runs(seed):
    N, R, NV = 3 * B, 224, int(2.2 * B)
    rid, cell, area, cover, n_runs = _make(N, R, NV, seed)
    kh, kl, key_hi, key_lo = _keys(rid, R, n_runs, seed)
    _check(rid, cell, area, cover, key_hi, key_lo, R, n_runs, kh, kl)


def test_grid_single_giant_run():
    """One run spanning many blocks, then a short second run."""
    N = 4 * B
    rng = np.random.default_rng(7)
    rid = np.zeros(N, np.int32)
    rid[-B // 2 :] = 1
    cell = rng.integers(0, 256, size=N).astype(np.int32)
    area = rng.integers(-64, 64, size=N).astype(np.int32)
    cover = rng.integers(-16, 17, size=N).astype(np.int32)
    kh = np.asarray([5, 0xFFFFFFFF] + [0] * 62, np.uint32)
    kl = np.asarray([9, 0] + [0] * 62, np.uint32)
    _check(rid, cell, area, cover, kh[rid], kl[rid], 64, 2, kh, kl)


@pytest.mark.parametrize("seed", [0, 3])
def test_grid_full_sentinel_blocks(seed):
    """A sentinel tail spanning several whole blocks (the padded-key
    fraction of a real frame)."""
    N, R, NV = 6 * B, 224, int(1.5 * B)
    rid, cell, area, cover, n_runs = _make(N, R, NV, seed)
    kh, kl, key_hi, key_lo = _keys(rid, R, n_runs, 200 + seed, hi_bits=31)
    _check(rid, cell, area, cover, key_hi, key_lo, R, n_runs, kh, kl)


def test_grid_cpu_dispatch_uses_plain_version():
    rid, cell, area, cover, n_runs = _make(2048, 64, 1500, 5)
    kh, kl, key_hi, key_lo = _keys(rid, 64, n_runs, 5)
    args = (
        *(torch.from_numpy(a) for a in (rid, cell, area, cover)),
        torch.from_numpy(key_hi.astype(np.int64)),
        torch.from_numpy(key_lo.astype(np.int64)), 64,
    )
    before = dict(_build.LAUNCHES)
    for a, b in zip(grid_build(*args), grid_build_torch(*args)):
        assert torch.equal(a, b)
    assert _build.LAUNCHES == before
