"""K1 of the PyTorch port (`forma_tpu_torch/ops/expand_kernel.py`): the
plain PyTorch version against the JAX Pallas kernel
`expand_params_pallas` (interpret mode) and the XLA gather branch of
`rasterize._expand_emit_packed`, on the same numpy inputs.  Params and j
must be bit-equal on live vlines; padding vlines carry zero params."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forma_tpu.ops.expand_pallas import VB, expand_params_pallas
from forma_tpu_torch.ops import _build
from forma_tpu_torch.ops.expand_kernel import expand_params, expand_params_torch
from forma_tpu_torch.ops.line_setup import N_PARAMS


def _case(rng, L, with_dead_runs):
    """Random lengths (incl. runs of dead lines) -> params / live / ends,
    as `tests/test_expand_pallas.py` builds them."""
    lengths = rng.integers(0, 25, size=L)
    if with_dead_runs:
        lengths[100:400] = 0
        lengths[: L // 3] = np.where(rng.random(L // 3) < 0.7, 0, lengths[: L // 3])
    ends = np.cumsum(-(-lengths // 8)).astype(np.uint32)
    params = rng.standard_normal((L, N_PARAMS)).astype(np.float32)
    params[:, 4] = np.where(rng.random(L) < 0.1, np.inf, params[:, 4])
    params[:, 14] = rng.integers(0, 1 << 20, size=L)
    params[:, 15] = lengths
    return params, lengths > 0, ends


def _xla_gather(params, ends, v_cap):
    """The XLA gather branch (`forma_tpu/ops/rasterize.py:250-264`) in numpy."""
    L = params.shape[0]
    v = np.arange(v_cap)
    ends_c = np.minimum(ends.astype(np.int64), v_cap)
    line_id = np.cumsum(np.bincount(ends_c, minlength=v_cap + 1)[:v_cap])
    base = np.zeros(v_cap + 1, np.int64)
    np.maximum.at(base, ends_c, ends.astype(np.int64))
    base = np.maximum.accumulate(base[:v_cap])
    li = np.minimum(line_id, L - 1)
    return params[li].T, (v - base).astype(np.int32)


def _port(params, ends, v_cap):
    pt, j = expand_params_torch(
        torch.from_numpy(params), torch.from_numpy(ends.astype(np.int64)), v_cap
    )
    return pt.numpy(), j.numpy()


@pytest.mark.parametrize(
    "L, with_dead_runs, v_cap",
    [(3000, False, VB * 8), (3000, True, VB * 8), (300, False, VB + 512)],
)
def test_expand_matches_pallas_and_gather(L, with_dead_runs, v_cap):
    rng = np.random.default_rng(7 + with_dead_runs + L)
    params, live, ends = _case(rng, L, with_dead_runs)
    v_total = int(ends[-1])
    assert v_total < v_cap

    pt, j = _port(params, ends, v_cap)
    assert pt.shape == (N_PARAMS, v_cap) and pt.dtype == np.float32
    assert j.shape == (v_cap,) and j.dtype == np.int32

    ref_pt, ref_j = expand_params_pallas(
        jnp.asarray(params), jnp.asarray(live), jnp.asarray(ends), v_cap,
        interpret=True,
    )
    ref_pt, ref_j = np.asarray(ref_pt), np.asarray(ref_j)
    np.testing.assert_array_equal(pt.view(np.uint32), ref_pt.view(np.uint32))
    np.testing.assert_array_equal(j, ref_j)

    g_pt, g_j = _xla_gather(params, ends, v_cap)
    np.testing.assert_array_equal(
        pt[:, :v_total].view(np.uint32), g_pt[:, :v_total].view(np.uint32)
    )
    np.testing.assert_array_equal(j[:v_total], g_j[:v_total])
    assert (pt[:, v_total:] == 0).all()
    np.testing.assert_array_equal(j[v_total:], np.arange(v_total, v_cap) - v_total)


def test_expand_cpu_dispatch_uses_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    params, live, ends = _case(rng, 200, True)
    before = dict(_build.LAUNCHES)
    args = (torch.from_numpy(params), torch.from_numpy(ends.astype(np.int64)), 2048)
    pt, j = expand_params(*args)
    pt2, j2 = expand_params_torch(*args)
    assert torch.equal(pt.view(torch.int32), pt2.view(torch.int32))
    assert torch.equal(j, j2)
    assert _build.LAUNCHES == before
