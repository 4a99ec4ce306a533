"""The port's probes (`forma_tpu_torch/probes/`): K5, the texture-fold
probe, whose plain version is held to the Pallas kernel it replaces,
`tools/texture_fold_probe.run(..., interpret=True)`, on the probe's own
inputs: `atlas_rowsel` and `slab` bit-equal, `base` within 1e-6 relative
(XLA:CPU contracts the interpret-mode coordinate chain, measured 4.8e-7
absolute on values up to 5)."""

import sys
from pathlib import Path as FsPath

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forma_tpu_torch.ops import _build
from forma_tpu_torch.probes import texture_fold as k5
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(FsPath(__file__).resolve().parents[1] / "tools"))
import texture_fold_probe  # noqa: E402


@pytest.mark.parametrize(
    "mode, nblk, kmax",
    [(mode, 2, 3) for mode in k5.MODES] + [("atlas_rowsel", 1, 40), ("slab", 1, 40)],
)
def test_texture_fold_matches_pallas(mode, nblk, kmax):
    """(2, 3) is the probe at its smallest; (1, 40) walks ix past the
    slab's and the atlas's last column (the sampling modes only: base's
    contraction error grows with the depth)."""
    info, atlas = k5.probe_inputs(nblk, seed=nblk)
    want = np.asarray(texture_fold_probe.run(
        jnp.asarray(info.numpy()), jnp.asarray(atlas.numpy()), mode, kmax, nblk,
        interpret=True))
    got = k5.texture_fold(info, atlas, mode, kmax).numpy()
    assert got.shape == want.shape == (nblk * k5.TB, 1024)
    if mode == "base":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        assert (got > 0).all()


def test_texture_fold_samples_bf16_texels():
    """One tile, one step: each sampling mode returns the bf16-rounded
    texel its formula addresses (round to nearest even)."""
    info = torch.tensor([[1000, 0, 0, 1000, 5000, 2000, 1, 3]], dtype=torch.int32)
    atlas = torch.rand((k5.AH, k5.AW * 4), generator=torch.Generator().manual_seed(1))
    bf = atlas.to(torch.bfloat16).float()
    j = torch.arange(256)
    x, y = j % 16, j // 16  # sx = x + 5, sy = y + 2 (ux = vy = 1)
    for mode, (row, col) in {
        "atlas_rowsel": (y + 2, x + 5),
        "slab": (1 + (y + 2 - 1).clamp(0, k5.SH - 1), (x + 5 - 3).clamp(0, k5.SW - 1)),
    }.items():
        got = k5.texture_fold(info, atlas, mode, 1)
        for ch in range(4):
            assert torch.equal(got[0, ch * 256:(ch + 1) * 256], bf[row, 4 * col + ch])
    assert not torch.equal(bf, atlas)  # the rounding is visible


def test_texture_fold_cpu_dispatch_and_checks():
    _build.reset_launches()
    info, atlas = k5.probe_inputs(1)
    for mode in k5.MODES:
        assert torch.equal(k5.texture_fold(info, atlas, mode, 2),
                           k5.texture_fold_torch(info, atlas, mode, 2))
    assert _build.LAUNCHES["texture_probe"] == 0
    with pytest.raises(ValueError, match="mode"):
        k5.texture_fold(info, atlas, "bogus", 2)
    with pytest.raises(ValueError, match="at least"):
        k5.texture_fold(info, atlas[:16], "slab", 2)


def test_window_gather_matches_slices():
    at2, oy, ox = k5.window_inputs(n=5, seed=3)
    got = k5.window_gather(at2, oy, ox)
    assert got.shape == (5, k5.SH, k5.SW, 4)
    for u in range(5):
        y, x = int(oy[u]), int(ox[u])
        assert torch.equal(got[u], at2[y:y + k5.SH, x:x + k5.SW])
