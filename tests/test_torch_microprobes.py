"""The port's K6-K9 probes (`forma_tpu_torch/probes/`), each plain version
held to the Pallas kernel it replaces, run in interpret mode on the CPU,
and to a numpy evaluation of the same statements:

- K8 `fold_ablate` against `tools/fold_kernel_ablate.make_kernel` with the
  specs of its `run()` and `BI` set to `paint_pallas`'s TB = 32 layout
  (the tool's own `BI` describes TB = 8): within 1e-6 absolute, the gap
  XLA:CPU's contraction into FMA leaves in the Over chain (as for K3);
  bit-equal to numpy op by op, "no loads" included (the tool leaves it
  undefined; the port holds the tile's first row);
- K6 and K7 against copies of the bodies nested in
  `tools/tpu_microbench2.py:main` (K6's `out` starts from a zero input
  through `input_output_aliases`);
- K9 against `tools/pallas_scatter_probe.kernel` at 2 * CHUNK segments,
  exact;
- the probes' host-side logic: K8's row-load designs (one result on the
  CPU, a bad one refused), K9's cluster count.
"""

import sys
from pathlib import Path as FsPath

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from forma_tpu_torch.ops import _build
from forma_tpu_torch.probes import fold_ablate as k8
from forma_tpu_torch.probes import grid_scatter as k9
from forma_tpu_torch.probes import microbench as mb
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

REPO = FsPath(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import pallas_scatter_probe  # noqa: E402
from tools import fold_kernel_ablate, fold_kernel_bench  # noqa: E402


def small_depths(n: int = 64, seed: int = 5) -> np.ndarray:
    """Per-tile unit counts up to 9, two of them empty."""
    depth = np.random.default_rng(seed).integers(0, 10, n)
    depth[[3, n - 1]] = 0
    return depth


@pytest.fixture(scope="module")
def k8_inputs():
    u_mat, blkinfo = k8.build_inputs(small_depths())
    return u_mat, blkinfo, torch.ones(4, dtype=torch.float32)


def test_paris_like_depths_match_tool():
    want = fold_kernel_bench.paris_like_depths(np.random.default_rng(0))
    got = k8.paris_like_depths(np.random.default_rng(0))
    assert got.shape == (k8.ROWS * k8.TILES_X,)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 250


@pytest.mark.parametrize("n_tiles", [64, 50])
def test_build_inputs_match_tool(n_tiles):
    depth = small_depths(n_tiles, seed=n_tiles)
    u_want, b_want = fold_kernel_bench.build_inputs(depth)
    u_got, b_got = k8.build_inputs(depth)
    np.testing.assert_array_equal(u_got.numpy(), np.asarray(u_want))
    np.testing.assert_array_equal(b_got.numpy(), np.asarray(b_want))
    assert b_got.shape == (-(-n_tiles // k8.TB), k8.BI_W)
    assert k8.addressed_rows(b_got) == depth.sum()


def fold_numpy(u_mat, blkinfo, clear, variant):
    """The fold of K8 in numpy, tile by tile and op by op, with int32
    shifts as the tool writes them."""
    loads, dots, rolls, blend = k8.VARIANTS[variant]
    f32 = np.float32
    recip = f32(1.0 / 512)
    out = np.empty((blkinfo.shape[0] * k8.TB, 1024), f32)
    for t in range(out.shape[0]):
        bi = blkinfo[t // k8.TB]
        first = int(bi[0]) + int(bi[k8.BI_BASE0 + t % k8.TB])
        dst = np.repeat(clear, 256).reshape(4, 256).copy()
        for k in range(int(bi[k8.BI_CNT0 + t % k8.TB])):
            row = u_mat[min(first + (k if loads else 0), u_mat.shape[0] - 1)]
            g = row[:256]
            cover = (g << 16) >> 16
            area = (g - cover) >> 16
            c = cover.reshape(16, 16)
            exc = (np.cumsum(c, axis=1, dtype=np.int32) - c).reshape(256) if rolls else cover
            ce = np.repeat(row[256:272], 16) if dots else np.int32(0)
            da = (np.int32(32) * (ce + exc) + area).astype(np.int32)
            nz = np.clip(np.abs(da.astype(f32) * recip), f32(0), f32(1))
            eo = (np.int32(512) - np.abs((da & 1023) - np.int32(512))).astype(f32) * recip
            cov = eo if row[276] != 0 else nz
            if blend:
                fill = row[272:276].view(f32)
                src_a = fill[3] * cov
                dst_a = dst[3].copy()
                inv_dst_a_src_a = (f32(1) - dst_a) * src_a
                inv_src_a = f32(1) - src_a
                dst_a_src_a = dst_a * src_a
                for ch in range(3):
                    dst[ch] = dst[ch] * inv_src_a + (fill[ch] * inv_dst_a_src_a
                                                     + fill[ch] * dst_a_src_a)
                dst[3] = dst_a * inv_src_a + src_a
            else:
                dst[0] = dst[0] + cov
        out[t] = dst.reshape(1024)
    return out


@pytest.mark.parametrize("variant", list(k8.VARIANTS))
def test_fold_ablate_matches_numpy(k8_inputs, variant):
    u_mat, blkinfo, clear = k8_inputs
    got = k8.fold_ablate(u_mat, blkinfo, clear, variant).numpy()
    want = fold_numpy(u_mat.numpy(), blkinfo.numpy(), clear.numpy(), variant)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # Empty tiles keep the clear colour; folded tiles moved off it.
    assert (got[3] == 1.0).all() and (got[0] != 1.0).any()


@pytest.mark.parametrize("variant", [v for v in k8.VARIANTS if v != "no_loads"])
def test_fold_ablate_matches_pallas(k8_inputs, variant, monkeypatch):
    u_mat, blkinfo, clear = k8_inputs
    bi = dict(START=k8.BI_START, NCHUNK=k8.BI_NCHUNK, KMAX=k8.BI_KMAX,
              BASE0=k8.BI_BASE0, CNT0=k8.BI_CNT0, W=k8.BI_W)
    for key, value in bi.items():
        monkeypatch.setitem(fold_kernel_ablate.BI, key, value)
    tb, ch, uw = fold_kernel_ablate.TB, fold_kernel_ablate.CH, fold_kernel_ablate.UW
    assert (tb, ch, uw) == (k8.TB, k8.CH, k8.UW)
    nblk = blkinfo.shape[0]
    win = -(-(tb * fold_kernel_ablate.K_SLOTS + ch + 8) // ch) * ch
    # The specs of fold_kernel_ablate.run (:153-171), without its .sum().
    want = np.asarray(pl.pallas_call(
        fold_kernel_ablate.make_kernel(*k8.VARIANTS[variant]),
        grid=(nblk,),
        in_specs=[
            pl.BlockSpec((1, 1, k8.BI_W), lambda b: (b, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((tb, 1024), lambda b: (b, 0)),
        out_shape=jax.ShapeDtypeStruct((nblk * tb, 1024), jnp.float32),
        scratch_shapes=[
            pltpu.VMEM((win, uw), jnp.int32),
            pltpu.VMEM((tb, uw), jnp.int32),
            pltpu.VMEM((tb, 1), jnp.int32),
            pltpu.VMEM((tb, 1024), jnp.float32),
            pltpu.SemaphoreType.DMA((win // ch,)),
        ],
        interpret=True,
    )(jnp.asarray(blkinfo.numpy()).reshape(nblk, 1, k8.BI_W), jnp.asarray(clear.numpy()),
      jnp.asarray(u_mat.numpy())))
    got = k8.fold_ablate(u_mat, blkinfo, clear, variant).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fold_ablate_cpu_dispatch_and_checks(k8_inputs):
    u_mat, blkinfo, clear = k8_inputs
    _build.reset_launches()
    for variant in k8.VARIANTS:
        assert torch.equal(k8.fold_ablate(u_mat, blkinfo, clear, variant),
                           k8.fold_ablate_torch(u_mat, blkinfo, clear, variant))
    assert _build.LAUNCHES["fold_ablate"] == 0
    with pytest.raises(ValueError, match="variant"):
        k8.fold_ablate(u_mat, blkinfo, clear, "no_prefix")
    with pytest.raises(ValueError, match="shape"):
        k8.fold_ablate(u_mat[:, :277], blkinfo, clear)
    with pytest.raises(ValueError, match="shape"):
        k8.fold_ablate(u_mat, blkinfo[:, :24], clear)
    with pytest.raises(ValueError, match="float32"):
        k8.fold_ablate(u_mat, blkinfo, clear.double())


def unit_stream_pallas(tile_of, cov, n_tiles):
    """tools/tpu_microbench2.py:144-160 (unit_stream_kernel and its
    pallas_call), the body copied as it is; `out` starts from zeros."""
    n_units = tile_of.shape[0]

    def unit_stream_kernel(tile_ref, cov_ref, init_ref, out_ref):
        def body(u, _):
            t = tile_ref[u]
            c = cov_ref[u]
            cur = out_ref[pl.ds(t * 2, 2), :]
            out_ref[pl.ds(t * 2, 2), :] = cur * (1.0 - c) + c
            return 0
        jax.lax.fori_loop(0, n_units, body, 0)

    return np.asarray(pl.pallas_call(
        unit_stream_kernel,
        out_shape=jax.ShapeDtypeStruct((n_tiles * 2, 128), jnp.float32),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        input_output_aliases={2: 0},
        interpret=True,
    )(jnp.asarray(tile_of), jnp.asarray(cov), jnp.zeros((n_tiles * 2, 128), jnp.float32)))


def unit_stream_numpy(tile_of, cov, n_tiles, fma=False):
    """The same statements in a numpy loop over u; `fma` rounds
    cur * (1 - c) + c once, as one fused multiply-add."""
    out = np.zeros((n_tiles, 256), np.float32)
    c = cov.reshape(-1, 256)
    for u, t in enumerate(tile_of):
        a = np.float32(1.0) - c[u]
        if fma:
            out[t] = (out[t].astype(np.float64) * a + c[u]).astype(np.float32)
        else:
            out[t] = out[t] * a + c[u]
    return out.reshape(-1, 128)


def test_unit_stream_matches_pallas_and_numpy():
    """The plain version equals the numpy loop bit for bit.  XLA:CPU
    contracts the interpret-mode body's cur * (1 - c) + c into one FMA:
    its result equals the numpy loop evaluated with that FMA bit for bit,
    and the port (--fmad=false on the card, unfused here) is within one
    ulp of it."""
    tile_of, cov = mb.unit_inputs(512, 16, seed=3)
    got = mb.unit_stream(tile_of, cov, 16).numpy()
    assert got.shape == (32, 128)
    np.testing.assert_array_equal(got, unit_stream_numpy(tile_of.numpy(), cov.numpy(), 16))
    want = unit_stream_pallas(tile_of.numpy(), cov.numpy(), 16)
    np.testing.assert_array_equal(
        want, unit_stream_numpy(tile_of.numpy(), cov.numpy(), 16, fma=True))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_unit_stream_grouping():
    tile_of = torch.tensor([2, 0, 2, 1, 0, 2], dtype=torch.int32)
    perm, start = mb.group_units(tile_of, 4)
    assert perm.tolist() == [1, 4, 3, 0, 2, 5]
    assert start.tolist() == [0, 2, 3, 6, 6]
    out = mb.unit_stream(tile_of, torch.full((6, 2, 128), 0.5), 4).reshape(4, 256)
    assert out[:, 0].tolist() == [0.75, 0.5, 0.875, 0.0]  # tile 3 has no unit
    with pytest.raises(ValueError, match="tile_of"):
        mb.group_units(tile_of, 2)


def seg_loop_pallas(segs):
    """tools/tpu_microbench2.py:174-190 (seg_kernel and its pallas_call),
    the body copied as it is."""
    n = segs.shape[0]

    def seg_kernel(seg_ref, out_ref, acc_ref):
        acc_ref[:] = jnp.zeros_like(acc_ref)

        def body(i, _):
            s = seg_ref[i]
            acc_ref[s // 128, s % 128] += 1.0
            return 0
        jax.lax.fori_loop(0, n, body, 0)
        out_ref[:] = acc_ref[:]

    return np.asarray(pl.pallas_call(
        seg_kernel,
        out_shape=jax.ShapeDtypeStruct((2, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, 128), jnp.float32)],
        interpret=True,
    )(jnp.asarray(segs)))


@pytest.mark.parametrize("n, seed", [(2048, 2), (300, 9)])
def test_seg_loop_matches_pallas_and_numpy(n, seed):
    segs = mb.seg_inputs(n, seed=seed)
    got = mb.seg_loop(segs).numpy()
    np.testing.assert_array_equal(got, seg_loop_pallas(segs.numpy()))
    acc = np.zeros((2, 128), np.float32)
    for s in segs.numpy():
        acc[s // 128, s % 128] += 1.0
    np.testing.assert_array_equal(got, acc)
    assert got.sum() == n


def seg_edges(n: int, seed: int) -> torch.Tensor:
    """K7's ragged cut: n segments in [-3, 259), some outside the bins."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-3, 259, n).astype(np.int32))


@pytest.mark.parametrize("n, seed", [(1027, 4), (3, 5), (2, 6), (0, 7)])
def test_seg_loop_ragged_out_of_range_matches_pallas(n, seed):
    """A length not a multiple of 4 (and under 4) with values in [-3,
    259): the port counts the values in [0, 256) as the Pallas body counts
    them, and the rest nowhere (the TPU kernel's address would leave its
    accumulator, so the body gets only the values in range)."""
    segs = seg_edges(n, seed)
    got = mb.seg_loop(segs).numpy()
    inside = segs.numpy()[(segs.numpy() >= 0) & (segs.numpy() < mb.BINS)]
    if inside.size:
        np.testing.assert_array_equal(got, seg_loop_pallas(inside))
    want = np.bincount(inside, minlength=mb.BINS).astype(np.float32).reshape(2, 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 1024, 1025, 1 << 20, 1 << 26])
def test_seg_loop_grid(n):
    """K7's grid: one block a SM, fewer where a block would take under
    MIN_SEGS_PER_BLOCK, at least one."""
    b = mb.seg_blocks(n, 132)
    assert 1 <= b <= 132
    assert b == 132 or b == max(1, -(-n // mb.MIN_SEGS_PER_BLOCK))
    assert mb.seg_blocks(1 << 20, 132) == 132


def test_microbench_cpu_dispatch_and_checks():
    _build.reset_launches()
    tile_of, cov = mb.unit_inputs(64, 8, seed=1)
    perm, start = mb.group_units(tile_of, 8)
    assert torch.equal(mb.unit_stream_grouped(perm, start, cov),
                       mb.unit_stream_grouped_torch(perm, start, cov))
    segs = mb.seg_inputs(100, seed=1)
    assert torch.equal(mb.seg_loop(segs), mb.seg_loop_torch(segs))
    # Values outside [0, 256) count nowhere.
    assert mb.seg_loop(torch.tensor([-1, 0, 256, 255], dtype=torch.int32)).sum() == 2
    assert _build.LAUNCHES["unit_stream"] == _build.LAUNCHES["seg_loop"] == 0
    with pytest.raises(ValueError, match="shape"):
        mb.unit_stream_grouped(perm, start, cov[:, :1])
    with pytest.raises(ValueError, match="int32"):
        mb.unit_stream_grouped(perm.long(), start, cov)
    with pytest.raises(ValueError, match="int32"):
        mb.seg_loop(segs.long())
    with pytest.raises(ValueError, match="vector"):
        mb.seg_loop(segs.reshape(10, 10))
    assert _build.LAUNCHES["seg_loop"] == 0


@pytest.mark.parametrize("mode", k9.MODES)
def test_grid_scatter_matches_pallas(mode):
    chunk = pallas_scatter_probe.CHUNK
    n = 2 * chunk
    row, cell, val = k9.scatter_inputs(mode, n, seed=1)
    want = np.asarray(pl.pallas_call(
        pallas_scatter_probe.kernel,
        grid=(n // chunk,),
        in_specs=[pl.BlockSpec((chunk,), lambda i: (i,), memory_space=pltpu.SMEM)] * 3,
        out_specs=pl.BlockSpec((pallas_scatter_probe.WINDOW, 256), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((pallas_scatter_probe.WINDOW, 256), jnp.int32),
        scratch_shapes=[pltpu.VMEM((pallas_scatter_probe.WINDOW, 256), jnp.int32)],
        interpret=True,
    )(*(jnp.asarray(t.numpy()) for t in (row, cell, val))))
    got = k9.grid_scatter(row, cell, val).numpy()
    np.testing.assert_array_equal(got, want)
    if mode == "probe":
        assert np.count_nonzero(got - np.diag(np.diag(got))) == 0
    assert got.sum() == val.sum()


def test_grid_scatter_bands_and_edges():
    """Rows at both edges of both bands land once; a row or cell outside
    [0, 256) adds nothing."""
    row = torch.tensor([0, 127, 128, 255, 255, 127, -1, 256, 5, 5], dtype=torch.int32)
    cell = torch.tensor([0, 255, 0, 255, 255, 3, 0, 0, -1, 256], dtype=torch.int32)
    val = torch.tensor([1, 2, 3, 4, 5, 6, 100, 100, 100, 100], dtype=torch.int32)
    got = k9.grid_scatter(row, cell, val)
    want = np.zeros((256, 256), np.int32)
    np.add.at(want, (row[:6].numpy(), cell[:6].numpy()), val[:6].numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[255, 255] == 9 and got.sum() == 21


def test_grid_scatter_cpu_dispatch_and_checks():
    _build.reset_launches()
    row, cell, val = k9.scatter_inputs("independent", 1000, seed=4)
    assert torch.equal(k9.grid_scatter(row, cell, val), k9.grid_scatter_torch(row, cell, val))
    assert _build.LAUNCHES["grid_scatter"] == 0
    with pytest.raises(ValueError, match="mode"):
        k9.scatter_inputs("diagonal")
    with pytest.raises(ValueError, match="shape"):
        k9.grid_scatter(row, cell[:10], val)
    with pytest.raises(ValueError, match="int32"):
        k9.grid_scatter(row, cell, val.long())


def test_fold_ablate_designs_on_cpu(k8_inputs):
    """Both designs take the plain version on the CPU and give its result;
    a bad design is refused."""
    u_mat, blkinfo, clear = k8_inputs
    want = k8.fold_ablate_torch(u_mat, blkinfo, clear, "full")
    _build.reset_launches()
    for design in k8.DESIGNS:
        assert torch.equal(k8.fold_ablate(u_mat, blkinfo, clear, "full", design), want)
    assert _build.LAUNCHES["fold_ablate"] == 0
    assert k8.DESIGN in k8.DESIGNS
    with pytest.raises(ValueError, match="design"):
        k8.fold_ablate(u_mat, blkinfo, clear, "full", "tma8")


@pytest.mark.parametrize("n", [0, 1000, 1 << 18, 1 << 20, 1 << 24])
def test_grid_scatter_cluster_layout(n):
    """CLUSTERS pairs, fewer where a CTA's share would fall below
    SEGMENTS_PER_CTA, at least one."""
    count = k9.cluster_count(n)
    share = k9.CLUSTER * k9.SEGMENTS_PER_CTA
    assert 1 <= count <= k9.CLUSTERS
    assert count == k9.CLUSTERS or n <= count * share
    assert count == 1 or n > (count - 1) * share
