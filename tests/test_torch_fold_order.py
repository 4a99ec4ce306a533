"""K3's tile order (`fold_kernel.tile_order`), the order in which the CUDA
fold's blocks take the tiles: a permutation of the tiles by descending
unit count, ties by tile index, on random spans and on a frame's own
spans (recorded through `taps`); and `paint_fold` on CPU tensors, which
takes the plain fold and computes no order."""

import numpy as np
import pytest
import torch

from forma_tpu_torch import Color, Composition, Renderer
from forma_tpu_torch.demos import scenes
from forma_tpu_torch.ops import fold_kernel
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


def _check_order(cnt: torch.Tensor):
    order = fold_kernel.tile_order(cnt)
    assert order.dtype == torch.int32 and order.device == cnt.device
    o = order.long().numpy()
    c = cnt.long().numpy()
    np.testing.assert_array_equal(np.sort(o), np.arange(len(c)))  # a permutation
    d = c[o]
    assert (np.diff(d) <= 0).all()  # deepest first
    ties = np.diff(d) == 0
    assert (np.diff(o)[ties] > 0).all()  # equal depths by tile index
    return order


@pytest.mark.parametrize("seed, tiles, hi", [(0, 1, 3), (1, 97, 4), (2, 8160, 251), (3, 500, 1)])
def test_tile_order_random_spans(seed, tiles, hi):
    """Random depths, many ties where `hi` is small (all equal at 1)."""
    rng = np.random.default_rng(seed)
    cnt = torch.from_numpy(rng.integers(0, hi, tiles).astype(np.int32))
    order = _check_order(cnt)
    if hi == 1:
        np.testing.assert_array_equal(order.numpy(), np.arange(tiles))


def _frame_taps():
    comp = Composition()
    scenes.circles(comp, 24, 96, 64)
    taps = {}
    Renderer("cpu").render_device(comp, 96, 64, Color(1.0, 1.0, 1.0, 1.0), taps=taps)
    return taps["fold"]


def test_tile_order_frame_spans():
    """The spans the port's pipeline hands to K3 on a circles frame."""
    args = _frame_taps()
    ust, cnt = args[:2]
    assert cnt.numel() == 6 * 4 and int(cnt.max()) > 1
    order = _check_order(cnt)
    # The deepest tile comes first, wherever it lies in the frame.
    assert int(cnt[order[0]]) == int(cnt.max())


def test_fold_cpu_takes_plain_and_no_order(monkeypatch):
    """CPU tensors take `paint_fold_torch`, with its result, and never
    reach `tile_order` (which only the CUDA launch needs)."""
    args = _frame_taps()

    def no_order(cnt):
        raise AssertionError("tile_order called on the CPU path")

    monkeypatch.setattr(fold_kernel, "tile_order", no_order)
    got = fold_kernel.paint_fold(*args)
    assert torch.equal(got, fold_kernel.paint_fold_torch(*args))
