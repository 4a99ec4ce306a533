"""Channel orders through the port's `Renderer("cpu").render`: RGBA, BGRA,
BGR1 and RGB0 at 64x64 are exactly the JAX package's `Renderer()` frames
on the CPU, and satisfy the channel identities of
`tests/test_buffers_channels.py:46-58` (`pack_srgb`'s channel selection
and `normalize_channels`)."""

import numpy as np
import pytest

import forma_tpu
import forma_tpu_torch
from forma_tpu.renderer import Renderer as JaxRenderer
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ORDERS = ("RGBA", "BGRA", "BGR1", "RGB0")
CLEAR = (0.25, 0.5, 0.75, 1.0)


def _scene(pkg):
    """`tests/test_buffers_channels.py:30-43`, built from `pkg`'s classes."""
    comp = pkg.Composition()
    p = (
        pkg.PathBuilder().move_to(pkg.Point(8, 8)).line_to(pkg.Point(8, 40))
        .line_to(pkg.Point(40, 40)).line_to(pkg.Point(40, 8)).build()
    )
    comp.get_mut_or_insert_default(pkg.Order(0)).insert(p).set_props(
        pkg.Props(func=pkg.Func.Draw(pkg.Style(fill=pkg.Fill.Solid(pkg.Color(0.9, 0.1, 0.2, 0.8)))))
    )
    return comp


@pytest.fixture(scope="module")
def frames():
    """{order: (port frame, JAX frame)}, one renderer of each package."""
    port, jax = forma_tpu_torch.Renderer("cpu"), JaxRenderer()
    pc, jc = _scene(forma_tpu_torch), _scene(forma_tpu)
    return {
        name: (
            port.render(pc, 64, 64, forma_tpu_torch.Color(*CLEAR),
                        channels=getattr(forma_tpu_torch, name)),
            jax.render(jc, 64, 64, forma_tpu.Color(*CLEAR), channels=getattr(forma_tpu, name)),
        )
        for name in ORDERS
    }


@pytest.mark.parametrize("name", ORDERS)
def test_channel_order_matches_jax(frames, name):
    got, want = frames[name]
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (64, 64, 4)
    np.testing.assert_array_equal(got, want)


def test_channel_identities(frames):
    rgba, bgra, bgr1, rgb0 = (frames[name][0] for name in ORDERS)
    assert (rgba[..., :3] != rgba[0, 0, :3]).any()  # the square is painted
    np.testing.assert_array_equal(bgra[..., 0], rgba[..., 2])
    np.testing.assert_array_equal(bgra[..., 2], rgba[..., 0])
    np.testing.assert_array_equal(bgra[..., 3], rgba[..., 3])
    np.testing.assert_array_equal(bgr1[..., 3], np.full((64, 64), 255))
    np.testing.assert_array_equal(rgb0[..., 3], np.zeros((64, 64)))
    np.testing.assert_array_equal(rgb0[..., :3], rgba[..., :3])
