"""The port's numpy oracle (`forma_tpu_torch.backend_numpy`) against the
JAX package's (`forma_tpu.backend_numpy`): bit-equal u8 frames on every
e2e scene (each built through the port's own write path, as
`test_torch_host.py` builds them) and on random styled scenes of
`test_torch_render.py`'s generator; stage by stage (line view, sorted
pixel segments, linear f32 pixels) bit-equal on the SVG sample and the
circles; and the channel orders and crops the same."""

import numpy as np
import pytest

import forma_tpu
import forma_tpu_torch
from e2e_scenes import all_scenes
from forma_tpu.backend_numpy import lines as jlines
from forma_tpu.backend_numpy import paint as jpaint
from forma_tpu.backend_numpy import raster as jraster
from forma_tpu.backend_numpy import render as jax_oracle
from forma_tpu.demos import scenes as jax_scenes
from forma_tpu.demos.svg import Svg as JaxSvg
from forma_tpu_torch.backend_numpy import lines, paint, raster
from forma_tpu_torch.backend_numpy import render as oracle
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.demos import scenes
from forma_tpu_torch.demos.svg import Svg
from test_torch_host import PORT_E2E
from test_torch_render import _random_styled_scene
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

E2E_CLEAR = (1.0, 1.0, 1.0, 0.0)  # the goldens' clear colour


@pytest.mark.parametrize("name, build", list(all_scenes()), ids=[n for n, _ in all_scenes()])
def test_e2e_scene_is_bit_equal(name, build):
    comp, port = forma_tpu.Composition(), forma_tpu_torch.Composition()
    build(comp)
    PORT_E2E[name](port)
    want = jax_oracle(comp, 64, 64, clear_color=forma_tpu.Color(*E2E_CLEAR))
    got = oracle(port, 64, 64, clear_color=forma_tpu_torch.Color(*E2E_CLEAR))
    assert got.dtype == np.uint8 and got.shape == (64, 64, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 4, 13])
def test_random_styled_scene_is_bit_equal(seed):
    comp, clear = _random_styled_scene(seed)
    want = jax_oracle(comp, 64, 64, clear_color=clear)
    got = oracle(composition_from_jax(comp), 64, 64,
                 clear_color=forma_tpu_torch.Color(*clear.to_array()))
    np.testing.assert_array_equal(got, want)


def _pair(name):
    """(JAX composition, port composition) of the SVG sample or circles."""
    comp, port = forma_tpu.Composition(), forma_tpu_torch.Composition()
    if name == "svg":
        JaxSvg(scenes.SVG_SAMPLE).compose(comp)
        Svg(scenes.SVG_SAMPLE).compose(port)
    else:
        jax_scenes.circles(comp, 16, 64, 64)
        scenes.circles(port, 16, 64, 64)
    return comp, port


def _view(pkg_lines, comp):
    comp.compact_geom()
    return pkg_lines.fill_view(
        comp.shared_segment_buffer(), 64, 64, comp.layers,
        {int(k): v for k, v in comp.geom_id_to_order().items()},
    )


def _assert_fields_equal(got, want, fields):
    for f in fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("name", ["svg", "circles"])
def test_stages_are_bit_equal(name):
    comp, port = _pair(name)
    jv, pv = _view(jlines, comp), _view(lines, port)
    _assert_fields_equal(pv, jv, ("orders", "x0", "y0", "dx", "dy", "a", "b", "c", "d",
                                  "lengths"))
    js, ps = jraster.sort(jraster.rasterize(jv)), raster.sort(raster.rasterize(pv))
    assert len(ps) == len(js) > 0
    _assert_fields_equal(ps, js, ("layer", "tile_x", "tile_y", "local_x", "local_y",
                                  "double_area", "cover"))
    jp = {o.as_u32(): layer.props for o, layer in comp.layers.items()}
    pp = {o.as_u32(): layer.props for o, layer in port.layers.items()}
    want = jpaint.paint(js, jp.__getitem__, 64, 64, forma_tpu.Color(1.0, 1.0, 1.0, 1.0))
    got = paint.paint(ps, pp.__getitem__, 64, 64, forma_tpu_torch.Color(1.0, 1.0, 1.0, 1.0))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("channels", ["BGRA", "RGB0", "BGR1"])
def test_channels_and_crop_are_bit_equal(channels):
    comp, port = _pair("svg")
    clear = (0.2, 0.4, 0.6, 0.8)
    for crop in (None, (range(1, 3), range(0, 2))):
        want = jax_oracle(comp, 64, 64, forma_tpu.Color(*clear),
                          getattr(forma_tpu, channels), crop)
        got = oracle(port, 64, 64, forma_tpu_torch.Color(*clear),
                     getattr(forma_tpu_torch, channels), crop)
        np.testing.assert_array_equal(got, want)
