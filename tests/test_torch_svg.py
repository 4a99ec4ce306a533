"""The port's SVG front end (`forma_tpu_torch.demos.svg`) and
`paris30k_svg_text` against the JAX package's: the parser's pieces give
equal results; a parsed document composes into the same segment buffer,
registry and style tables in both packages (`test_torch_host.py`'s
checks); the paris SVG text is byte-equal; a pan moves only transforms.
The parsed 512x288 paris renders on `Renderer("cpu")` within 3/255 of the
directly built scene (`tests/test_svg_roundtrip.py`'s bound: fills pass
through 8-bit hex) and within 1/255 of JAX's `Renderer.render` of the
JAX package's parse (the device bar)."""

import math

import numpy as np
import pytest

import forma_tpu
import forma_tpu_torch
from forma_tpu.demos import scenes as jax_scenes
from forma_tpu.demos import svg as jax_svg
from forma_tpu_torch.demos import scenes as port_scenes
from forma_tpu_torch.demos import svg as port_svg
from test_svg import SVG
from test_torch_host import _assert_same_scene, _assert_same_state
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

CLEAR_J = forma_tpu.Color(1.0, 1.0, 1.0, 1.0)
CLEAR = forma_tpu_torch.Color(1.0, 1.0, 1.0, 1.0)
PARIS = (512, 288, 400)


@pytest.mark.parametrize("value, want", [
    ("#fff", (255, 255, 255)), ("#102030", (16, 32, 48)), ("rgb(1, 2, 3)", (1, 2, 3)),
    ("red", (255, 0, 0)), ("none", None), ("rgb(50%, 0%, 100%)", (128, 0, 255)),
    ("#12", None), ("", None), ("GREY", (128, 128, 128)), ("chartreuse", None),
])
def test_parse_color(value, want):
    got = port_svg.parse_color(value)
    assert got == jax_svg.parse_color(value)
    assert got == want


@pytest.mark.parametrize("value, want", [
    ("translate(10, 5) scale(2)", [2.0, 0.0, 0.0, 2.0, 10.0, 5.0]),
    ("matrix(1 2 3 4 5 6)", [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
    ("rotate(30 5 7) skewX(10)", None),
    ("scale(2 3) translate(1) skewY(-5)", None),
])
def test_parse_transform(value, want):
    got = port_svg.parse_transform(value).to_array()
    assert got == jax_svg.parse_transform(value).to_array()
    if want is not None:
        assert got == want
    assert port_svg.parse_transform("") is None


def test_blend_modes_and_path_tokens():
    for name, mode in port_svg._BLEND_MODES.items():
        style = f"fill: red; mix-blend-mode: {name}"
        assert port_svg.parse_blend_mode(style) is mode
        assert jax_svg.parse_blend_mode(style).name == mode.name
    assert port_svg.parse_blend_mode("") is port_svg.BlendMode.Over
    d = "M1,2 3 4l5-6h7V8c1 2 3 4 5 6s1 1 2 2Q1 1 2 2t3 3A5 5 0 1 0 9 9 Z m1e1 .5z"
    got = list(port_svg._tokenize_path(d))
    assert got == list(jax_svg._tokenize_path(d))
    assert [c for c, _ in got] == list("MLlhVcsQtAZmz")


@pytest.mark.parametrize("args", [
    (10.0, 10.0, 0.0, True, False, 8.0, 44.0, 28.0, 44.0),
    (10.0, 5.0, math.radians(30.0), False, True, 0.0, 0.0, 12.0, 7.0),
    (2.0, 2.0, 0.0, False, False, 0.0, 0.0, 30.0, 0.0),  # radii scale up
    (0.0, 5.0, 0.0, False, False, 0.0, 0.0, 1.0, 1.0),  # zero radius: a line
    (5.0, 5.0, 0.0, False, False, 3.0, 3.0, 3.0, 3.0),  # no arc
])
def test_convert_to_center(args):
    got = port_svg._convert_to_center(*args)
    want = jax_svg._convert_to_center(*args)
    assert (got is None) == (want is None)
    if got is not None:
        assert vars(got) == vars(want)


def _parse_both(text, scale=1.0):
    jsvg, psvg = jax_svg.Svg(text, scale=scale), port_svg.Svg(text, scale=scale)
    comp, port = forma_tpu.Composition(), forma_tpu_torch.Composition()
    jsvg.compose(comp)
    psvg.compose(port)
    return jsvg, psvg, comp, port


def test_sample_document_is_test_svg():
    assert port_scenes.SVG_SAMPLE == SVG


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_sample_document_parses_as_jax(scale):
    jsvg, psvg, comp, port = _parse_both(port_scenes.SVG_SAMPLE, scale)
    assert len(psvg.paths) == len(jsvg.paths) == 5
    assert [(fr.name, bm.name) for _, fr, _, bm in psvg.paths] == [
        (fr.name, bm.name) for _, fr, _, bm in jsvg.paths]
    _assert_same_scene(comp, port)
    _assert_same_state(comp, port)


@pytest.mark.parametrize("size", [(64, 64, 10), PARIS, (1920, 1080, 30000)])
def test_paris_svg_text_is_byte_equal(size):
    text = port_scenes.paris30k_svg_text(*size)
    assert text == jax_scenes.paris30k_svg_text(*size)
    assert text.count("<path") == size[2]


def test_paris_svg_parses_as_jax():
    jsvg, psvg, comp, port = _parse_both(port_scenes.paris30k_svg_text(*PARIS))
    _assert_same_scene(comp, port)
    _assert_same_state(comp, port)


def test_pan_keeps_version():
    """A pan is a transform on every layer: the segment buffer keeps its
    version, and both packages hold the same transforms and versions."""
    jsvg, psvg, comp, port = _parse_both(SVG)
    v0 = port.shared_segment_buffer().version
    for i in (1, 2, 3):
        jsvg.compose(comp, pan_x=2.0 * i, pan_y=0.5)
        psvg.compose(port, pan_x=2.0 * i, pan_y=0.5)
        assert port.shared_segment_buffer().version == v0
        _assert_same_scene(comp, port)
        _assert_same_state(comp, port)
    assert [pl.transform().as_slice() for _, pl in port.layers_iter()] == [
        [1.0, 0.0, 0.0, 1.0, -6.0, 0.5]] * 5


def _max_diff(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_parsed_paris_renders_as_direct_and_jax(scale):
    """The parsed paris on the port's CPU renderer: within 3/255 of the
    direct scene (at scale 1) and within 1/255 of JAX's render of its own
    parse with the same buckets, with the same diag vector.  At `-s 2` a
    half-size document fills the frame."""
    from forma_tpu.ops import pipeline as jpipe
    from forma_tpu.renderer import Renderer as JaxRenderer

    w, h, paths = PARIS
    doc = (w, h) if scale == 1.0 else (w // 2, h // 2)
    _, _, comp, port = _parse_both(port_scenes.paris30k_svg_text(*doc, paths=paths), scale)
    r = forma_tpu_torch.Renderer("cpu")
    got = r.render(port, w, h, CLEAR)
    assert (got[..., :3] != 255).any()
    if scale == 1.0:
        direct = forma_tpu_torch.Composition()
        port_scenes.paris30k(direct, w, h, paths=paths)
        assert _max_diff(got, forma_tpu_torch.Renderer("cpu").render(direct, w, h, CLEAR)) <= 3
    jr = JaxRenderer()
    jr._caps = jpipe.Caps(*r._caps)
    assert _max_diff(got, jr.render(comp, w, h, CLEAR_J)) <= 1
    np.testing.assert_array_equal(r.last_diag, np.asarray(jr.last_diag))
