"""The PyTorch port's slice as a whole: `forma_tpu_torch.Renderer.render`
on the CPU (every kernel's plain PyTorch version) against the numpy
oracle and the JAX `Renderer.render`.  Scenes are built in `forma_tpu`
(for JAX and the oracle) and handed to the port through
`convert.composition_from_jax`.  Max channel diff <= 1/255, the bar for a
device backend (the HSL blend modes <= 5/255, random gradient/blend/clip
scenes <= 2/255: the JAX package's own bars, `tests/test_differential.py:
127`); the diagnostics vector must equal JAX's.  Every e2e scene renders
(the texture one here and in `test_torch_texture.py`).  Also: the port
imports no JAX, `convert` carries the JAX package's frame state across,
and no kernel launches on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from e2e_scenes import all_scenes
from forma_tpu import (
    AffineTransform, Color, Composition, Fill, FillRule, Func, Order,
    PathBuilder, Point, Props, Style,
)
from forma_tpu.backend_numpy import render as oracle_render
from forma_tpu.demos import scenes
from forma_tpu_torch import Caps, Renderer
from forma_tpu_torch.convert import composition_from_jax, from_jax_args
from forma_tpu_torch.ops import _build, pipeline
from forma_tpu_torch.ops.paint import Features

CLEAR = Color(1.0, 1.0, 1.0, 1.0)
SOLID_E2E = [
    "tests__solid_color__blue__cpu", "tests__solid_color__dark_blue__cpu",
    "tests__solid_color__red__cpu", "tests__solid_color__dark_red__cpu",
    "tests__solid_color__green__cpu", "tests__solid_color__dark_green__cpu",
    "tests__solid_color__transparent_black__cpu", "tests__pixel__cpu",
    "tests__covers__cpu", "tests__fill_rules__EvenOdd__cpu",
    "tests__fill_rules__NonZero__cpu",
]


def _max_diff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _circles(n=16, w=64, h=64):
    comp = Composition()
    scenes.circles(comp, n, w, h)
    return comp


def test_circles_matches_jax_and_oracle():
    from forma_tpu.ops import pipeline as jpipe
    from forma_tpu.renderer import Renderer as JaxRenderer

    comp = _circles()
    r = Renderer("cpu")
    got = r.render(composition_from_jax(comp), 64, 64, CLEAR)
    assert got.shape == (64, 64, 4) and got.dtype == np.uint8
    assert _max_diff(got, oracle_render(comp, 64, 64, clear_color=CLEAR)) <= 1

    # Same buckets as the port's grown ones: one JAX compile, no regrow.
    jr = JaxRenderer()
    jr._caps = jpipe.Caps(*r._caps)
    want = jr.render(comp, 64, 64, CLEAR)
    assert _max_diff(got, want) <= 1
    np.testing.assert_array_equal(r.last_diag, np.asarray(jr.last_diag))
    assert tuple(r._caps) == tuple(jr._caps)


@pytest.mark.parametrize("name", SOLID_E2E)
def test_solid_e2e_scene_matches_oracle(name):
    build = dict(all_scenes())[name]
    comp = Composition()
    build(comp)
    r = Renderer("cpu")
    got = r.render(composition_from_jax(comp), 64, 64, Color(1.0, 1.0, 1.0, 0.0))
    assert r._styles_cache[0].features == Features()
    want = oracle_render(comp, 64, 64, clear_color=Color(1.0, 1.0, 1.0, 0.0))
    assert _max_diff(got, want) <= 1


STYLED_E2E = [n for n, _ in all_scenes() if n not in SOLID_E2E]
HSL_MODES = ("Hue", "Saturation", "Color", "Luminosity")


@pytest.mark.parametrize("name", STYLED_E2E)
def test_styled_e2e_scene_matches_oracle(name):
    """The gradient, texture, blend-mode and clipping e2e scenes."""
    build = dict(all_scenes())[name]
    comp = Composition()
    build(comp)
    r = Renderer("cpu")
    got = r.render(composition_from_jax(comp), 64, 64, Color(1.0, 1.0, 1.0, 0.0))
    assert r._styles_cache[0].features != Features() or "Over" in name
    want = oracle_render(comp, 64, 64, clear_color=Color(1.0, 1.0, 1.0, 0.0))
    bar = 5 if any(f"__{m}__" in name for m in HSL_MODES) else 1
    assert _max_diff(got, want) <= bar


def test_styled_e2e_scene_count():
    assert len(SOLID_E2E) + len(STYLED_E2E) == len(list(all_scenes())) == 32


def _random_path(rng, w, h):
    p = PathBuilder()
    n = int(rng.integers(2, 6))
    pts = rng.uniform(-0.25 * w, 1.25 * w, size=(n + 1, 6)).astype(np.float32)
    p.move_to(Point(float(pts[0, 0]), float(pts[0, 1])))
    for i in range(1, n + 1):
        kind = rng.integers(0, 3)
        q = [Point(float(pts[i, 2 * c]), float(pts[i, 2 * c + 1])) for c in range(3)]
        if kind == 0:
            p.line_to(q[0])
        elif kind == 1:
            p.quad_to(q[0], q[1])
        else:
            p.cubic_to(*q)
    return p.build()


@pytest.mark.parametrize("seed, size, layers", [(11, 64, 8), (12, 128, 48)])
def test_random_solid_scene_matches_oracle(seed, size, layers):
    """Random paths, solid fills of random alpha, both fill rules, some
    layer transforms: the style of `tests/test_differential.py`, restricted
    to the port's slice."""
    rng = np.random.default_rng(seed)
    comp = Composition()
    order = 0
    for _ in range(layers):
        layer = comp.get_mut_or_insert_default(Order(order))
        layer.insert(_random_path(rng, size, size))
        color = Color(*[float(v) for v in rng.uniform(0, 1, 4)])
        layer.set_props(Props(
            fill_rule=FillRule(int(rng.integers(0, 2))),
            func=Func.Draw(Style(fill=Fill.Solid(color))),
        ))
        if rng.integers(0, 4) == 0:
            a = float(rng.uniform(-0.5, 0.5))
            layer.set_transform(AffineTransform(
                ux=np.cos(a), uy=np.sin(a), vx=-np.sin(a), vy=np.cos(a),
                tx=float(rng.uniform(-8, 8)), ty=float(rng.uniform(-8, 8)),
            ))
        order += int(rng.integers(1, 3))
    clear = Color(*[float(v) for v in rng.uniform(0, 1, 4)])
    got = Renderer("cpu").render(composition_from_jax(comp), size, size, clear)
    want = oracle_render(comp, size, size, clear_color=clear)
    assert _max_diff(got, want) <= 1


def _random_styled_scene(seed, w=64, h=64):
    """`tests/test_differential.py:100-120` with `textures=False` and up to
    11 layers, a quarter of them clips."""
    from test_differential import _random_path as path, _random_style

    rng = np.random.default_rng(seed)
    comp = Composition()
    order = 0
    for _ in range(rng.integers(2, 12)):
        layer = comp.get_mut_or_insert_default(Order(order))
        layer.insert(path(rng, w, h))
        if rng.integers(0, 4) == 0:
            props = Props(fill_rule=FillRule(int(rng.integers(0, 2))),
                          func=Func.Clip(int(rng.integers(1, 3))))
        else:
            props = Props(fill_rule=FillRule(int(rng.integers(0, 2))),
                          func=Func.Draw(_random_style(rng, w, h, textures=False)))
        layer.set_props(props)
        order += int(rng.integers(1, 3))
    clear = Color(*[float(v) for v in rng.uniform(0, 1, 4)])
    return comp, clear


# Seeds 4, 13 and 22 are left out here: on them the JAX package's own frame
# is 3, 45 and 7/255 from the oracle.  The port is held to JAX's Renderer on
# those seeds (test_styled_scene_matches_jax), so a fault of the port there
# still shows.
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 6])
def test_random_styled_scene_matches_oracle(seed):
    comp, clear = _random_styled_scene(seed)
    r = Renderer("cpu")
    got = r.render(composition_from_jax(comp), 64, 64, clear)
    assert r._styles_cache[0].features.has_clip
    assert _max_diff(got, oracle_render(comp, 64, 64, clear_color=clear)) <= 2


@pytest.mark.parametrize(
    "name", ["tests__radial_gradient__cpu", "tests__blend_modes__Hue__cpu",
             "tests__clipping__cpu", "random_4", "random_13", "random_22"],
)
def test_styled_scene_matches_jax(name):
    """Same frames and diag vector as the JAX Renderer: three e2e scenes,
    and the random scenes (`random_<seed>`) where JAX differs from the
    oracle."""
    from forma_tpu.ops import pipeline as jpipe
    from forma_tpu.renderer import Renderer as JaxRenderer

    if name.startswith("random_"):
        comp, clear = _random_styled_scene(int(name.split("_")[1]))
    else:
        comp, clear = Composition(), Color(1.0, 1.0, 1.0, 0.0)
        dict(all_scenes())[name](comp)
    r = Renderer("cpu")
    got = r.render(composition_from_jax(comp), 64, 64, clear)
    jr = JaxRenderer()
    jr._caps = jpipe.Caps(*r._caps)
    want = jr.render(comp, 64, 64, clear)
    assert _max_diff(got, want) <= 1
    np.testing.assert_array_equal(r.last_diag, np.asarray(jr.last_diag))


def test_import_leaves_jax_out():
    code = (
        "import sys, forma_tpu_torch, forma_tpu_torch.convert, "
        "forma_tpu_torch.ops.pipeline; assert 'jax' not in sys.modules; "
        "assert not [m for m in sys.modules if m.split('.')[0] == 'forma_tpu']"
    )
    subprocess.run([sys.executable, "-c", code], check=True)


def test_unported_entry_points_raise():
    comp = composition_from_jax(_circles(4))
    r = Renderer("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        r.render(comp, 64, 64, CLEAR, crop=object())
    for call in (r.render_into, r.create_buffer_layer_cache,
                 r.render_device_sharded, r.render_device_sharded_lines):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_convert_round_trips_graft_prep():
    """`from_jax_args` takes `__graft_entry__._prep`'s tuple: every leaf
    keeps its values (u32 -> int64), and the port renders the same frame
    from it as through its own Renderer."""
    import __graft_entry__

    args, features = __graft_entry__._prep(64, 64, n_circles=16, use_cache=False)
    np_args = tuple(
        {k: np.asarray(v) for k, v in a.items()} if isinstance(a, dict) else np.asarray(a)
        for a in args
    )
    got = from_jax_args(np_args, "cpu")
    for a, t in zip(np_args, got):
        pairs = [(a[k], t[k]) for k in a] if isinstance(a, dict) else [(a, t)]
        for x, y in pairs:
            assert y.device.type == "cpu"
            want_dt = np.int64 if x.dtype == np.uint32 else x.dtype
            assert y.numpy().dtype == want_dt
            np.testing.assert_array_equal(y.numpy(), x.astype(want_dt))
    assert got[7]["orders"].dtype == torch.int64

    r = Renderer("cpu")
    want = r.render(composition_from_jax(_circles(16)), 64, 64, CLEAR)
    frame, diag = pipeline.render_frame(
        *got, 64, 64, 4, 4, Caps(*r._caps), Features(*features), (0, 1, 2, 3),
    )
    np.testing.assert_array_equal(frame.numpy(), want)
    np.testing.assert_array_equal(diag.numpy(), r.last_diag)


def test_no_kernel_launches_on_cpu():
    _build.reset_launches()
    comp = composition_from_jax(_circles(8))
    for expand in ("fused", "split"):
        Renderer("cpu", expand=expand).render(comp, 64, 64, CLEAR)
    comp, clear = _random_styled_scene(0)
    Renderer("cpu").render(composition_from_jax(comp), 64, 64, clear)
    comp = Composition()
    dict(all_scenes())["tests__texture__cpu"](comp)
    Renderer("cpu").render(composition_from_jax(comp), 64, 64, CLEAR)
    assert set(_build.LAUNCHES) == {
        "expand", "rasterize", "grid", "fold", "fold_styled", "fold_tex", "fold_clip",
        "texture_probe", "fold_ablate", "unit_stream", "seg_loop", "grid_scatter"}
    assert not any(_build.LAUNCHES.values())
