"""The PyTorch port stands on its own: it imports nothing of `forma_tpu`
or JAX, its copy of the host scene model flattens and stores geometry
bit for bit as the JAX package's does, `convert.composition_from_jax`
carries a scene across with the same segment buffer and style tables,
and `Renderer()` without a device means the CUDA card, never a silent
fall back to the CPU."""

import re
import subprocess
import sys
import types
from pathlib import Path as FsPath

import numpy as np
import pytest
import torch

import forma_tpu
import forma_tpu_torch
from e2e_scenes import all_scenes
from forma_tpu.backend_numpy import render as oracle_render
from forma_tpu.demos import scenes as jax_scenes
from forma_tpu.ops.styles import StyleMap as JaxStyleMap
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.demos import scenes as port_scenes
from forma_tpu_torch.ops.styles import StyleMap
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

REPO = FsPath(__file__).resolve().parents[1]
IMPORT_RE = re.compile(r"^\s*(from|import) forma_tpu(\.|\s|$)", re.M)


def test_import_loads_neither_jax_nor_forma_tpu():
    code = (
        "import sys, forma_tpu_torch, forma_tpu_torch.demos.scenes, "
        "forma_tpu_torch.demos.spaceship, forma_tpu_torch.convert, "
        "forma_tpu_torch.demos.svg, forma_tpu_torch.demos.main, "
        "forma_tpu_torch.profiling, forma_tpu_torch.backend_numpy, forma_tpu_torch.mesh\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.split('.')[0] == 'forma_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_no_source_imports_forma_tpu():
    files = sorted((REPO / "forma_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [str(f.relative_to(REPO)) for f in files if IMPORT_RE.search(f.read_text())]
    assert not bad, bad


def _random_path(pkg, rng, n):
    """A path of `n` random commands of every kind, in package `pkg`."""
    b = pkg.PathBuilder()
    pt = lambda: pkg.Point(*(float(v) for v in rng.uniform(-40.0, 140.0, 2)))  # noqa: E731
    b.move_to(pt())
    for _ in range(n):
        kind = int(rng.integers(0, 6))
        if kind == 0:
            b.line_to(pt())
        elif kind == 1:
            b.quad_to(pt(), pt())
        elif kind == 2:
            b.cubic_to(pt(), pt(), pt())
        elif kind == 3:
            b.rat_quad_to(pt(), pt(), float(rng.uniform(0.2, 3.0)))
        elif kind == 4:
            b.rat_cubic_to(pt(), pt(), pt(), *(float(w) for w in rng.uniform(0.2, 3.0, 2)))
        else:
            b.move_to(pt())
    return b.build()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_path_flattening_is_bit_equal(seed):
    for pkg_rng_seed in range(8):
        paths = [
            _random_path(pkg, np.random.default_rng((seed, pkg_rng_seed)), 12)
            for pkg in (forma_tpu, forma_tpu_torch)
        ]
        a = 0.25 * (pkg_rng_seed + 1)
        m = [np.cos(a), -np.sin(a), 3.5, np.sin(a), np.cos(a), -2.25, 0.0, 0.0, 1.0]
        if pkg_rng_seed % 2:
            paths = [p.transform(m) for p in paths]
        want, got = (p.push_segments_to() for p in paths)
        for w, g in zip(want, got):
            w, g = np.asarray(w), np.asarray(g)
            assert w.dtype == g.dtype and w.shape == g.shape
            if w.dtype == np.float32:
                np.testing.assert_array_equal(w.view(np.uint32), g.view(np.uint32))
            else:
                np.testing.assert_array_equal(w, g)


def _layer_tables(st):
    """Style tables gathered per layer (row order of distinct props is an
    interning detail), plus the frame-wide fields."""
    rows = st.pidx
    per_layer = [
        getattr(st, f)[rows]
        for f in ("fill_rule", "func", "clip_n", "is_clipped", "blend",
                  "fill_type", "color", "grad", "stops", "tex")
    ]
    return [st.orders, *per_layer, st.atlas], (tuple(st.features), st.max_stops)


def _assert_same_scene(comp, port):
    """`port` (a port Composition) holds what `comp` (a JAX-package one)
    holds: segment buffer x/y bit for bit, ids equal up to renumbering,
    the same layers, transforms and enabled flags, and equal style
    tables."""
    x, y, ids = comp.shared_segment_buffer().flat()
    px, py, pids = port.shared_segment_buffer().flat()
    np.testing.assert_array_equal(x.view(np.uint32), px.view(np.uint32))
    np.testing.assert_array_equal(y.view(np.uint32), py.view(np.uint32))
    # ids equal up to renumbering: the same partition, terminators kept.
    np.testing.assert_array_equal(ids == 0, pids == 0)
    pairs = set(zip(ids.tolist(), pids.tolist()))
    assert len({a for a, _ in pairs}) == len(pairs) == len({b for _, b in pairs})

    assert [o.as_u32() for o, _ in comp.layers_iter()] == [
        o.as_u32() for o, _ in port.layers_iter()
    ]
    for (_, jl), (_, pl) in zip(comp.layers_iter(), port.layers_iter()):
        assert jl.is_enabled() == pl.is_enabled()
        assert jl.lines_count == pl.lines_count
        jt, pt = jl.transform(), pl.transform()
        assert (jt is None) == (pt is None)
        if jt is not None:
            assert jt.as_slice() == pt.as_slice()

    want, want_frame = _layer_tables(JaxStyleMap().build(comp.layers))
    got, got_frame = _layer_tables(StyleMap().build(port.layers))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert want_frame == got_frame


def _assert_same_state(comp, port):
    """Both packages' own write paths left the same registry and versions."""
    jr, pr = comp._shared.registry, port._shared.registry
    for f in ("order", "valid", "tform", "has_t", "unchanged"):
        np.testing.assert_array_equal(getattr(jr, f), getattr(pr, f), err_msg=f)
    for f in ("scene_version", "style_version", "tform_version"):
        assert getattr(comp._shared, f) == getattr(port._shared, f), f


@pytest.mark.parametrize("name, build", list(all_scenes()), ids=[n for n, _ in all_scenes()])
def test_composition_from_jax(name, build):
    comp = forma_tpu.Composition()
    build(comp)
    _assert_same_scene(comp, composition_from_jax(comp))


def _port_e2e_scenes():
    """`tests/e2e_scenes.py` with its names bound to the port's classes:
    the same scene code, run through the port's own write path."""
    src = (FsPath(__file__).parent / "e2e_scenes.py").read_text()
    assert src.count("from forma_tpu import (") == 1
    mod = types.ModuleType("e2e_scenes_port")
    exec(compile(src.replace("from forma_tpu import (", "from forma_tpu_torch import ("),
                 "e2e_scenes_port", "exec"), mod.__dict__)
    return dict(mod.all_scenes())


PORT_E2E = _port_e2e_scenes()


@pytest.mark.parametrize("name, build", list(all_scenes()), ids=[n for n, _ in all_scenes()])
def test_port_builds_e2e_scene_as_jax(name, build):
    comp, port = forma_tpu.Composition(), forma_tpu_torch.Composition()
    build(comp)
    PORT_E2E[name](port)
    _assert_same_scene(comp, port)
    _assert_same_state(comp, port)


def _edited_scene(pkg, seed):
    """Layers at random orders, some with two paths, rotations that shrink,
    fill rules, blend modes and colours; one layer disabled, one cleared
    and refilled, one removed and its geometry compacted away."""
    rng = np.random.default_rng(seed)
    comp = pkg.Composition()
    orders = rng.permutation(40)[:12]
    for i, o in enumerate(orders):
        layer = comp.get_mut_or_insert_default(pkg.Order(int(o)))
        layer.insert(_random_path(pkg, rng, 6))
        if i % 3 == 0:
            layer.insert(_random_path(pkg, rng, 4))
        a, s = (float(v) for v in rng.uniform(0.0, 1.0, 2))
        t = [s * np.cos(a), s * np.sin(a), -s * np.sin(a), s * np.cos(a),
             *(float(v) for v in rng.uniform(-8.0, 8.0, 2))]
        layer.set_transform(pkg.AffineTransform(*(float(v) for v in t)))
        color = pkg.Color(*(float(v) for v in rng.uniform(0.0, 1.0, 4)))
        layer.set_props(pkg.Props(
            fill_rule=pkg.FillRule.EvenOdd if i % 2 else pkg.FillRule.NonZero,
            func=pkg.Func.Draw(pkg.Style(
                fill=pkg.Fill.Solid(color),
                blend_mode=list(pkg.BlendMode)[i % len(pkg.BlendMode)],
            )),
        ))
    comp.get_mut(pkg.Order(int(orders[4]))).disable()
    comp.get_mut(pkg.Order(int(orders[5]))).clear().insert(_random_path(pkg, rng, 3))
    comp.remove(pkg.Order(int(orders[7])))
    comp.compact_geom()
    return comp


def _demo_scene(pkg_scenes, pkg, kind):
    comp = pkg.Composition()
    if kind == "circles":
        pkg_scenes.circles(comp, 64, 256, 256)
    elif kind == "textured_mix":
        pkg_scenes.textured_mix(comp, 300, 512, 512)
    elif kind in ("paris30k_styled", "paris30k_textured"):
        getattr(pkg_scenes, kind)(comp, 256, 256, paths=400)
    elif kind == "spaceship":
        # `spaceship` (a module of the demos) built and stepped 3 times.
        ship = pkg_scenes.Spaceship(width=256, height=256)
        ship.build(comp)
        for _ in range(3):
            ship.step()
    else:
        pkg_scenes.paris30k(comp, 256, 256, paths=400)
    return comp


@pytest.mark.parametrize(
    "kind", ["circles", "paris30k", "paris30k_styled", "paris30k_textured",
             "textured_mix", "edited-0", "edited-1", "spaceship"]
)
def test_port_builds_scene_as_jax(kind):
    """The demo scenes (`textured_mix`, the port's own, built through the
    JAX package's classes by `test_torch_texture.JAX_SCENES`; the
    spaceship after 3 steps): equal buffers, registries and style tables,
    the texture atlas included."""
    if kind == "spaceship":
        from forma_tpu.demos import spaceship as jax_spaceship
        from forma_tpu_torch.demos import spaceship as port_spaceship

        comp = _demo_scene(jax_spaceship, forma_tpu, kind)
        port = _demo_scene(port_spaceship, forma_tpu_torch, kind)
    elif kind.startswith("edited"):
        seed = int(kind.split("-")[1])
        comp, port = (_edited_scene(pkg, seed) for pkg in (forma_tpu, forma_tpu_torch))
    elif kind == "textured_mix":
        from test_torch_texture import JAX_SCENES

        comp = _demo_scene(JAX_SCENES, forma_tpu, kind)
        port = _demo_scene(port_scenes, forma_tpu_torch, kind)
        assert JaxStyleMap().build(comp.layers).atlas.shape[0] > 1
    else:
        comp = _demo_scene(jax_scenes, forma_tpu, kind)
        port = _demo_scene(port_scenes, forma_tpu_torch, kind)
    _assert_same_scene(comp, port)
    _assert_same_state(comp, port)


@pytest.mark.parametrize("kind", ["circles", "paris30k", "paris30k_styled",
                                  "paris30k_textured"])
def test_port_built_scene_matches_oracle(kind):
    """The chip smoke test's scenes as the port builds them, rendered by
    the port on the CPU, against the numpy oracle on the JAX-built scene
    (the two scenes are held equal above)."""
    clear = forma_tpu.Color(1.0, 1.0, 1.0, 1.0)
    want = oracle_render(_demo_scene(jax_scenes, forma_tpu, kind), 256, 256, clear_color=clear)
    got = forma_tpu_torch.Renderer("cpu").render(
        _demo_scene(port_scenes, forma_tpu_torch, kind), 256, 256,
        forma_tpu_torch.Color(1.0, 1.0, 1.0, 1.0),
    )
    assert got.shape == want.shape == (256, 256, 4)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_renderer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forma_tpu_torch.Renderer()
    assert forma_tpu_torch.Renderer("cpu").device.type == "cpu"
