"""Texture fills in the PyTorch port (`forma_tpu_torch`): the plain
`_texture_at` against JAX's `paint._texture_at` (bit-equal, special
values included), K3's plain fold on texture frames' units against JAX's
XLA wave fold (`forma_tpu.ops.paint.paint`, the fold that paints texture
frames in the JAX package; within 1e-6), and whole texture frames through
`Renderer("cpu").render` against the numpy oracle (<= 1/255 for the e2e
scene and the mix cut, <= 2/255 for random scenes: the JAX package's own
bars, `tests/test_differential.py:127`) and JAX's `Renderer` (<= 1/255,
equal diag vector).  Scenes: the texture e2e scene, random scenes of
`tests/test_differential.py`'s generator with textures, and 64x64 cuts of
the port's `scenes.textured_mix`."""

import types
from pathlib import Path as FsPath

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_scenes import all_scenes
from forma_tpu import Color, Composition, FillRule, Func, Order, Props
from forma_tpu.backend_numpy import render as oracle_render
from forma_tpu.ops import paint as jpaint
from forma_tpu_torch import Renderer
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.ops import fold_kernel, paint
from forma_tpu_torch.ops.fold_kernel import style_layout, variant
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

REPO = FsPath(__file__).resolve().parents[1]
TEXTURE_E2E = "tests__texture__cpu"


def _max_diff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _jax_scenes():
    """The port's `demos/scenes.py` with its names bound to the JAX
    package's classes: the port's own scenes (`textured_mix`) built in
    `forma_tpu`, for the oracle and JAX."""
    src = (REPO / "forma_tpu_torch" / "demos" / "scenes.py").read_text()
    for mod in ("composition", "math", "path", "styling"):
        assert f"from ..{mod} import" in src
        src = src.replace(f"from ..{mod} import", f"from forma_tpu.{mod} import")
    mod = types.ModuleType("port_scenes_on_jax")
    exec(compile(src, "port_scenes_on_jax", "exec"), mod.__dict__)
    return mod


JAX_SCENES = _jax_scenes()


# -- _texture_at -------------------------------------------------------------


def _texture_inputs(case, seed=0, t=24, ah=19, aw=23):
    """tex [T, 10], atlas [AH, AW, 4], integer global pixel coordinates
    xg, yg [T, 256] as f32, made with numpy from a seed.  max_x and max_y
    stay below 2^31 (an image is at most 4096 wide): past that, JAX's int32
    `ax + ix` wraps and the port, which adds in int64 and clamps, reads
    the atlas's last column instead."""
    rng = np.random.default_rng(seed)
    atlas = rng.uniform(0.0, 1.0, (ah, aw, 4)).astype(np.float32)
    w = rng.integers(1, 9, t)
    h = rng.integers(1, 9, t)
    a = rng.uniform(0.0, 2.0 * np.pi, t)
    s = rng.uniform(0.05, 2.0, t)
    tex = np.stack([
        s * np.cos(a), s * np.sin(a), -s * np.sin(a), s * np.cos(a),
        rng.uniform(-40.0, 40.0, t), rng.uniform(-40.0, 40.0, t),
        w - 1.0, h - 1.0,
        rng.integers(0, aw - 8, t), rng.integers(0, ah - 8, t),
    ], axis=1).astype(np.float32)
    if case == "negative":  # coordinates far below 0
        tex[:, 4:6] = rng.uniform(-400.0, -100.0, (t, 2))
    elif case == "past_max":  # past max_x/max_y, offsets at the atlas edge
        tex[:, 4:6] = rng.uniform(100.0, 4e9, (t, 2))
        tex[:, 6:8] = rng.choice([0.0, 3.0, 4095.0, 1e6], (t, 2))
        tex[:, 8] = rng.choice([0, aw - 2, aw - 1, aw, aw + 5], t)
        tex[:, 9] = rng.choice([0, ah - 2, ah - 1, ah, ah + 5], t)
    elif case == "nan_inf":  # NaN and +-inf in the transform lanes
        for lane in range(6):
            rows = rng.random(t) < 0.25
            tex[rows, lane] = rng.choice([np.nan, np.inf, -np.inf], rows.sum())
        mx = tex[:, 6:8]  # max_x, max_y: NaN, never +inf (see above)
        mx[rng.random((t, 2)) < 0.2] = np.nan
        tex[rng.random(t) < 0.2, 8] = np.nan
    tiles_x = 5
    tile = np.arange(t)[:, None]
    j = np.arange(256)[None, :]
    xg = ((tile % tiles_x) * 16 + j % 16).astype(np.float32)
    yg = ((tile // tiles_x) * 16 + j // 16).astype(np.float32)
    return tex, atlas, xg, yg


@pytest.mark.parametrize("case", ["finite", "negative", "past_max", "nan_inf"])
def test_texture_at_matches_jax(case):
    tex, atlas, xg, yg = _texture_inputs(case, seed=len(case))
    t = tex.shape[0]
    want = jpaint._texture_at(
        jnp.asarray(tex), jnp.asarray(atlas),
        jnp.asarray(xg.reshape(t, 16, 16)), jnp.asarray(yg.reshape(t, 16, 16)),
    )
    got = paint._texture_at(*map(torch.from_numpy, (tex, atlas, xg, yg)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32), np.asarray(w).reshape(t, 256).view(np.uint32))


# -- scenes --------------------------------------------------------------------


def _random_textured_scene(seed, w=64, h=64):
    """`tests/test_differential.py:100-120`, textures included."""
    from test_differential import _random_path, _random_style

    rng = np.random.default_rng(seed)
    comp = Composition()
    order = 0
    for _ in range(rng.integers(2, 8)):
        layer = comp.get_mut_or_insert_default(Order(order))
        layer.insert(_random_path(rng, w, h))
        if rng.integers(0, 5) == 0:
            props = Props(fill_rule=FillRule(int(rng.integers(0, 2))),
                          func=Func.Clip(int(rng.integers(1, 3))))
        else:
            props = Props(fill_rule=FillRule(int(rng.integers(0, 2))),
                          func=Func.Draw(_random_style(rng, w, h)))
        layer.set_props(props)
        order += int(rng.integers(1, 3))
    clear = Color(*[float(v) for v in rng.uniform(0, 1, 4)])
    return comp, clear


def _scene(name):
    """(JAX-package composition, clear colour, width, height) by name."""
    if name == TEXTURE_E2E:
        comp = Composition()
        dict(all_scenes())[name](comp)
        return comp, Color(1.0, 1.0, 1.0, 0.0), 64, 64
    if name.startswith("random_"):
        return (*_random_textured_scene(int(name.split("_")[1])), 64, 64)
    comp = Composition()  # "mix-<layers>": a 64x64 cut of textured_mix
    JAX_SCENES.textured_mix(comp, int(name.split("-")[1]), 64, 64)
    return comp, Color(1.0, 1.0, 1.0, 1.0), 64, 64


# -- the fold against JAX's wave fold -----------------------------------------


def _spy(monkeypatch, module, name, results=False):
    """Records each call's positional arguments (or return value)."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out if results else args)
        return out

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("name", [TEXTURE_E2E, "random_9", "mix-40"])
def test_texture_fold_matches_jax_wave_fold(name, monkeypatch):
    """The units, run tables and style tables the port's pipeline hands to
    its fold go through the port's plain fold and through JAX's wave fold
    (`forma_tpu.ops.paint.paint` with no Pallas style rows): linear f32
    pixels within 1e-6."""
    comp, clear, w, h = _scene(name)
    r = Renderer("cpu")
    port_comp = composition_from_jax(comp)
    r.render(port_comp, w, h, clear)  # grows the buckets
    units = _spy(monkeypatch, paint, "_renumber_units", results=True)
    calls = _spy(monkeypatch, paint, "paint")
    r.render(port_comp, w, h, clear)
    key_u, layer_u, src_u, src2_u, virt_u, k_u, u_valid, _ = units[-1]
    (_, _, _, _, _, grid, ci, ca, _, _, clear_t, rows, tiles_x, k_slots, features,
     ms, atlas) = calls[-1][:17]
    assert features.has_texture
    st = r._styles_cache[0]
    got = paint.paint(*calls[-1]).numpy()

    def j(t, dt=None):
        a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        return jnp.asarray(a if dt is None else a.astype(dt))

    want = np.asarray(jpaint.paint(
        j(key_u, np.uint32), j(layer_u, np.int32), j(src_u, np.int32),
        j(src2_u, np.int32), j(virt_u, np.int32), j(k_u, np.int32), j(u_valid),
        j(grid, np.int32), j(ci, np.int32), j(ca, np.int32),
        j(st.orders), j(st.pidx), j(st.fill_rule), j(st.func), j(st.clip_n),
        j(st.is_clipped), j(st.blend), j(st.fill_type), j(st.color), j(st.grad),
        j(st.stops), j(st.tex), j(st.atlas), j(clear_t),
        rows, tiles_x, k_slots, jpaint.Features(*features), presorted=True,
    ))
    assert got.shape == want.shape == (rows * 16, tiles_x * 16, 4)
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_array_equal(atlas.numpy(), st.atlas)


# -- whole frames ----------------------------------------------------------------


@pytest.mark.parametrize("name", [TEXTURE_E2E, "mix-40"])
def test_texture_frame_matches_oracle(name):
    """(paris30k_textured's 256x256 cut: `test_torch_host.py`.)"""
    comp, clear, w, h = _scene(name)
    r = Renderer("cpu")
    got = r.render(composition_from_jax(comp), w, h, clear)
    features = r._styles_cache[0].features
    assert features.has_texture
    if name == "mix-40":
        assert variant(features) == "fold_clip"
    assert _max_diff(got, oracle_render(comp, w, h, clear_color=clear)) <= 1


# Seeds of `test_differential.test_random_scene_device_matches_oracle`,
# where JAX holds the oracle's bar: 1 and 9 are clip-free (the fold_tex
# specialisation), the others have clips.
@pytest.mark.parametrize("seed", [0, 1, 2, 5, 9, 10])
def test_random_textured_scene_matches_oracle(seed):
    comp, clear, w, h = _scene(f"random_{seed}")
    r = Renderer("cpu")
    got = r.render(composition_from_jax(comp), w, h, clear)
    assert r._styles_cache[0].features.has_texture
    assert _max_diff(got, oracle_render(comp, w, h, clear_color=clear)) <= 2


# On mix-60 JAX's own frame is 55/255 from the oracle (the port's equals
# JAX's), so there the port is held to JAX's Renderer.  Two JAX compiles.
@pytest.mark.parametrize("name", [TEXTURE_E2E, "mix-60"])
def test_texture_frame_matches_jax(name):
    from forma_tpu.ops import pipeline as jpipe
    from forma_tpu.renderer import Renderer as JaxRenderer

    comp, clear, w, h = _scene(name)
    r = Renderer("cpu")
    got = r.render(composition_from_jax(comp), w, h, clear)
    jr = JaxRenderer()
    jr._caps = jpipe.Caps(*r._caps)
    want = jr.render(comp, w, h, clear)
    assert _max_diff(got, want) <= 1
    np.testing.assert_array_equal(r.last_diag, np.asarray(jr.last_diag))


def _port_full_frame_layers(top_fill):
    """A port composition: a solid opaque full-frame layer under a
    full-frame layer with `top_fill`, 32x32."""
    import forma_tpu_torch as pt

    comp = pt.Composition()
    rect = (pt.PathBuilder().move_to(pt.Point(0, 0)).line_to(pt.Point(0, 32))
            .line_to(pt.Point(32, 32)).line_to(pt.Point(32, 0)).build())
    for order, fill in enumerate((pt.Fill.Solid(pt.Color(0.2, 0.4, 0.6, 1.0)), top_fill)):
        comp.get_mut_or_insert_default(pt.Order(order)).insert(rect).set_props(
            pt.Props(func=pt.Func.Draw(pt.Style(fill=fill))))
    return comp


def test_texture_styles_are_never_opaque():
    """Texture styles are not "opaque" (`forma_tpu/ops/pipeline.py:131-137`):
    a full-frame opaque texture layer culls nothing below it, where an
    opaque solid one culls the layer below in the tiles it covers whole."""
    import forma_tpu_torch as pt

    image = pt.Image.from_srgba([[200, 10, 10, 255]] * 4, 2, 2)
    tex = pt.Fill.Texture(pt.Texture(transform=pt.AffineTransform(), image=image))
    depth = {}
    for kind, fill in (("texture", tex), ("solid", pt.Fill.Solid(pt.Color(1, 0, 0, 1)))):
        taps = {}
        Renderer("cpu").render_device(_port_full_frame_layers(fill), 32, 32,
                                      pt.Color(1, 1, 1, 1), taps=taps)
        depth[kind] = taps["fold"][1].tolist()  # units per tile
    assert depth["texture"] == [2] * 4
    assert sum(depth["solid"]) < 8  # the solid top layer culls the bottom one


def test_style_layout_appends_texture_lanes():
    f = paint.Features
    assert style_layout(f(has_texture=True), 4) == style_layout(f(), 4)._replace(
        ft=5, tex=6, width=16)
    both = style_layout(f(blend_modes=(0, 3), has_gradient=True, has_texture=True,
                          has_clip=True), 4)
    assert both.tex == both.stops + 20 and both.width == both.tex + 10
    assert variant(f(has_texture=True, has_gradient=True)) == "fold_tex"
    assert variant(f(has_texture=True, has_clip=True)) == "fold_clip"


def test_atlas_uploads_once_across_frames():
    """The renderer's style cache holds the atlas on the device: an
    unchanged scene re-renders without uploading it again; a style edit
    rebuilds the tables."""
    import forma_tpu_torch as pt

    comp, clear, w, h = _scene(TEXTURE_E2E)
    port = composition_from_jax(comp)
    r = Renderer("cpu")
    r.render(port, w, h, clear)
    atlas = r._styles_cache[1]["atlas"]
    r.render(port, w, h, clear)
    assert r._styles_cache[1]["atlas"] is atlas
    port.get_mut(pt.Order(0)).set_props(
        pt.Props(func=pt.Func.Draw(pt.Style(fill=pt.Fill.Solid(pt.Color(0, 0, 0, 1))))))
    r.render(port, w, h, clear)
    assert r._styles_cache[1]["atlas"] is not atlas


def test_texture_fold_dispatch_on_cpu(monkeypatch):
    """CPU tensors take the plain fold; the atlas rides the fold's taps."""
    comp, clear, w, h = _scene("random_9")
    taps = {}
    Renderer("cpu").render_device(composition_from_jax(comp), w, h, clear, taps=taps)
    args = taps["fold"]
    assert variant(args[12]) == "fold_tex" and args[14] is not None
    assert torch.equal(fold_kernel.paint_fold(*args), fold_kernel.paint_fold_torch(*args))
