"""K3 of the PyTorch port (`forma_tpu_torch/ops/fold_kernel.py`) and its
unit passes: the fold's plain PyTorch version against the JAX
`paint._paint_fold_pallas(..., presorted=True)` in interpret mode, on the
fold inputs the port's own pipeline hands over (table mode for clip-free
frames; JAX takes its assembly prep for clip frames).  Scenes cover both
fill rules, virtual (gap) units, alpha < 1, a tile deeper than 16 units,
linear and radial gradients, every non-Over blend mode, clip masks with
expiry and random mixed scenes.  Linear f32 pixels within 1e-6 (0
expected), measured at most 2.4e-7; a random scene with ColorBurn over
gradient fills within 1e-5 (measured 1.4e-6): XLA:CPU rounds a gradient
or blend chain an ulp apart (contraction into FMA) and ColorBurn's
`(1 - d) / s` by a small source channel magnifies it.
`style_pack_for_fold` and `skip_trivial_clips_keep` are held bit-equal to
JAX's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forma_tpu import (
    BlendMode, Color, Composition, Fill, Func, GradientBuilder, Order, PathBuilder,
    Point, Props, Style,
)
from forma_tpu.ops import paint as jpaint
from forma_tpu.styling import FillRule, GradientType
from forma_tpu_torch import Renderer
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.ops import paint
from forma_tpu_torch.ops.fold_kernel import (
    fold_tiles, paint_fold, paint_fold_torch, style_layout, tile_spans,
)
from forma_tpu_torch.ops.pipeline import DIAG_K
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

CLEAR = Color(1.0, 1.0, 1.0, 1.0)


def _rect(x0, y0, x1, y1):
    return (
        PathBuilder().move_to(Point(x0, y0)).line_to(Point(x0, y1))
        .line_to(Point(x1, y1)).line_to(Point(x1, y0)).build()
    )


def _draw(comp, order, path, style, fill_rule=FillRule.NonZero):
    comp.get_mut_or_insert_default(Order(order)).insert(path).set_props(
        Props(fill_rule=fill_rule, func=Func.Draw(style))
    )


def _solid(comp, order, path, rgba, fill_rule=FillRule.NonZero, **style):
    _draw(comp, order, path, Style(fill=Fill.Solid(Color(*rgba)), **style), fill_rule)


def _clip(comp, order, path, n, fill_rule=FillRule.NonZero):
    comp.get_mut_or_insert_default(Order(order)).insert(path).set_props(
        Props(fill_rule=fill_rule, func=Func.Clip(n))
    )


def _alpha_multi_tile(comp):
    _solid(comp, 0, _rect(4, 4, 29, 29), (1, 0, 0, 1))
    _solid(comp, 1, _rect(20, 10, 45, 35), (0, 1, 0, 0.5))
    _solid(comp, 2, _rect(9, 18, 60, 44), (0, 0, 1, 0.8))


def _virtual_and_fill_rules(comp):
    _solid(comp, 0, _rect(2, 2, 120, 30), (0.2, 0.4, 0.9, 1))
    star = (
        PathBuilder().move_to(Point(60, 34)).line_to(Point(80, 62))
        .line_to(Point(40, 44)).line_to(Point(84, 44)).line_to(Point(44, 62)).build()
    )
    _solid(comp, 1, star, (0.9, 0.5, 0.1, 0.7), FillRule.EvenOdd)
    _solid(comp, 2, _rect(-20, 40, 140, 60), (0.1, 0.8, 0.3, 0.6), FillRule.EvenOdd)


def _deep_stack(comp):
    rng = np.random.default_rng(7)
    for i in range(40):
        x, y = (float(v) for v in rng.uniform(0, 24, 2))
        rgba = (*(float(v) for v in rng.uniform(0.1, 1.0, 3)), 0.35)
        _solid(comp, i, _rect(x, y, x + 8, y + 8), rgba)


# The scenes of `tests/test_paint_pallas.py:119-275`, the blend-mode scene
# widened to all 15 non-Over modes.


def _gradient_fills(comp):
    lin = (
        GradientBuilder(Point(0, 0), Point(64, 64)).color(Color(1, 0, 0, 1))
        .color(Color(0, 1, 0, 0.8)).color(Color(0, 0, 1, 1)).build()
    )
    rad = (
        GradientBuilder(Point(40, 40), Point(80, 40)).type(GradientType.Radial)
        .color(Color(1, 1, 0, 0.9)).color(Color(0, 1, 1, 0.3)).build()
    )
    _draw(comp, 0, _rect(2, 2, 62, 62), Style(fill=Fill.Gradient(lin)))
    _draw(comp, 1, _rect(20, 10, 78, 58), Style(fill=Fill.Gradient(rad)))
    _solid(comp, 2, _rect(30, 30, 50, 50), (0, 0, 0, 0.5))


def _blend_modes(comp):
    _solid(comp, 0, _rect(0, 0, 96, 48), (0.8, 0.3, 0.5, 1))
    for i, mode in enumerate(list(BlendMode)[1:]):
        x = 4 + 6 * i
        _solid(comp, i + 1, _rect(x, 4 + 2 * i, x + 22, 44), (0.2, 0.9, 0.4, 0.7),
               blend_mode=mode)


def _clip_masks(comp):
    tri = (
        PathBuilder().move_to(Point(4, 4)).line_to(Point(60, 8))
        .line_to(Point(30, 60)).build()
    )
    _clip(comp, 0, tri, 2)
    _solid(comp, 1, _rect(0, 0, 40, 40), (1, 0, 0, 0.8), is_clipped=True)
    _solid(comp, 2, _rect(20, 20, 64, 64), (0, 1, 0, 0.6), is_clipped=True)
    _solid(comp, 3, _rect(50, 2, 62, 30), (0, 0, 1, 1))
    circle_ish = (
        PathBuilder().move_to(Point(10, 44)).quad_to(Point(32, 20), Point(54, 44))
        .quad_to(Point(32, 62), Point(10, 44)).build()
    )
    _clip(comp, 5, circle_ish, 1, FillRule.EvenOdd)
    _solid(comp, 6, _rect(0, 30, 64, 64), (0.5, 0, 0.5, 0.9), is_clipped=True)


def _random_mixed(seed):
    """`tests/test_paint_pallas.py:249-275` with `textures=False`."""
    from test_differential import _random_path, _random_style

    def build(comp):
        rng = np.random.default_rng(seed)
        order = 0
        for _ in range(rng.integers(4, 10)):
            layer = comp.get_mut_or_insert_default(Order(order))
            layer.insert(_random_path(rng, 96, 64))
            if rng.integers(0, 5) == 0:
                props = Props(fill_rule=FillRule(int(rng.integers(0, 2))),
                              func=Func.Clip(int(rng.integers(1, 3))))
            else:
                props = Props(fill_rule=FillRule(int(rng.integers(0, 2))),
                              func=Func.Draw(_random_style(rng, 96, 64, textures=False)))
            layer.set_props(props)
            order += int(rng.integers(1, 3))

    return build


def _spy(monkeypatch, module, name):
    """Records the positional arguments of `module.name` on each call."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


def _fold_inputs(build, w, h, monkeypatch):
    """The arguments `paint.paint` hands to `fold_tiles` when the port's
    own pipeline renders the scene (after one render grew the buckets):
    (key_u, u_valid, src_u, src2_u, virt_u, grid, carry_in_s,
    carry_after_s, tx_s, style_s, clear, rows, tiles_x, k_slots, features,
    ms, atlas), and the diag vector."""
    jax_comp = Composition()
    build(jax_comp)
    comp = composition_from_jax(jax_comp)
    r = Renderer("cpu")
    r.render(comp, w, h, CLEAR)
    seen = _spy(monkeypatch, paint, "fold_tiles")
    r.render(comp, w, h, CLEAR)
    return seen[-1], r.last_diag


def _jax_fold(args):
    """JAX's interpret-mode Pallas fold on the same inputs.  On the
    presorted path src_u == src2_u, and the prep reads neither layer_u nor
    k_u (zeros here)."""
    (key_u, u_valid, src_u, src2_u, virt_u, grid, ci, ca, tx_s, style_s, clear,
     rows, tiles_x, k_slots, features, ms, _atlas) = args

    def j(t, dt):
        return jnp.asarray(t.numpy().astype(dt))

    zeros = jnp.zeros(key_u.shape, jnp.int32)
    return np.asarray(
        jpaint._paint_fold_pallas(
            j(key_u, np.uint32), zeros, j(src_u, np.int32), j(src2_u, np.int32),
            j(virt_u, np.int32), zeros, jnp.asarray(u_valid.numpy()),
            j(grid, np.int32), j(ci, np.int32), j(ca, np.int32),
            j(style_s, np.int32), jnp.asarray(clear.numpy()),
            rows, tiles_x, k_slots, jpaint.Features(*features), ms,
            tx_s=j(tx_s, np.int32), presorted=True, interpret=True,
        )
    )


@pytest.mark.parametrize(
    "build, w, h",
    [(_alpha_multi_tile, 64, 48), (_virtual_and_fill_rules, 128, 64), (_deep_stack, 32, 32)],
    ids=["alpha_multi_tile", "virtual_and_fill_rules", "deep_stack"],
)
def test_fold_matches_pallas_table_mode(build, w, h, monkeypatch):
    args, diag = _fold_inputs(build, w, h, monkeypatch)
    virt_u, u_valid, features = args[4], args[1], args[14]
    assert features == paint.Features()
    if build is _deep_stack:
        assert diag[DIAG_K] > 16
    if build is _virtual_and_fill_rules:
        assert bool(((virt_u & paint.FLAG_VIRTUAL) != 0)[u_valid].any())

    got = fold_tiles(*args).numpy()
    want = _jax_fold(args)
    rows, tiles_x = args[11], args[12]
    assert got.shape == want.shape == (rows * tiles_x, 16, 16, 4)
    assert np.abs(got - want).max() <= 1e-6
    assert (got != CLEAR.to_array()).any()  # something painted


STYLED = [
    ("gradient_fills", _gradient_fills, 80, 64, 1e-6),
    ("blend_modes", _blend_modes, 96, 48, 1e-6),
    ("clip_masks", _clip_masks, 64, 64, 1e-6),
    ("random_11", _random_mixed(11), 96, 64, 1e-6),
    ("random_23", _random_mixed(23), 96, 64, 1e-6),
    ("random_37", _random_mixed(37), 96, 64, 1e-5),
]


@pytest.mark.parametrize("name, build, w, h, tol", STYLED, ids=[s[0] for s in STYLED])
def test_styled_fold_matches_pallas(name, build, w, h, tol, monkeypatch):
    """Gradients, blend modes and clips through the plain fold against the
    JAX kernel in interpret mode (tolerances: module docstring)."""
    args, _ = _fold_inputs(build, w, h, monkeypatch)
    features = args[14]
    if name == "gradient_fills":
        assert features.has_gradient and not features.has_clip
    if name == "blend_modes":
        assert features.blend_modes == tuple(range(16))
    if name == "clip_masks":
        assert features.has_clip
        assert args[9].shape[1] == style_layout(features, args[15]).width == 9
    got = fold_tiles(*args).numpy()
    want = _jax_fold(args)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol


def _texture_e2e(comp):
    from e2e_scenes import all_scenes

    dict(all_scenes())["tests__texture__cpu"](comp)


def _textured_mix(comp):
    from test_torch_texture import JAX_SCENES

    JAX_SCENES.textured_mix(comp, 40, 64, 64)


TEXTURED = [
    ("texture_e2e", _texture_e2e, 64, 64, 0.0),
    ("textured_mix", _textured_mix, 64, 64, 0.0),
]


@pytest.mark.parametrize("name, build, w, h, tol", STYLED + TEXTURED,
                         ids=[s[0] for s in STYLED + TEXTURED])
def test_style_pack_matches_jax(name, build, w, h, tol):
    """The feature-dependent style rows, bit for bit, from the same style
    tables (JAX's per-slot layer id and clip range end included).  Texture
    frames: the lanes of JAX's layout equal JAX's rows; the port's own
    texture lanes hold the f32 bits of `st_tex[pidx]`, and its fill-type
    lane (which JAX's layout has only with gradients) `st_fill_type[pidx]`."""
    from forma_tpu.ops.paint_pallas import style_layout as jax_layout
    from forma_tpu.ops.styles import StyleMap as JaxStyleMap

    comp = Composition()
    build(comp)
    st = JaxStyleMap().build(comp.layers)
    names = ("orders", "pidx", "fill_rule", "func", "clip_n", "is_clipped", "blend",
             "fill_type", "color", "grad", "stops")
    cols = [getattr(st, n) for n in names]
    want = np.asarray(jpaint.style_pack_for_fold(st.features, *map(jnp.asarray, cols)))
    features = paint.Features(*st.features)
    got = paint.style_pack_for_fold(
        features, *(torch.from_numpy(c.astype(np.int64) if c.dtype == np.uint32 else c)
                    for c in cols + [st.tex])
    ).numpy()
    lay = style_layout(features, st.max_stops)
    assert got.dtype == np.int32
    assert got.shape == (len(st.orders), lay.width)
    assert features.has_texture == (name in dict((t[0], 1) for t in TEXTURED))
    if not features.has_texture:
        np.testing.assert_array_equal(got, want)
        return
    jlay = jax_layout(st.features, st.max_stops)
    lanes = []  # the port's lane of each of JAX's lanes
    for group, n in (("fill", 4), ("fr", 1), ("blend", 1), ("ft", 1), ("func", 1),
                     ("layer", 1), ("cend", 1), ("clipped", 1), ("grad", 6),
                     ("stops", 5 * st.max_stops)):
        if getattr(jlay, group) >= 0:
            lanes.extend(range(getattr(lay, group), getattr(lay, group) + n))
    assert len(lanes) == want.shape[1] == jlay.width
    np.testing.assert_array_equal(got[:, lanes], want)
    np.testing.assert_array_equal(got[:, lay.tex:lay.tex + 10],
                                  st.tex[st.pidx].view(np.int32))
    np.testing.assert_array_equal(got[:, lay.ft], st.fill_type[st.pidx])
    assert (st.fill_type[st.pidx] == 2).any()


@pytest.mark.parametrize("build", [_clip_masks, _random_mixed(46), _random_mixed(57)],
                         ids=["clip_masks", "random_46", "random_57"])
def test_skip_trivial_clips_keep_matches_jax(build, monkeypatch):
    """Same pre-pass units in, the same keep mask and FLAG_UNCLIPPED bits out
    (seeds 46 and 57 have draws governed by a dropped full clip)."""
    seen = _spy(monkeypatch, paint, "skip_trivial_clips_keep")
    comp = Composition()
    build(comp)
    Renderer("cpu").render(composition_from_jax(comp), 96, 64, CLEAR)
    assert seen
    key_u, virt_u, u_valid, id_u, cend_u, clipped_u = seen[-1]
    keep, virt = paint.skip_trivial_clips_keep(*seen[-1])
    jkeep, jvirt = jpaint.skip_trivial_clips_keep(
        jnp.asarray(key_u.numpy().astype(np.uint32)),
        jnp.asarray(virt_u.numpy().astype(np.int32)), jnp.asarray(u_valid.numpy()),
        jnp.asarray(id_u.numpy().astype(np.int32)),
        jnp.asarray(cend_u.numpy().astype(np.int32)), jnp.asarray(clipped_u.numpy()),
    )
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(virt.numpy(), np.asarray(jvirt))
    assert (~keep.numpy() & u_valid.numpy()).any()  # the pass dropped something


def test_fold_cpu_dispatch_and_spans(monkeypatch):
    """CPU tensors take the plain fold; spans cover every valid unit."""
    args, _ = _fold_inputs(_clip_masks, 64, 64, monkeypatch)
    key_u, u_valid, src_u, src2_u, virt_u = args[:5]
    rows, tiles_x, k_slots, features, ms = args[11:16]
    ust, cnt = tile_spans(key_u, u_valid, rows, tiles_x, k_slots)
    assert int(cnt.sum()) == int(u_valid.sum())
    fargs = (ust, cnt, src_u, src2_u, virt_u, *args[5:11], tiles_x, features, ms)
    assert torch.equal(paint_fold(*fargs), paint_fold_torch(*fargs))


def _fold_numpy(ust, cnt, src2, grid, ci, ca, tx_s, style, clear, tiles_x):
    """The solid/Over table-mode fold tile by tile in numpy f32, one
    rounding per op (the Pallas kernel's expression tree,
    `paint_pallas.py:327-336,404-415`)."""
    f32 = np.float32
    recip = f32(1.0 / 512)
    out = np.zeros((len(ust), 1024), np.float32)
    for t in range(len(ust)):
        d = [np.full(256, clear[c], np.float32) for c in range(4)]
        for k in range(int(cnt[t])):
            r = int(src2[ust[t] + k])
            virt = tx_s[r] != t % tiles_x
            g = grid[r].astype(np.int64)
            cover = ((g & 0xFFFF) ^ 0x8000) - 0x8000
            area = (g - cover) >> 16
            if virt:
                cover, area = cover * 0, area * 0
            c3 = cover.reshape(16, 16)
            ce = ((ca[r] if virt else ci[r])[:, None] + np.cumsum(c3, 1) - c3).reshape(256)
            da = 32 * ce + area
            nz = np.clip(np.abs(da.astype(f32) * recip), f32(0), f32(1))
            eo = (512 - np.abs((da & 1023) - 512)).astype(f32) * recip
            cov = eo if style[r, 4] != 0 else nz
            fill = style[r, :4].astype(np.int32).view(np.float32)
            sa = fill[3] * cov
            ida_sa, isa, da_sa = (f32(1) - d[3]) * sa, f32(1) - sa, d[3] * sa
            for c in range(3):
                d[c] = d[c] * isa + (fill[c] * ida_sa + fill[c] * da_sa)
            d[3] = d[3] * isa + sa
        out[t] = np.concatenate(d)
    return out


def test_fold_is_bit_equal_to_op_by_op_numpy(monkeypatch):
    """The plain fold rounds exactly like f32 evaluated one op at a time.
    (XLA's CPU build of the interpret-mode Pallas kernel differs from both
    by at most a few ulp on rare pixels, hence the 1e-6 bound above.)"""
    args, _ = _fold_inputs(_deep_stack, 32, 32, monkeypatch)
    key_u, u_valid, src_u, src2_u = args[:4]
    grid, ci, ca, tx_s, style_s, clear = args[5:11]
    rows, tiles_x, k_slots, features, ms = args[11:16]
    ust, cnt = tile_spans(key_u, u_valid, rows, tiles_x, k_slots)
    got = paint_fold_torch(ust, cnt, src_u, src2_u, None, grid, ci, ca, tx_s, style_s,
                           clear, tiles_x, features, ms).numpy()
    want = _fold_numpy(*(a.numpy() for a in (ust, cnt, src2_u, grid, ci, ca, tx_s,
                                             style_s, clear)), tiles_x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
