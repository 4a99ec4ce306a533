"""The damage cache of the PyTorch port (`Renderer("cpu")`, every kernel's
plain version): the cases of `tests/test_layer_cache.py`,
`tests/test_crop_cache.py` and `tests/test_damage_readback.py`, each run
through the port and, with the same scene and the same mutations, through
the JAX package.  Within the port a cached frame is byte-equal to a fresh
uncached render; against JAX every frame's buffer is within 1/255 and
the diagnostics vector is equal, `DIAG_K` (the fold depth over painted
tiles) and `DIAG_DMG` (the damaged tiles) included."""

import gc

import numpy as np
import pytest

import forma_tpu
import forma_tpu_torch
from forma_tpu.renderer import Renderer as JaxRenderer
from forma_tpu_torch import Renderer
from forma_tpu_torch.ops import pipeline as pipe
from forma_tpu_torch.renderer import _DMG_PREFIX
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

PKGS = (forma_tpu, forma_tpu_torch)
POISON = 0xAB


def _renderer(pkg):
    return JaxRenderer() if pkg is forma_tpu else Renderer("cpu")


def _clear(pkg):
    return pkg.Color(1.0, 1.0, 1.0, 1.0)


def _square(pkg, x0, y0, size):
    return (pkg.PathBuilder().move_to(pkg.Point(x0, y0)).line_to(pkg.Point(x0, y0 + size))
            .line_to(pkg.Point(x0 + size, y0 + size)).line_to(pkg.Point(x0 + size, y0))
            .build())


def _solid(pkg, *rgba):
    return pkg.Props(func=pkg.Func.Draw(pkg.Style(fill=pkg.Fill.Solid(pkg.Color(*rgba)))))


def _setup(pkg, squares, w=64, h=64):
    """Layers of solid squares (order, x0, y0, size, rgba) and a renderer
    with a layer cache on a zeroed w x h buffer."""
    comp = pkg.Composition()
    for order, x0, y0, size, rgba in squares:
        comp.get_mut_or_insert_default(pkg.Order(order)).insert(
            _square(pkg, x0, y0, size)).set_props(_solid(pkg, *rgba))
    r = _renderer(pkg)
    cache = r.create_buffer_layer_cache()
    assert cache is not None and cache.id == 0
    buf = np.zeros((h, w * 4), np.uint8)
    buffer = pkg.Buffer(buffer=buf, layout=pkg.LinearLayout(w, w * 4, h), layer_cache=cache)
    return comp, r, buffer, buf


# `tests/test_layer_cache.py` and `tests/test_damage_readback.py`'s scene,
# and `tests/test_crop_cache.py`'s: a top-left square and a 3-deep stack
# of translucent squares in the bottom-right.
TWO = [(0, 4, 4, 20, (1, 0, 0, 1)), (1, 36, 36, 20, (0, 0, 1, 0.5))]
TWO_OPAQUE = [(0, 4, 4, 20, (1, 0, 0, 1)), (1, 36, 36, 20, (0, 0, 1, 1))]
STACK = [(0, 4, 4, 20, (1, 0, 0, 1))] + [
    (1 + i, 36 + i, 36 + i, 20, (0, 0, 1, 0.5)) for i in range(3)
]


class Frames:
    """Snapshots of a sequence: the buffer and the diagnostics after each
    render."""

    def __init__(self, r, buf):
        self.r, self.buf, self.bufs, self.diags = r, buf, [], []

    def snap(self):
        self.bufs.append(self.buf.copy())
        self.diags.append(np.asarray(self.r.last_diag).copy())


def _against_jax(sequence):
    """Runs `sequence(pkg)` (returning its `Frames`) in both packages and
    holds the port's frames to JAX's; returns the port's."""
    jax_frames, port = (sequence(pkg) for pkg in PKGS)
    assert len(port.bufs) == len(jax_frames.bufs) > 0
    for i, (j, p) in enumerate(zip(jax_frames.bufs, port.bufs)):
        assert int(np.abs(j.astype(int) - p.astype(int)).max()) <= 1, f"frame {i}"
    for i, (j, p) in enumerate(zip(jax_frames.diags, port.diags)):
        np.testing.assert_array_equal(p, j, err_msg=f"diag of frame {i}")
    return port


def _fresh(comp, w=64, h=64, clear=None):
    return Renderer("cpu").render(comp, w, h, clear or _clear(forma_tpu_torch))


# -- tests/test_layer_cache.py ------------------------------------------------


def test_cached_render_matches_uncached():
    def seq(pkg):
        comp, r, buffer, buf = _setup(pkg, TWO)
        f = Frames(r, buf)
        r.render_into(comp, buffer, _clear(pkg))
        f.snap()
        r.render_into(comp, buffer, _clear(pkg))  # no change: every tile unchanged
        f.snap()
        f.comp = comp
        return f

    f = _against_jax(seq)
    np.testing.assert_array_equal(f.bufs[0].reshape(64, 64, 4), _fresh(f.comp))
    np.testing.assert_array_equal(f.bufs[1], f.bufs[0])
    assert int(f.diags[1][pipe.DIAG_K]) == 0


@pytest.mark.parametrize("mutation", ["transform", "clear_color", "props", "removal"])
def test_mutation_invalidates_and_rerenders(mutation):
    """`tests/test_layer_cache.py`'s four invalidations: a moved layer, a
    new clear colour, new props, a removed layer."""
    def seq(pkg):
        comp, r, buffer, buf = _setup(pkg, TWO)
        f = Frames(r, buf)
        r.render_into(comp, buffer, _clear(pkg))
        f.snap()
        clear = _clear(pkg)
        if mutation == "transform":
            comp.get_mut_or_insert_default(pkg.Order(0)).set_transform(
                [1.0, 0.0, 0.0, 1.0, 8.0, 0.0])
        elif mutation == "clear_color":
            clear = pkg.Color(0.0, 0.0, 0.0, 1.0)
        elif mutation == "props":
            comp.get_mut_or_insert_default(pkg.Order(1)).set_props(_solid(pkg, 0, 1, 0, 1))
        else:
            comp.remove(pkg.Order(1))
        r.render_into(comp, buffer, clear)
        f.snap()
        f.comp, f.clear = comp, clear
        return f

    f = _against_jax(seq)
    np.testing.assert_array_equal(f.bufs[1].reshape(64, 64, 4),
                                  _fresh(f.comp, clear=f.clear))
    if mutation == "transform":
        assert int(f.diags[1][pipe.DIAG_K]) > 0


def test_cache_slots_exhaust():
    for pkg in PKGS:
        r = _renderer(pkg)
        caches = [r.create_buffer_layer_cache() for _ in range(32)]
        assert all(c is not None for c in caches)
        assert r.create_buffer_layer_cache() is None
        assert {c.id for c in caches} == set(range(32))
        del caches[5]  # a dropped cache frees its slot
        gc.collect()
        assert r.create_buffer_layer_cache().id == 5


# -- tests/test_crop_cache.py -------------------------------------------------


@pytest.mark.parametrize("case", ["survives_crop", "never_stale", "unchanged_cropped"])
def test_crop_cache(case):
    """The cache survives cropped renders, a cropped render never leaves an
    out-of-crop tile stale, and an unchanged scene cropped then rendered
    whole repaints nothing."""
    def seq(pkg):
        comp, r, buffer, buf = _setup(pkg, STACK)
        f = Frames(r, buf)
        clear = _clear(pkg)
        r.render_into(comp, buffer, clear)
        f.snap()
        crop = pkg.Rect.new(range(0, 32), range(0, 32))
        if case == "survives_crop":
            comp.get_mut_or_insert_default(pkg.Order(0)).set_props(_solid(pkg, 0, 0.6, 0, 1))
        elif case == "never_stale":
            comp.get_mut_or_insert_default(pkg.Order(1)).set_props(_solid(pkg, 1, 1, 0, 0.8))
        else:
            crop = pkg.Rect.new(range(16, 48), range(16, 48))
        r.render_into(comp, buffer, clear, crop=crop)
        f.snap()
        r.render_into(comp, buffer, clear)
        f.snap()
        f.comp = comp
        return f

    f = _against_jax(seq)
    if case == "survives_crop":
        # The unchanged 3-deep stack does not repaint: depth 1 (layer 0).
        assert int(f.diags[2][pipe.DIAG_K]) <= 1, f.diags[2]
    if case == "unchanged_cropped":
        assert int(f.diags[2][pipe.DIAG_K]) == 0, f.diags[2]
    np.testing.assert_array_equal(f.bufs[2].reshape(64, 64, 4), _fresh(f.comp))


# -- tests/test_damage_readback.py --------------------------------------------


def test_unchanged_tiles_never_rewritten():
    def seq(pkg):
        comp, r, buffer, buf = _setup(pkg, TWO_OPAQUE)
        f = Frames(r, buf)
        r.render_into(comp, buffer, _clear(pkg))
        f.snap()
        buf[:] = POISON
        comp.get_mut_or_insert_default(pkg.Order(0)).set_props(_solid(pkg, 0, 0.6, 0, 1))
        r.render_into(comp, buffer, _clear(pkg))
        f.snap()
        f.comp = comp
        return f

    f = _against_jax(seq)
    n_dmg = int(f.diags[1][pipe.DIAG_DMG])
    assert 0 < n_dmg < 16, f.diags[1]
    img = f.bufs[1].reshape(64, 64, 4)
    assert np.all(img[36:56, 36:56] == POISON)  # the unchanged tile is untouched
    np.testing.assert_array_equal(img[:32, :32], _fresh(f.comp)[:32, :32])


def test_fully_unchanged_scene_touches_nothing():
    def seq(pkg):
        comp, r, buffer, buf = _setup(pkg, TWO_OPAQUE)
        f = Frames(r, buf)
        r.render_into(comp, buffer, _clear(pkg))
        f.snap()
        buf[:] = POISON
        r.render_into(comp, buffer, _clear(pkg))
        f.snap()
        return f

    f = _against_jax(seq)
    assert int(f.diags[1][pipe.DIAG_DMG]) == 0
    assert np.all(f.bufs[1] == POISON)


def test_first_frame_damage_covers_everything():
    def seq(pkg):
        comp, r, buffer, buf = _setup(pkg, TWO_OPAQUE)
        f = Frames(r, buf)
        r.render_into(comp, buffer, _clear(pkg))
        f.snap()
        f.comp = comp
        return f

    f = _against_jax(seq)
    assert int(f.diags[0][pipe.DIAG_DMG]) == 16
    np.testing.assert_array_equal(f.bufs[0].reshape(64, 64, 4), _fresh(f.comp))


def test_adaptive_prefix_grow_shrink_bit_exact():
    """The adaptive damage-readback prefix grows past a misprediction
    (damage > prefix: one remainder slice) and shrinks when the damage
    does, with every cached frame byte-equal to a fresh uncached render."""
    w, h = 1024, 256  # 64 x 16 = 1024 tiles

    def seq(pkg):
        comp, r, buffer, buf = _setup(pkg, [(0, 0, 0, w, (0.9, 0.9, 0.95, 1))], w, h)
        sq = comp.get_mut_or_insert_default(pkg.Order(5))
        sq.insert(_square(pkg, 10, 10, 32)).set_props(_solid(pkg, 0.8, 0.1, 0.1, 1))
        bar = comp.get_mut_or_insert_default(pkg.Order(9))
        bar.insert(pkg.PathBuilder().move_to(pkg.Point(500, 0)).line_to(pkg.Point(500, h))
                   .line_to(pkg.Point(540, h)).line_to(pkg.Point(540, 0)).build()
                   ).set_props(_solid(pkg, 0.1, 0.2, 0.8, 0.9))
        f = Frames(r, buf)
        f.prefixes, f.fresh_equal = [], []
        for i in range(8):
            sq.set_transform(pkg.AffineTransform(1, 0, 0, 1, 3.0 * i, 2.0 * i))
            if 3 <= i <= 5:  # the tall bar moves: damage spikes past the prefix
                bar.set_transform(pkg.AffineTransform(1, 0, 0, 1, 30.0 * i, 0))
            r.render_into(comp, buffer, _clear(pkg))
            f.snap()
            f.prefixes.append(r._dmg_prefix)
            if pkg is forma_tpu_torch:
                f.fresh_equal.append(
                    bool((buf.reshape(h, w, 4) == _fresh(comp, w, h)).all()))
        return f

    f = _against_jax(seq)
    assert all(f.fresh_equal), f.fresh_equal
    dmg = [int(d[pipe.DIAG_DMG]) for d in f.diags]
    assert max(dmg[3:6]) > _DMG_PREFIX, dmg  # a misprediction
    assert max(f.prefixes[3:]) > _DMG_PREFIX, f.prefixes  # the prefix grew
    assert f.prefixes[-1] == _DMG_PREFIX, f.prefixes  # and shrank back


def test_write_back_full_fallback():
    """Without the compact damage data (overflow), `_write_back` reads the
    whole frame back."""
    def seq(pkg):
        comp, r, buffer, buf = _setup(pkg, TWO_OPAQUE)
        r.render_into(comp, buffer, _clear(pkg))
        frame, d = r._render_device_cached(comp, buffer.layer_cache, 64, 64, _clear(pkg),
                                           pkg.RGBA)
        buf[:] = POISON
        r._last_dmg = None  # the compact data unusable
        r._write_back(buffer, buffer.layout, frame, None, 64, 64)
        f = Frames(r, buf)
        f.snap()
        f.comp = comp
        return f

    f = _against_jax(seq)
    np.testing.assert_array_equal(f.bufs[0].reshape(64, 64, 4), _fresh(f.comp))


def test_two_key_cached_sequence_equals_packed(monkeypatch):
    """The damage cache on the two-key route (`slot_bits_for` replaced by
    0): a moved layer, a cropped render and a full one, each buffer and
    diagnostics vector equal to the packed route's."""
    def seq():
        comp, r, buffer, buf = _setup(forma_tpu_torch, STACK)
        f = Frames(r, buf)
        clear = _clear(forma_tpu_torch)
        r.render_into(comp, buffer, clear)
        f.snap()
        comp.get_mut_or_insert_default(forma_tpu_torch.Order(2)).set_transform(
            [1.0, 0.0, 0.0, 1.0, -9.0, -5.0])
        r.render_into(comp, buffer, clear,
                      crop=forma_tpu_torch.Rect.new(range(16, 64), range(16, 64)))
        f.snap()
        r.render_into(comp, buffer, clear)
        f.snap()
        return f

    packed = seq()
    monkeypatch.setattr(pipe, "slot_bits_for", lambda *_: 0)
    two_key = seq()
    for i, (a, b) in enumerate(zip(packed.bufs, two_key.bufs)):
        np.testing.assert_array_equal(b, a, err_msg=f"frame {i}")
    for i, (a, b) in enumerate(zip(packed.diags, two_key.diags)):
        np.testing.assert_array_equal(b, a, err_msg=f"diag of frame {i}")
    assert 0 < int(two_key.diags[2][pipe.DIAG_DMG]) < 16
