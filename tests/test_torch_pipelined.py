"""Pipelined readback, animation capacity and `check_caps=False` in the
PyTorch port (`Renderer("cpu")`, every kernel's plain version):

- `tests/test_pipelined_readback.py`'s three cases: after pipelined call
  i the buffer holds synchronous frame i - 1, byte for byte, through a
  mid-animation capacity regrow too, and a synchronous call flushes the
  frame in flight; the synchronous stream is also held to JAX's (within
  1/255, equal diagnostics);
- `tests/test_animation_caps.py`'s two cases: a warmed rotation, within
  the animation headroom or under `announce_max_scale`, never re-enters
  the growth loop;
- `render_device(check_caps=False)` returns the frame and the
  diagnostics as a tensor without reading them back, equal to the
  checked render's."""

import math

import numpy as np
import pytest
import torch

import forma_tpu
import forma_tpu_torch as pt
from forma_tpu.renderer import Renderer as JaxRenderer
from forma_tpu_torch import Renderer
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

W = H = 64
N_FRAMES = 6


def _square(pkg, x0, y0, size):
    return (pkg.PathBuilder().move_to(pkg.Point(x0, y0)).line_to(pkg.Point(x0, y0 + size))
            .line_to(pkg.Point(x0 + size, y0 + size)).line_to(pkg.Point(x0 + size, y0))
            .build())


def _solid(pkg, *rgba):
    return pkg.Props(func=pkg.Func.Draw(pkg.Style(fill=pkg.Fill.Solid(pkg.Color(*rgba)))))


def _build(pkg, grow_at=None):
    comp = pkg.Composition()
    comp.get_mut_or_insert_default(pkg.Order(0)).insert(_square(pkg, 2, 2, 14)).set_props(
        _solid(pkg, 1, 0, 0, 1))
    comp.get_mut_or_insert_default(pkg.Order(1)).insert(_square(pkg, 30, 30, 16)).set_props(
        _solid(pkg, 0, 0, 1, 0.8))

    def step(i):
        comp.get_mut_or_insert_default(pkg.Order(1)).set_transform(
            pkg.AffineTransform(1.0, 0.0, 0.0, 1.0, float(-2 * i), float(i)))
        if grow_at is not None and i == grow_at:
            # Scene growth mid-animation: the buckets overflow, and the
            # pipelined path learns it one frame late and must recover.
            for j in range(40):
                comp.get_mut_or_insert_default(pkg.Order(10 + j)).insert(
                    _square(pkg, 1 + j, 1 + (7 * j) % 40, 10)
                ).set_props(_solid(pkg, 0.02 * j, 1 - 0.02 * j, 0.3, 0.5))

    return comp, step


def _run(pkg, pipelined, grow_at=None):
    comp, step = _build(pkg, grow_at)
    r = JaxRenderer() if pkg is forma_tpu else Renderer("cpu")
    cache = r.create_buffer_layer_cache()
    backing = np.zeros((H, W * 4), np.uint8)
    buffer = pkg.Buffer(buffer=backing, layout=pkg.LinearLayout(W, W * 4, H),
                        layer_cache=cache)
    clear = pkg.Color(1.0, 1.0, 1.0, 1.0)
    snaps, diags = [], []
    for i in range(N_FRAMES):
        step(i)
        r.render_into(comp, buffer, clear, pipelined=pipelined)
        snaps.append(backing.copy())
        diags.append(np.asarray(r.last_diag).copy())
    if pipelined:
        r.flush_pending()
        snaps.append(backing.copy())
    return snaps, diags, r


@pytest.mark.parametrize("grow_at", [None, 3], ids=["steady", "capacity_growth"])
def test_pipelined_matches_sync(grow_at):
    sync, sync_diags, rs = _run(pt, False, grow_at)
    piped, _, rp = _run(pt, True, grow_at)
    # One frame of latency: after pipelined call i the buffer holds frame
    # i - 1 (call 0 writes nothing); the flush writes the last frame.
    assert not piped[0].any()
    for i in range(1, N_FRAMES):
        np.testing.assert_array_equal(piped[i], sync[i - 1], err_msg=f"frame {i}")
    np.testing.assert_array_equal(piped[N_FRAMES], sync[N_FRAMES - 1])
    if grow_at is not None:
        assert rs.regrow_count > 0 and rp.regrow_count > 0
    jsync, jdiags, _ = _run(forma_tpu, False, grow_at)
    for i, (j, p) in enumerate(zip(jsync, sync)):
        assert int(np.abs(j.astype(int) - p.astype(int)).max()) <= 1, f"frame {i}"
    for i, (j, p) in enumerate(zip(jdiags, sync_diags)):
        np.testing.assert_array_equal(p, j, err_msg=f"diag of frame {i}")


def test_sync_entry_points_flush():
    comp, step = _build(pt)
    r = Renderer("cpu")
    cache = r.create_buffer_layer_cache()
    backing = np.zeros((H, W * 4), np.uint8)
    buffer = pt.Buffer(buffer=backing, layout=pt.LinearLayout(W, W * 4, H), layer_cache=cache)
    clear = pt.Color(1.0, 1.0, 1.0, 1.0)
    step(0)
    r.render_into(comp, buffer, clear, pipelined=True)
    assert r._pending is not None
    # A synchronous render flushes the frame in flight first.
    step(1)
    r.render_into(comp, buffer, clear)
    assert r._pending is None
    comp2, step2 = _build(pt)
    step2(0)
    step2(1)
    want = Renderer("cpu").render(comp2, W, H, clear)
    np.testing.assert_array_equal(backing.reshape(H, W, 4), want)


# -- tests/test_animation_caps.py ---------------------------------------------


def _anim_scene(n=160, size=256):
    """Axis-aligned rectangles: rotation swings their Manhattan lengths
    most (|dx| + |dy| grows by cos + sin)."""
    comp = pt.Composition()
    rng = np.random.default_rng(3)
    for i in range(n):
        x = float(rng.uniform(0, size * 0.55)) + size * 0.1
        y = float(rng.uniform(0, size * 0.55)) + size * 0.1
        w = float(rng.uniform(8, 40))
        p = (pt.PathBuilder().move_to(pt.Point(x, y)).line_to(pt.Point(x + w, y))
             .line_to(pt.Point(x + w, y + w * 0.6)).line_to(pt.Point(x, y + w * 0.6))
             .build())
        c = pt.Color(*(float(v) for v in rng.uniform(0, 1, 3)), 0.8)
        comp.get_mut_or_insert_default(pt.Order(i)).insert(p).set_props(
            pt.Props(func=pt.Func.Draw(pt.Style(fill=pt.Fill.Solid(c)))))
    return comp


def _rotate(comp, n, deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    for i in range(n):
        comp.get_mut_or_insert_default(pt.Order(i)).set_transform([c, s, -s, c, 40.0, 40.0])


@pytest.mark.parametrize("announce, last_deg, n_frames", [(None, 8.0, 18), (1.42, 45.0, 14)],
                         ids=["within_headroom", "announced_scale"])
def test_rotation_never_regrows_after_warmup(announce, last_deg, n_frames):
    """A slow rotation (<= 8 deg, lengths grow <= 1.14x) within the
    animating flag's ~20% headroom, and a rotation to 45 deg (up to
    sqrt(2)) under `announce_max_scale(1.42)`: no regrow after the two
    warm-up frames."""
    comp = _anim_scene()
    r = Renderer("cpu")
    clear = pt.Color(1.0, 1.0, 1.0, 1.0)
    if announce is not None:
        r.announce_max_scale(announce)
    r.render(comp, 256, 256, clear)  # warm-up (static estimate)
    _rotate(comp, 160, 0.2)
    r.render(comp, 256, 256, clear)  # animating flips; re-estimate once
    warm = r.regrow_count
    warm_caps = r._caps
    for f in range(2, n_frames):
        _rotate(comp, 160, last_deg * f / (n_frames - 1))
        r.render(comp, 256, 256, clear)
    assert r.regrow_count == warm, f"{r.regrow_count - warm} regrows after warm-up"
    if announce is not None:
        # The announced bound sized the warmed buckets past what the
        # animation headroom alone gives the same two warm-up frames.
        plain = Renderer("cpu")
        comp = _anim_scene()
        plain.render(comp, 256, 256, clear)
        _rotate(comp, 160, 0.2)
        plain.render(comp, 256, 256, clear)
        assert warm_caps.vline > plain._caps.vline, (warm_caps, plain._caps)


def test_check_caps_false_returns_device_diag():
    """`check_caps=False`: the frame and the diagnostics tensor, no read
    back; both equal the checked render's, and `last_diag` is left as the
    checked render set it."""
    comp, step = _build(pt)
    step(2)
    clear = pt.Color(1.0, 1.0, 1.0, 1.0)
    r = Renderer("cpu")
    frame, d = r.render_device(comp, W, H, clear)
    last = r.last_diag
    frame2, diag = r.render_device(comp, W, H, clear, check_caps=False)
    assert isinstance(diag, torch.Tensor) and diag.dtype == torch.int64
    assert isinstance(d, np.ndarray)
    assert r.last_diag is last
    np.testing.assert_array_equal(diag.numpy(), d)
    assert torch.equal(frame2, frame)
