"""The spaceship demo in the PyTorch port (`forma_tpu_torch.demos.
spaceship`, a copy of `forma_tpu/demos/spaceship.py` on the port's
classes): after `build` and after each of 3 `step`s its scene (segment
buffer, layers, transforms, style tables) and its registry and versions
are bit-equal to the JAX package's; through the damage cache at 128x128
every frame is byte-equal to a fresh uncached render of the port, within
1/255 of JAX's cached frame with an equal diagnostics vector, and a later
frame needs no more fold depth than the first (`tests/test_spaceship.py`)."""

import numpy as np

import forma_tpu
import forma_tpu_torch as pt
from forma_tpu.demos.spaceship import Spaceship as JaxSpaceship
from forma_tpu.renderer import Renderer as JaxRenderer
from forma_tpu_torch import Renderer
from forma_tpu_torch.demos.spaceship import Spaceship
from forma_tpu_torch.ops import pipeline as pipe
from test_torch_host import _assert_same_scene, _assert_same_state
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

W = H = 128


def test_spaceship_state_matches_jax():
    jcomp, comp = forma_tpu.Composition(), pt.Composition()
    jship, ship = JaxSpaceship(width=W, height=H), Spaceship(width=W, height=H)
    jship.build(jcomp)
    ship.build(comp)
    _assert_same_scene(jcomp, comp)
    _assert_same_state(jcomp, comp)
    for _ in range(3):
        jship.step()
        ship.step()
        _assert_same_scene(jcomp, comp)
        _assert_same_state(jcomp, comp)
        for ja, a in zip(jship.actors, ship.actors):
            assert (ja.x, ja.y, ja.rot) == (a.x, a.y, a.rot)


def _cached_frames(pkg, ship_cls, r):
    comp = pkg.Composition()
    ship = ship_cls(width=W, height=H)
    ship.build(comp)
    cache = r.create_buffer_layer_cache()
    backing = np.zeros((H, W * 4), np.uint8)
    buf = pkg.Buffer(buffer=backing, layout=pkg.LinearLayout(W, W * 4, H), layer_cache=cache)
    clear = pkg.Color(0.02, 0.02, 0.08, 1.0)
    frames, diags, fresh = [], [], []
    for i in range(4):
        if i:
            ship.step()
        r.render_into(comp, buf, clear)
        frames.append(backing.copy())
        diags.append(np.asarray(r.last_diag).copy())
        if pkg is pt:
            fresh.append(Renderer("cpu").render(comp, W, H, clear))
    return frames, diags, fresh


def test_spaceship_cached_frames_match_fresh():
    frames, diags, fresh = _cached_frames(pt, Spaceship, Renderer("cpu"))
    for i, (got, want) in enumerate(zip(frames, fresh)):
        np.testing.assert_array_equal(got.reshape(H, W, 4), want, err_msg=f"frame {i}")
    depths = [int(d[pipe.DIAG_K]) for d in diags]
    assert min(depths[1:]) <= depths[0]
    assert all(0 < int(d[pipe.DIAG_DMG]) < (W // 16) * (H // 16) for d in diags[1:])
    jframes, jdiags, _ = _cached_frames(forma_tpu, JaxSpaceship, JaxRenderer())
    for i, (j, p) in enumerate(zip(jframes, frames)):
        assert int(np.abs(j.astype(int) - p.astype(int)).max()) <= 1, f"frame {i}"
    for i, (j, p) in enumerate(zip(jdiags, diags)):
        np.testing.assert_array_equal(p, j, err_msg=f"diag of frame {i}")
