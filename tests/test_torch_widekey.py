"""The two-key (wide-key) route of the PyTorch port against the JAX
package: frames whose [row | slot | tx] key passes 31 bits
(`pipeline.slot_bits_for` gives 0).  Stage by stage on the same inputs:

- `rasterize_sort(slot_bits=0)`: bit-equal to JAX's sorted stream after a
  canonical lexsort (both sorts are unstable), and the same segment set
  as the port's packed path; the plain two-key emit's combined int64 key
  and payload word, sorted, equal to the old three-array path and to
  JAX's; the combined key keeps the widest valid keys and sorts the
  sentinel last;
- `runs.run_data(presorted=False)`: every returned array bit-equal to
  JAX's on valid rows;
- K3's plain fold with `src_u != src2_u` against JAX's interpret-mode
  Pallas fold in assembly mode (`presorted=False`), at
  `tests/test_torch_paint.py`'s tolerance, with the port's virtuality
  (the run's tile x against the unit's) equal to JAX's FLAG_VIRTUAL;
- whole frames with `slot_bits_for` patched to 0 in both packages: the
  frame within 1/255 of JAX's (`tests/test_torch_render.py`'s bar) with
  an equal diag vector, and equal to the port's packed-path frame.

The JAX package decides `slot_bits` when it traces `render_frame`, so its
jit caches are cleared around every patched render."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forma_tpu import Color, Composition
from forma_tpu.demos import scenes as jax_scenes
from forma_tpu.ops import paint as jpaint
from forma_tpu.ops import pipeline as jpipe
from forma_tpu.ops import rasterize as jras
from forma_tpu.ops import runs as jruns
from forma_tpu.ops.line_setup import line_setup as jax_line_setup
from forma_tpu_torch import Renderer
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.ops import paint, pipeline, rasterize, runs
from forma_tpu_torch.ops import rasterize_kernel as rk
from forma_tpu_torch.ops.expand_kernel import expand_params_torch
from forma_tpu_torch.ops._u32 import SENTINEL
from forma_tpu_torch.ops.rasterize import TX_BITS

from e2e_scenes import all_scenes
from test_torch_paint import (
    _clip_masks, _gradient_fills, _virtual_and_fill_rules,
)
from test_torch_texture import JAX_SCENES
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

CLEAR = Color(1.0, 1.0, 1.0, 1.0)
LAYER_MASK = (1 << 21) - 1


# -- the sort ----------------------------------------------------------------


def _channels_lines():
    """The lines of `tests/test_buffers_channels.py:84-101` through JAX's
    line setup (128x128, 64 point pairs over 4 slots)."""
    rng = np.random.default_rng(0)
    n = 64
    pts_x = rng.uniform(-10, 120, n * 2).astype(np.float32)
    pts_y = rng.uniform(-10, 120, n * 2).astype(np.float32)
    line_slot = np.where(np.arange(n * 2 - 1) % 2 == 0, np.arange(n * 2 - 1) // 2 % 4, -1)
    out = jax_line_setup(
        jnp.asarray(pts_x), jnp.asarray(pts_y), jnp.asarray(line_slot, jnp.int32),
        jnp.arange(4, dtype=jnp.int32), jnp.ones(4, bool),
        jnp.tile(jnp.asarray([[1, 0, 0, 1, 0, 0]], jnp.float32), (4, 1)),
        jnp.zeros(4, bool), 128, 128, k_seg=8,
    )
    return [np.array(x) for x in out]


def _canon(streams):
    a = np.stack([np.asarray(s).astype(np.int64) for s in streams], axis=1)
    return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]


def test_two_key_sort_matches_jax_and_packed():
    params, slots, lengths, ends = _channels_lines()
    v_total = int(ends[-1])
    v_cap = v_total + 40  # padding vlines past the total
    port_args = (torch.from_numpy(params), torch.from_numpy(slots),
                 torch.from_numpy(lengths), torch.from_numpy(ends.astype(np.int64)),
                 torch.tensor(v_total), v_cap, 8, 8, 8, 0)
    two = [x.numpy() for x in rasterize.rasterize_sort(*port_args, slot_bits=0)]
    assert all(x.shape == (v_cap * 8,) and x.dtype == np.int64 for x in two)
    # Sorted by (key_hi, key_lo), the sentinel last.
    pair = two[0] * (1 << 21) + two[1]
    assert (np.diff(pair) >= 0).all()
    valid = two[0] != SENTINEL
    assert valid.sum() > 500 and not valid[-40:].any()
    assert (two[1][~valid] == 0).all()

    with jax.disable_jit():
        want = jras.rasterize_sort(
            *map(jnp.asarray, (params, slots, lengths, ends)), jnp.uint32(v_total),
            v_cap, 8, 8, 8, 0, slot_bits=0)
    np.testing.assert_array_equal(_canon(two), _canon(want))

    packed = rasterize.rasterize_sort(*port_args, slot_bits=2)
    np.testing.assert_array_equal(_canon(two), _canon(packed))


def test_two_key_sort_keeps_widest_keys_and_sorts_sentinel_last():
    """key_lo = 2^21 - 1 and the largest key_hi at the format's limits
    ((2049 << 13) | 4097) survive the combined int64 key the emit writes;
    `TWO_KEY_SENTINEL`, where a u32 sentinel shifted by 21 would set bit
    63, sorts after every valid key and splits into `SENTINEL` and 0; the
    payload words (int32, any of their 32 bits set) widen back to their
    u32 values."""
    rng = np.random.default_rng(3)
    n = 4000
    hi_max = (2049 << TX_BITS) | 4097
    key_hi = rng.integers(0, hi_max + 1, n)
    key_lo = rng.integers(0, 1 << 21, n)
    key_hi[:6] = [hi_max, hi_max, 0, hi_max, 1, 0]
    key_lo[:6] = [LAYER_MASK, 0, LAYER_MASK, LAYER_MASK - 1, 0, 0]
    invalid = rng.random(n) < 0.2
    invalid[:6] = False
    key_hi[invalid] = SENTINEL
    key_lo[invalid] = 0
    payload = rng.integers(0, 1 << 32, n)
    key = np.where(invalid, rasterize.TWO_KEY_SENTINEL,
                   (key_hi << rasterize.SLOT_FIELD_BITS) | key_lo)
    words = torch.from_numpy(payload.astype(np.uint32).view(np.int32))
    got = [x.numpy() for x in rasterize.sort_two_key(torch.from_numpy(key), words)]
    assert all(x.dtype == np.int64 for x in got)
    nv = int((~invalid).sum())
    assert (got[0][nv:] == SENTINEL).all() and (got[1][nv:] == 0).all()
    want = _canon((key_hi, key_lo, payload))
    np.testing.assert_array_equal(_canon(got), want)
    assert (got[0][:nv] < SENTINEL).all()
    assert got[0][nv - 1] == hi_max and got[1][nv - 1] == LAYER_MASK
    pair = got[0][:nv] * (1 << 21) + got[1][:nv]
    assert (np.diff(pair) >= 0).all()


@pytest.mark.parametrize("row_lo, rows", [(0, 8), (2, 5)])
def test_plain_emit_sorted_matches_the_old_path_and_jax(row_lo, rows):
    """The plain two-key emit's combined key and payload word, sorted by
    `sort_two_key`: the (key_hi, key_lo, payload) stream of the old path
    (`_emit_core`'s fields as three int64 arrays, sorted as one key) and
    JAX's `rasterize_sort(..., slot_bits=0)`, after a canonical lexsort
    (both sorts are unstable); at row_lo 2 segments above and below the
    rows drop."""
    params, slots, lengths, ends = _channels_lines()
    v_total = int(ends[-1])
    v_cap = v_total + 40
    pt, j = expand_params_torch(torch.from_numpy(params),
                                torch.from_numpy(ends.astype(np.int64)), v_cap)
    args = (pt, j, torch.tensor(v_total), 8, rows, 8, row_lo)
    key, payload = rk.emit_two_key_torch(*args)
    got = rasterize.sort_two_key(key.reshape(-1), payload.reshape(-1))

    v_live = torch.arange(v_cap) < v_total
    tile_x, tile_y, slot, old_pay, valid = rk._emit_core(
        lambda i: pt[i], j, v_live, 8, rows, 8, row_lo)
    old_hi = torch.where(valid, ((tile_y.long() + 1) << TX_BITS) | (tile_x.long() + 1),
                         SENTINEL).reshape(-1)
    old_lo = torch.where(valid, slot, 0).reshape(-1)
    np.testing.assert_array_equal(_canon(got), _canon((old_hi, old_lo, old_pay.reshape(-1))))
    assert 300 < int(valid.sum()) < int(lengths.sum())

    with jax.disable_jit():
        want = jras.rasterize_sort(
            *map(jnp.asarray, (params, slots, lengths, ends)), jnp.uint32(v_total),
            v_cap, 8, rows, 8, row_lo, slot_bits=0)
    np.testing.assert_array_equal(_canon(got), _canon(want))


@pytest.mark.parametrize("n_slots, rows, tiles_x, want", [
    (1 << 17, 68, 120, 17),  # 1920x1080: 7 + 7 + 17 bits
    ((1 << 17) + 1, 68, 120, 0),
    (30_000, 270, 480, 0),  # paris-30k at 7680x4320: 9 + 9 + 15
    (30_000, 135, 240, 15),  # paris-30k at 3840x2160: 8 + 8 + 15
    (140_000, 68, 120, 0),  # the envelope tool's lattice at 1920x1080
])
def test_slot_bits_boundary(n_slots, rows, tiles_x, want):
    assert pipeline.slot_bits_for(n_slots, rows, tiles_x) == want
    assert jpipe.slot_bits_for(n_slots, rows, tiles_x) == want


# -- the port's two-key frames, stage inputs recorded --------------------------


def _circles(comp):
    jax_scenes.circles(comp, 40, 112, 80)


def _solid_e2e(comp):
    dict(all_scenes())["tests__fill_rules__EvenOdd__cpu"](comp)


def _styled_mix(comp):
    JAX_SCENES.styled_mix(comp, 120, 96, 80)


def _textured_mix(comp):
    JAX_SCENES.textured_mix(comp, 8, 48, 48)


SCENES = {
    # name: (build function, width, height)
    "circles": (_circles, 112, 80),
    "solid_e2e": (_solid_e2e, 64, 64),
    "styled_mix": (_styled_mix, 96, 80),
    "textured_mix": (_textured_mix, 48, 48),
    "virtual_and_fill_rules": (_virtual_and_fill_rules, 128, 64),
    "gradient_fills": (_gradient_fills, 80, 64),
    "clip_masks": (_clip_masks, 64, 64),
}


def _record(mod, name, calls):
    real = getattr(mod, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.setdefault(name, []).append((args, kwargs, out))
        return out

    setattr(mod, name, spy)
    return real


@functools.lru_cache(maxsize=None)
def _port_frames(name):
    """The scene through the port on the CPU, packed and two-key (the
    second render of each, after the buckets grew); returns a dict: the
    JAX composition `jcomp`, each path's frame and diag (`packed`,
    `packed_diag`, `two`, `diag`), the two-key renderer's `caps`, and
    the two-key render's recorded `run_data` and `fold_tiles` `calls`."""
    build, w, h = SCENES[name]
    jcomp = Composition()
    build(jcomp)
    comp = composition_from_jax(jcomp)
    r = Renderer("cpu")
    r.render(comp, w, h, CLEAR)
    packed = r.render(comp, w, h, CLEAR)
    calls = {}
    real_bits = pipeline.slot_bits_for
    reals = [(runs, "run_data", _record(runs, "run_data", calls)),
             (paint, "fold_tiles", _record(paint, "fold_tiles", calls))]
    pipeline.slot_bits_for = lambda *_: 0
    try:
        r2 = Renderer("cpu")
        r2.render(comp, w, h, CLEAR)
        calls.clear()
        two = r2.render(comp, w, h, CLEAR)
    finally:
        pipeline.slot_bits_for = real_bits
        for mod, attr, fn in reals:
            setattr(mod, attr, fn)
    return dict(jcomp=jcomp, packed=packed, packed_diag=r.last_diag, two=two,
                diag=r2.last_diag, caps=tuple(r2._caps), calls=calls)


def _u32(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _i32(t):
    return jnp.asarray(t.numpy().astype(np.int32))


@pytest.mark.parametrize("name", ["circles", "styled_mix", "virtual_and_fill_rules"])
def test_run_data_unsorted_matches_jax(name):
    """`run_data(presorted=False)` on the port's own two-key stream against
    JAX's on the same inputs: bit-equal on valid rows (the grid,
    `real_flags` and `inv` on valid runs in run order; the rest on
    valid rows of the carry-chain order)."""
    (args, kwargs, got), = _port_frames(name)["calls"]["run_data"]
    assert kwargs["presorted"] is False
    (key_hi, key_lo, payload, run_id, new_run, num_runs, st_pidx, st_fr, st_opaque,
     st_isclip, st_solid, run_cap, tiles_x) = args
    want = jruns.run_data(
        _u32(key_hi), _u32(key_lo), _u32(payload), _i32(run_id),
        jnp.asarray(new_run.numpy()), jnp.int32(int(num_runs)), _i32(st_pidx),
        _i32(st_fr), jnp.asarray(st_opaque.numpy()), jnp.asarray(st_isclip.numpy()),
        jnp.asarray(st_solid.numpy()), run_cap, tiles_x,
        style_pack=_i32(kwargs["style_pack"]), presorted=False,
    )
    want = {k: np.asarray(v).astype(np.int64) for k, v in want.items() if v is not None}
    got = {k: v.numpy().astype(np.int64) for k, v in got.items()}
    r_valid = got["r_valid"].astype(bool)
    np.testing.assert_array_equal(r_valid, want["r_valid"].astype(bool))
    valid_s = got["key2_s"] != SENTINEL
    assert r_valid.sum() == valid_s.sum() > 8
    for k in ("run_hi", "run_layer", "real_flags", "grid", "inv"):
        np.testing.assert_array_equal(got[k][r_valid], want[k][r_valid], err_msg=k)
    for k in ("key2_s", "tx_s", "carry_in_s", "carry_after_s", "gap_flags_s", "span",
              "style_s"):
        np.testing.assert_array_equal(got[k][valid_s], want[k][valid_s], err_msg=k)
    np.testing.assert_array_equal(got["cumspan"], want["cumspan"])
    assert int(got["v_total"]) == int(want["v_total"])
    # The runs really were re-ordered: inv is no identity on valid runs.
    assert (got["inv"][r_valid] != np.flatnonzero(r_valid)).any()


@pytest.mark.parametrize("name", ["virtual_and_fill_rules", "gradient_fills", "clip_masks"])
def test_fold_assembly_mode_matches_pallas(name):
    """K3's plain fold on the port's two-key units (src_u != src2_u on
    real units) against JAX's interpret-mode fold in assembly mode, linear
    f32 pixels within 1e-6 (`tests/test_torch_paint.py`); and the port's
    virtuality test (tx_s[src2_u] against the unit's tile x) equals
    FLAG_VIRTUAL on every valid unit."""
    (args, kwargs, got), = _port_frames(name)["calls"]["fold_tiles"]
    (key_u, u_valid, src_u, src2_u, virt_u, grid, ci, ca, tx_s, style_s, clear,
     rows, tiles_x, k_slots, features, ms, _atlas) = args
    valid = u_valid.numpy()
    virt = (virt_u.numpy() & paint.FLAG_VIRTUAL) != 0
    real = valid & ~virt
    assert (src_u.numpy() != src2_u.numpy())[real].any()
    tile_tx = (key_u.numpy() & ((1 << TX_BITS) - 1)) - 1
    port_virt = tx_s.numpy()[np.clip(src2_u.numpy(), 0, len(tx_s) - 1)] != tile_tx
    np.testing.assert_array_equal(port_virt[valid], virt[valid])
    if name == "virtual_and_fill_rules":
        assert virt[valid].any()

    zeros = jnp.zeros(key_u.shape, jnp.int32)
    want = np.asarray(jpaint._paint_fold_pallas(
        _u32(key_u), zeros, _i32(src_u), _i32(src2_u), _i32(virt_u), zeros,
        jnp.asarray(valid), _i32(grid), _i32(ci), _i32(ca), _i32(style_s),
        jnp.asarray(clear.numpy()), rows, tiles_x, k_slots, jpaint.Features(*features),
        ms, presorted=False, interpret=True,
    ))
    got = got.numpy()
    assert got.shape == want.shape == (rows * tiles_x, 16, 16, 4)
    assert np.abs(got - want).max() <= 1e-6
    assert (got != CLEAR.to_array()).any()


def test_two_key_frame_matches_packed():
    """Every scene's two-key frame through `Renderer.render` equals its
    packed-path frame, and so does the diag vector: the same runs and
    units, every accumulation integer, and the units fold in the same
    order.  The one-layer e2e scene is the only one whose two-key units
    keep src_u == src2_u."""
    for name in ("circles", "solid_e2e", "styled_mix", "textured_mix"):
        f = _port_frames(name)
        _, w, h = SCENES[name]
        two = f["two"]
        assert two.shape == (h, w, 4), name
        np.testing.assert_array_equal(two, f["packed"], err_msg=name)
        np.testing.assert_array_equal(f["diag"], f["packed_diag"], err_msg=name)
        assert (two[..., :3] != 255).any(), name
        fargs = f["calls"]["fold_tiles"][0][0]
        src_u, src2_u, u_valid = fargs[2], fargs[3], fargs[1]
        assert bool((src_u != src2_u)[u_valid].any()) == (name != "solid_e2e"), name


# The styled mix (16 blend modes, gradients, clips) is held against JAX
# stage by stage above and against the packed path here: JAX's CPU
# compile of its whole frame takes 67-97 s.
@pytest.mark.parametrize("name", ["circles", "solid_e2e", "textured_mix"])
def test_two_key_frame_matches_jax(name, monkeypatch):
    """The whole frame through `Renderer.render` with `slot_bits_for`
    patched to 0 in both packages: within 1/255 of JAX's two-key frame,
    with the same diag vector."""
    from forma_tpu.renderer import Renderer as JaxRenderer

    f = _port_frames(name)
    _, w, h = SCENES[name]
    monkeypatch.setattr(jpipe, "slot_bits_for", lambda *_: 0)
    jax.clear_caches()
    try:
        jr = JaxRenderer()
        jr._caps = jpipe.Caps(*f["caps"])
        want = jr.render(f["jcomp"], w, h, CLEAR)
    finally:
        jax.clear_caches()
    assert int(np.abs(f["two"].astype(int) - want.astype(int)).max()) <= 1
    np.testing.assert_array_equal(f["diag"], np.asarray(jr.last_diag))
