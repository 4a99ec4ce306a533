"""`Renderer.profile_frame` and `Timings` (`forma_tpu_torch/profiling.py`)
on `Renderer("cpu")`, against the JAX package's: the same fields, a
complete set of stage times on the packed key and on the two-key route
(`pipeline.slot_bits_for` patched to 0), `k_active` equal to the frame's
`DIAG_K` in the port and in JAX, and the pipeline's stages unwrapped
again afterwards.  `profile_stages` takes its stage list
from `profiling`."""

import math

import numpy as np
import pytest

import forma_tpu
import forma_tpu_torch
from forma_tpu.demos import scenes as jax_scenes
from forma_tpu_torch import Renderer, Timings, profile_stages, profiling
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.ops import pipeline
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

CLEAR = forma_tpu_torch.Color(1.0, 1.0, 1.0, 1.0)


def _circles():
    comp = forma_tpu.Composition()
    jax_scenes.circles(comp, 16, 64, 64)
    return comp


def _jax_diag(comp, caps, two_key):
    """JAX's `Renderer.render` diag vector with the port's buckets; on the
    two-key route with its `slot_bits_for` patched as well (JAX decides it
    at trace time, so its caches are cleared around the render)."""
    import jax

    from forma_tpu.ops import pipeline as jpipe
    from forma_tpu.renderer import Renderer as JaxRenderer

    real = jpipe.slot_bits_for
    if two_key:
        jpipe.slot_bits_for = lambda *_: 0
        jax.clear_caches()
    try:
        jr = JaxRenderer()
        jr._caps = jpipe.Caps(*caps)
        jr.render(comp, 64, 64, forma_tpu.Color(1.0, 1.0, 1.0, 1.0))
    finally:
        if two_key:
            jpipe.slot_bits_for = real
            jax.clear_caches()
    return np.asarray(jr.last_diag)


@pytest.mark.parametrize("route", ["packed", "two_key"])
def test_profile_frame(route, monkeypatch):
    if route == "two_key":
        monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    comp = _circles()
    r = Renderer("cpu")
    wrapped = [getattr(mod, attr) for mod, attr, *_ in profiling.STAGES]
    t = r.profile_frame(composition_from_jax(comp), 64, 64, CLEAR)
    assert [getattr(mod, attr) for mod, attr, *_ in profiling.STAGES] == wrapped
    assert isinstance(t, Timings)
    assert Timings._fields == forma_tpu.Timings._fields
    for f in Timings._fields[:9]:
        v = getattr(t, f)
        assert math.isfinite(v) and v > 0.0, (f, v)
    # The stages lie inside a fenced frame's time: each ran once a frame.
    assert sum(t[:7]) < 4.0 * t.fused_frame
    assert t.k_active == int(r.last_diag[pipeline.DIAG_K]) > 0
    want = _jax_diag(comp, r._caps, route == "two_key")
    np.testing.assert_array_equal(r.last_diag, want)
    assert t.k_active == int(want[pipeline.DIAG_K])


def test_profile_frame_counts_each_stage_once(monkeypatch):
    """Each top-level stage is timed once a frame, and the clip pass counts
    into `cull` on a frame with clips."""
    from test_torch_render import _random_styled_scene

    calls = []
    real = profiling._fenced

    def spy(fn, times, device, outs=None):
        fenced = real(fn, times, device, outs)

        def counted(*args, **kwargs):
            calls.append(fn.__name__)
            return fenced(*args, **kwargs)

        return counted

    monkeypatch.setattr(profiling, "_fenced", spy)
    comp, clear = _random_styled_scene(0)
    r = Renderer("cpu")
    t = r.profile_frame(composition_from_jax(comp), 64, 64,
                        forma_tpu_torch.Color(*clear.to_array()))
    top = [attr for _, attr, _, depth, _ in profiling.STAGES if depth == 0]
    # Then the fused frame and the dispatch floor, each REPEATS times.
    assert calls == top * profiling.REPEATS + ["<lambda>"] * 2 * profiling.REPEATS
    assert r._styles_cache[0].features.has_clip and t.cull > 0.0
    assert t.k_active == int(r.last_diag[pipeline.DIAG_K])


def test_profile_stages_shares_the_stage_list():
    assert profile_stages.STAGES is profiling.STAGES
    fields = {field for *_, depth, field in profiling.STAGES if depth == 0}
    assert fields == set(Timings._fields[:7])
    assert all(field is None for *_, depth, field in profiling.STAGES if depth > 0)
