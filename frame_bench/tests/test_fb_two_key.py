"""The 8K configuration and the program's two-key route, on the CPU at a
tiny size: the zoomed scene is paris30k's map scaled, the cell forced onto
the two-key route comes out correct with its four stage metrics read, and
K1's work count against a hand count."""

import json

import numpy as np
import pytest

from frame_bench import run, two_key
from frame_bench.scenes import paris30k, paris30k_scaled
from small import ROOT, SEED, bench, config, small

CELL = "paris30k-7680x4320.static"
STAGES = ("expand", "emit", "key_sort", "carry_sort")


@pytest.mark.parametrize("seed", [3, SEED])
def test_scaled_scene_is_the_base_map_zoomed(seed):
    cfg = {**config(CELL), **small(CELL)}
    scale = cfg["scale"]
    got = paris30k_scaled.build(cfg, seed)
    base = paris30k.build({**cfg, "width": cfg["width"] // scale,
                           "height": cfg["height"] // scale}, seed)
    assert (got.width, got.height) == (cfg["width"], cfg["height"])
    assert got.layers == base.layers == cfg["paths"]
    for (verbs, points), (base_verbs, base_points) in zip(got.paths, base.paths):
        assert verbs == base_verbs
        assert points == [p * scale for p in base_points]
    np.testing.assert_array_equal(got.colors, base.colors)
    np.testing.assert_array_equal(got.even_odd, base.even_odd)
    assert got.clear == base.clear
    with pytest.raises(ValueError):
        paris30k_scaled.build({**cfg, "width": cfg["width"] + 1}, seed)


def test_tiny_cell_on_the_two_key_route(monkeypatch):
    """The tiny cell's key fits 31 bits, so the route is forced as the
    program's own tests force it (`pipeline.slot_bits_for` giving 0)."""
    from forma_tpu_torch.ops import pipeline

    monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    b = bench()
    result, checks = run.run_cell(b, CELL, SEED, 0.2, True, ROOT, device="cpu",
                                  config_overrides=small(CELL, b), trace_frames=2)
    assert result["correct"] is True, checks
    for stage in STAGES:
        assert result["metrics"][f"stage_{stage}_ms"]["value"] > 0


def test_expand_work_by_hand():
    def diag(vlines, segs):
        d = [0] * 6
        d[two_key.DIAG_VLINES], d[two_key.DIAG_SEGS] = vlines, segs
        return d

    # 10 virtual lines of 40 segments: the lines number at least
    # ceil((8 * 10 - 40) / 7) = 6, each read once (16 f32 and an i64 end);
    # each virtual line's 16 f32 and i32 index written once.
    assert two_key.expand_work(diag(10, 40)) == (10 * 68 + 6 * 72, 0) == (1112, 0)
    # Full virtual lines (8 segments each) could all be one line's.
    assert two_key.expand_work(diag(3, 24)) == (3 * 68 + 72, 0)
    assert two_key.expand_work(diag(0, 0)) == (0, 0)


def test_route_stages_read_none_without_them(monkeypatch):
    """Before the program stamped the route (no such stage), the readers
    find nothing; a program without stamps at all, nothing either."""
    import sys
    import types

    fake = types.ModuleType("forma_tpu_torch.tracing")
    fake.STAGES = ("line_setup", "rasterize_sort", "runs")
    monkeypatch.setitem(sys.modules, "forma_tpu_torch.tracing", fake)
    for stage in STAGES:
        assert run.load_metric(f"stage_{stage}_ms").read(None) is None
    monkeypatch.setitem(sys.modules, "forma_tpu_torch.tracing", None)
    assert two_key.stage_ms("expand") is None


def test_new_cells_checks_and_mix():
    limits = json.loads((ROOT / "frame_bench" / "checks" / f"{CELL}.json").read_text())
    assert limits == {"frames": 2, "rows": 3, "mismatch_pct": 1.0, "last_rows": 34}
    full = json.loads((ROOT / "frame_bench" / "mixes" / "full.json").read_text())
    cached = json.loads((ROOT / "frame_bench" / "mixes" / "cached.json").read_text())
    assert full == {**cached, "layer_cache": False}
