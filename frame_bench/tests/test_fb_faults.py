"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run driven on the
CPU at a tiny size, with each fault a frame loop can have planted where
the frame is produced, and with the control (the plain reference in
bfloat16) put in the program's place."""

import numpy as np
import pytest

from frame_bench import run, traffic
from frame_bench.reference import Reference
from frame_bench.reference.paint import round_bf16
from small import ROOT, SEED, bench, cells, small

MOVING = [c for c in cells() if not c.endswith(".static")]


def put(traffic_, img):
    """The broken frame into the entry's own buffer, where it has one."""
    pixels = getattr(traffic_.entry, "pixels", None)
    if pixels is not None:
        pixels[:] = img.reshape(pixels.shape)


def broken_run(monkeypatch, workload, fault):
    real_render, real_apply = traffic.Traffic.render, traffic.Traffic.apply
    state = {}

    def apply(self, t):
        state["t"] = t
        real_apply(self, t)

    def render(self):
        if fault == "stale":  # the state returned unchanged: the first frame again
            if "first" not in state:
                state["first"] = real_render(self).copy()
            first = state["first"]
            put(self, first)
            return first.copy()
        if fault == "control":
            ref = state.setdefault("ref", Reference(self.scene))
            rows = ref.rows(state.get("t"), range(-(-self.scene.height // 16)), round_bf16)
            img = np.concatenate([rows[r] for r in sorted(rows)])
        else:
            img = real_render(self).copy()
            if fault == "half":  # half of the frame left out
                img[img.shape[0] // 2:] = 0
            elif fault == "step":  # one channel one step off
                img[..., 0] = np.where(img[..., 0] < 255, img[..., 0] + 1, 254)
        put(self, img)
        return img

    monkeypatch.setattr(traffic.Traffic, "apply", apply)
    monkeypatch.setattr(traffic.Traffic, "render", render)
    b = bench()
    return run.run_cell(b, workload, SEED, 0.2, False, ROOT, device="cpu",
                        config_overrides=small(workload, b))


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("fault", ["half", "step", "control"])
def test_fault_fails_the_check(monkeypatch, workload, fault):
    result, checks = broken_run(monkeypatch, workload, fault)
    assert result["correct"] is False and result["failed"] >= 1
    assert checks["mismatch_pct"]["value"] > checks["mismatch_pct"]["limit"]


@pytest.mark.parametrize("workload", MOVING)
def test_stale_frames_fail_the_check(monkeypatch, workload):
    result, checks = broken_run(monkeypatch, workload, "stale")
    assert result["correct"] is False


@pytest.mark.parametrize("workload", cells())
def test_sound_run_passes(monkeypatch, workload):
    result, checks = broken_run(monkeypatch, workload, None)
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("workload", cells())
def test_control_reading_separates(workload):
    """The control module's reading at a tiny size: above each cell's limit."""
    from frame_bench import control
    import json

    b = bench()
    limit = json.loads((ROOT / "frame_bench" / "checks" / f"{workload}.json").read_text())
    got = control.reading(b, workload, SEED, small(workload, b), frames=(0, 5))
    assert got > limit["mismatch_pct"]
