"""Every cell runs end to end at a tiny size on the CPU (`Renderer("cpu")`)
and prints a well-formed result line."""

import json

import pytest

from frame_bench import run
from small import ROOT, SEED, bench, cells, small, unsized

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def line(capsys, workload, trace):
    b = bench()
    result, checks = run.run_cell(b, workload, SEED, 0.3, trace, ROOT, device="cpu",
                                  config_overrides=small(workload, b), trace_frames=3)
    run.emit(result, checks)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    return b, last, err


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_its_line(capsys, workload, trace):
    b, last, err = line(capsys, workload, bool(trace))
    assert list(last)[:5] == list(KEYS) and list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    want = [m["name"] for m in b["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]
    # On the CPU the device-trace metrics find nothing to read and are left out.
    cpu_only = {m["name"] for m in b["per_layer"] if m["source"] == "device_trace"}
    assert set(want) - cpu_only <= set(last["metrics"]) <= set(want)
    for name, m in last["metrics"].items():
        unit = next(x["unit"] for x in b["per_layer"] + b["end_to_end"] if x["name"] == name)
        assert m["unit"] == unit and isinstance(m["value"], (int, float))
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    assert err.strip().splitlines()[-1].startswith("check mismatch_pct ")
    assert last["checks"]["mismatch_pct"]["value"] <= last["checks"]["mismatch_pct"]["limit"]


def test_every_configuration_has_a_tiny_size():
    """A configuration's tests run at the size in `small/<configuration>.json`;
    one without the file has no cell among those above."""
    assert unsized() == [], f"no tests/small/<configuration>.json for {unsized()}"


def test_no_card_no_result(capsys, monkeypatch):
    """Without a card (or with fewer than the cell asks for) a run exits
    non-zero and prints no result."""
    import torch

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # restored after: the run sets it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    assert run.forbidden_modules() == []  # forma_tpu_torch is loaded, and is not forma_tpu
    monkeypatch.setitem(sys.modules, "forma_tpu.ops", types.ModuleType("forma_tpu.ops"))
    assert run.forbidden_modules() == ["forma_tpu"]
