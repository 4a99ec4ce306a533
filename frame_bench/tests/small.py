"""Tiny sizes of the benchmark's configurations, for the CPU tests."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL = {
    "paris30k-1080p": dict(width=160, height=96, paths=300),
    "spaceship-1080p": dict(width=160, height=96, asteroids=6, bullets=2),
}
SEED = 2**31 + 11


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells():
    return [w["name"] for w in bench()["workloads"]]


def small(workload, b=None):
    b = b or bench()
    cell = next(w for w in b["workloads"] if w["name"] == workload)
    return SMALL[cell["config"]]
