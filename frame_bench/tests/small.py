"""Tiny sizes of the benchmark's configurations, for the CPU tests.

Each configuration's tiny size is a file of its own,
`small/<configuration>.json`: the keys of its configuration file that the
tests override.  A cell whose configuration has none is left out of the
cells the tests run, and `test_fb_cells.py` fails one test that names it.
"""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = Path(__file__).resolve().parent / "small"
SEED = 2**31 + 11


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(config_name):
    """The overrides of configuration `config_name`; None where it has none."""
    path = SIZES / f"{config_name}.json"
    return json.loads(path.read_text()) if path.is_file() else None


def unsized():
    """The configurations that have no tiny size."""
    return [c["name"] for c in bench()["configs"] if tiny(c["name"]) is None]


def cells():
    """The cells whose configuration has a tiny size."""
    return [w["name"] for w in bench()["workloads"] if tiny(w["config"]) is not None]


def _cell(workload, b):
    return next(w for w in b["workloads"] if w["name"] == workload)


def config(workload, b=None):
    """The cell's configuration, as its file holds it."""
    b = b or bench()
    entry = next(c for c in b["configs"] if c["name"] == _cell(workload, b)["config"])
    return json.loads((ROOT / entry["file"]).read_text())


def small(workload, b=None):
    """The overrides of the cell's configuration."""
    return tiny(_cell(workload, b or bench())["config"])
