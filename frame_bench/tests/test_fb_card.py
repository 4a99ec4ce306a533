"""On a CUDA card: a short run of each cell through the command line, from
the root of the checkout, prints a correct result line.

    python -m pytest frame_bench/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from small import ROOT, cells


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_cell_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "frame_bench.run", "--workload", workload, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True and last["device"]["platform"] == "gpu"
    assert last["device"]["busy_s"] > 0
