"""The comparison's control: the plain reference put in the program's place,
its paint stage held in bfloat16 (the configurations state float32), read
by the same comparison as a run's frames.

    python -m frame_bench.control --workload <cell> --seeds <n> [<n> ...]

For each seed it builds the cell's scene, steps its motion to the frames
a run would check (after the warm-up: a few across a window), renders the
same seeded tile rows in both precisions and prints, for each seed, the
largest `mismatch_pct` over those frames, and their least over the seeds:
the control's reading, which a run's limit must stay below.  It imports
nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import check
from .reference import Reference
from .reference.paint import round_bf16
from .scenes import module
from .traffic import motion

HERE = Path(__file__).resolve().parent
FRAMES_AFTER_WARMUP = (60, 300, 600)


def reading(bench: dict, workload: str, seed: int, config_overrides=None,
            frames=FRAMES_AFTER_WARMUP) -> float:
    """The control's `mismatch_pct` for one seed: its worst checked frame."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((HERE.parent / cfg["file"]).read_text())
    config.update(config_overrides or {})
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "checks" / f"{workload}.json").read_text())
    scene = module(config["scene"]).build(config, seed)
    update = motion(mix, scene, config, seed)
    ref = Reference(scene)
    want = {mix["warmup_frames"] + k for k in frames}
    worst = 0.0
    for i in range(max(want) + 1):
        t = update.transforms(i)
        if i not in want:
            continue
        rows = check.rows_of(scene.height, limits["rows"], seed, i)
        low = ref.rows(t, rows, lowp=round_bf16)
        image = _stack(low, scene)
        # Rows not sampled are never read; only the sampled ones are compared.
        (_, pct), = check.compare(ref, [(i, image, t, limits["rows"])], seed)
        worst = max(worst, pct)
    return worst


def _stack(rows: dict, scene):
    import numpy as np

    image = np.zeros((scene.height, scene.width, 4), np.uint8)
    for r, px in rows.items():
        image[r * check.TILE:r * check.TILE + px.shape[0]] = px
    return image


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m frame_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    found = {}
    for seed in args.seeds:
        found[seed] = reading(bench, args.workload, seed)
        print(f"control {args.workload} seed {seed} mismatch_pct {found[seed]!r}", flush=True)
    print(json.dumps({"workload": args.workload, "control_mismatch_pct": found,
                      "least": min(found.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
