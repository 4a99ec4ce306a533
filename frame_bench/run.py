"""Runs one cell of the benchmark once and prints its result line.

    python -m frame_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding `BENCHMARK.json`.  In order:

1. loads (or, the first time in a checkout, builds) the program's kernel
   library, which it keys by a hash of its sources under `build/`;
2. generates the cell's scene from the seed (`scenes/<scene>.py`, named by
   the configuration file) and composes it through the program's public
   API (the scene module's own `compose`, or `compose.py`'s), timed as
   `compose`;
3. warms up: the mix's warm-up frames, which capture the frame graphs and
   grow the buckets;
4. renders frames back to back for `--seconds` in a closed loop (one
   caller; the next frame starts when the last one's pixels are on the
   host), each frame timed from its scene update to its pixels;
5. with `--trace 1`, renders a few more frames under `torch.profiler`;
6. compares a seeded sample of the window's frames with the plain
   reference (the scene module's own `Reference`, or `reference/`'s), and
   prints the numbers compared on standard error and, as its last line,
   the result on standard output.

With `--trace 0` the metrics are the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, each read by `metrics/<name>.py`.  A
run exits non-zero and prints no result when the card (or the number of
cards the cell asks for) is missing, or when the JAX package, JAX or Flax
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import ctypes  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "forma_tpu")
TRACE_FRAMES = 50
# The host the renderer is deployed on, in every cell: its caller and
# PyTorch's CPU work on one thread (a render thread beside an application's
# others), and
# glibc's heap in one state whatever the process allocated before.  By
# default glibc moves its mmap threshold up to the size of the largest
# block freed so far and trims the heap's top past twice that, so whether
# a frame-sized array (`render`'s fresh 8.3 MB at 1080p) comes from pages
# already mapped or from new ones that fault while the copy lands depends
# on the process's allocation history.  Fixed thresholds end that: blocks
# up to 32 MiB come from the heap, which is never trimmed.
HOST = {"threads": 1, "malloc_mmap_threshold": 32 << 20, "malloc_trim_threshold": 1 << 30}
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3  # glibc's mallopt parameters


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"frame_bench: no {what} named {name!r} in BENCHMARK.json")


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        f"frame_bench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             root: Path, device: str = "cuda", config_overrides=None, t_start=None,
             trace_frames: int = TRACE_FRAMES):
    """Runs the cell; returns (result dict without `checks`, checks dict)."""
    import numpy as np
    import torch

    from . import check as _check
    from .scenes import module, paint
    from .trace import Trace, kernel_names
    from .traffic import Traffic

    t_start = T_START if t_start is None else t_start
    seed = int(seed) % (1 << 63)  # any whole number seeds numpy's generators
    cell = find(bench["workloads"], workload, "workload")
    cfg_entry = find(bench["configs"], cell["config"], "configuration")
    config = json.loads((root / cfg_entry["file"]).read_text())
    config.update(config_overrides or {})
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "checks" / f"{workload}.json").read_text())

    import forma_tpu_torch
    from forma_tpu_torch import Renderer

    if device != "cpu":
        from forma_tpu_torch.ops import _build

        _build.lib()  # the kernel library: built once a checkout, loaded after

    compose, Reference = paint(config["scene"])
    scene = module(config["scene"]).build(config, seed)
    t = time.perf_counter()
    comp = compose(scene)
    compose_s = time.perf_counter() - t

    renderer = Renderer(device)
    traffic = Traffic(mix, scene, config, seed, comp, renderer)
    spans = SimpleNamespace(update=[])
    # (index, transforms) of the frames rendered whose pixels are not on
    # the host yet: an entry with a lag hands them over frames later.
    pending = collections.deque()

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def one_frame(i, keeper=None, annotate=None):
        """Renders frame i; returns its seconds, and the frame whose
        pixels the entry handed over: (index, pixels, transforms), or
        None."""
        ctx = annotate or (lambda name: contextlib.nullcontext())
        f0 = time.perf_counter()
        with ctx("fb.frame"):
            tr = traffic.transforms(i)
            if tr is not None:
                with ctx("fb.update"):
                    u0 = time.perf_counter()
                    traffic.apply(tr)
                    if keeper is not None:
                        spans.update.append(time.perf_counter() - u0)
            with ctx("fb.render"):
                image = traffic.render()
        f1 = time.perf_counter()
        pending.append((i, tr))
        done = None
        if image is not None and len(pending) > traffic.lag:
            index, t = pending.popleft()
            done = (index, image, t)
            if keeper is not None:
                keeper.offer(*done)
        return f1 - f0, done

    i = 0
    for _ in range(mix["warmup_frames"]):
        one_frame(i)
        i += 1
    sync()
    stalls0 = renderer.graphs.captures + renderer.regrow_count

    # The window: a closed loop, frames back to back.
    keeper = _check.Keeper(limits["frames"], seed, (scene.height, scene.width, 4),
                           limits["rows"], limits.get("last_rows", limits["rows"]))
    times = []
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    while True:
        dt, done = one_frame(i, keeper)
        times.append(dt)
        i += 1
        if time.perf_counter() - t_window >= seconds:
            break
    window_s = time.perf_counter() - t_window
    image = traffic.finish()  # a frame still in flight: the window's last
    if image is not None:
        index, t = pending.popleft()
        done = (index, image, t)
    keeper.finish(done[0], done[1].copy(), done[2])
    stalls = renderer.graphs.captures + renderer.regrow_count - stalls0

    traced = None
    diags = []
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
        sync()
        with profile(activities=acts) as prof:
            for _ in range(trace_frames):
                one_frame(i, annotate=record_function)
                diags.append(np.asarray(renderer.last_diag).copy())
                i += 1
            sync()
        traced = Trace.read(prof, trace_frames)
    traffic.finish()

    memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    kind = torch.cuda.get_device_name() if device != "cpu" else "cpu"
    del traffic, renderer, comp
    if device != "cpu":
        torch.cuda.empty_cache()

    # The frames against the plain reference.
    frames = keeper.frames()
    found = _check.compare(Reference(scene), frames, seed)
    worst = max(p for _, p in found)
    failed = sum(p > limits["mismatch_pct"] for _, p in found)
    checks = {"mismatch_pct": {"value": worst, "limit": limits["mismatch_pct"]}}
    correct = failed == 0 and len(found) >= 1

    ctx = SimpleNamespace(
        frames=len(times), window_s=window_s, frame_s=times, setup_s=setup_s,
        compose_s=compose_s, update_s=spans.update, stalls=stalls, trace=traced,
        diags=diags, width=scene.width, height=scene.height,
        kernels=kernel_names(Path(forma_tpu_torch.__file__).parent / "csrc"))
    names = [m for m in bench["end_to_end" if not trace else "per_layer"]
             if workload in m.get("workloads", [workload])]
    metrics = {}
    for m in names:
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(times), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_device_ops(),
                               "idle_gaps": traced.idle_gaps()}
    if device != "cpu":
        dev["power_limit"] = power_limit()
    return result, checks


def power_limit() -> str:
    """The card's name and power limit, as `nvidia-smi` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def emit(result: dict, checks: dict) -> None:
    """The numbers compared, last on standard error; the result, last on
    standard output, with `checks` its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}))
    sys.stdout.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m frame_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = find(bench["workloads"], args.workload, "workload")
    # The port builds its kernels into the checkout's `build/forma_tpu_torch/`.
    os.environ["OMP_NUM_THREADS"] = str(HOST["threads"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"frame_bench: the cell needs {cell['chips']} CUDA card(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(HOST["threads"])
    libc = ctypes.CDLL("libc.so.6")
    for param, key in ((M_MMAP_THRESHOLD, "malloc_mmap_threshold"),
                       (M_TRIM_THRESHOLD, "malloc_trim_threshold")):
        if libc.mallopt(param, HOST[key]) != 1:
            print(f"frame_bench: glibc refused {key} {HOST[key]}", file=sys.stderr)
            return 2
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), root)
    bad = forbidden_modules()
    if bad:
        print(f"frame_bench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
