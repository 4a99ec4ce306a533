"""GPU smoke test of the PyTorch/CUDA port (`forma_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and `nvcc`.
Phases, each printing its own lines; any failure exits non-zero:

1. device record: card name and power limit, CUDA, nvcc, triton;
2. build of the CUDA kernels from `forma_tpu_torch/csrc`, timed;
3. paris-30k at 1920x1080 (`forma_tpu.demos.scenes.paris30k`): one frame
   through `Renderer.render` records the inputs of K1, K2 and K3; each
   kernel then runs on them against its plain PyTorch version (bit-equal
   required), with median times over 20 runs by CUDA events;
4. the circles configuration (64 circles, 256x256, fixed capacities) through
   `Renderer.render`, against the numpy oracle (max channel diff <= 1), then
   timed over 5 more frames;
5. paris-30k through `Renderer.render`: launch counters reset, one warm-up
   and 5 timed frames, counters read (each kernel must have launched); then
   the same frame through every kernel's plain version on the card (max
   channel diff <= 1).

The last two lines are a JSON object with per-kernel results and the
final status line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = (
    # name, counter, source, TPU kernel it replaces
    ("expand", "expand", "forma_tpu_torch/csrc/expand.cu",
     "forma_tpu/ops/expand_pallas.py:175"),
    ("grid", "grid", "forma_tpu_torch/csrc/grid.cu",
     "forma_tpu/ops/grid_pallas.py:314"),
    ("fold", "fold", "forma_tpu_torch/csrc/fold.cu",
     "forma_tpu/ops/paint_pallas.py:468"),
)
PARIS_W, PARIS_H = 1920, 1080


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def gpu_record() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, runs: int = 20) -> float:
    """Median milliseconds of `fn()` by CUDA events (after one warm-up)."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want) -> float:
    """Max |got - want| over a kernel's outputs; f32 outputs compare by
    bits first, so equal infinities and NaNs count as no error."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output mismatch {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.dtype == torch.float32:
            same = g.view(torch.int32) == w.view(torch.int32)
            d = torch.where(same, 0.0, (g.double() - w.double()).abs())
            d = torch.nan_to_num(d, nan=float("inf"))
        else:
            d = (g.long() - w.long()).abs().double()
        if d.numel():
            worst = max(worst, float(d.max()))
    return worst


def check_kernels(taps) -> dict:
    """Phase 3: every kernel against its plain version on the frame's own
    inputs; returns {name: (max_abs_err, ms, plain_ms)}."""
    from forma_tpu_torch.ops import expand_kernel as ek
    from forma_tpu_torch.ops import fold_kernel as fk
    from forma_tpu_torch.ops import grid_kernel as gk

    pairs = {
        "expand": (ek.expand_params, ek.expand_params_torch),
        "grid": (gk.grid_build, gk.grid_build_torch),
        "fold": (fk.paint_fold, fk.paint_fold_torch),
    }
    res = {}
    for name, (kern, plain) in pairs.items():
        args = taps[name]
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        ms = time_ms(lambda: kern(*args))
        plain_ms = time_ms(lambda: plain(*args))
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        say("kernel", name=name, max_abs_err=err, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", input_shapes=str(shapes).replace(" ", ""))
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain version ({err})")
        res[name] = (err, ms, plain_ms)
    return res


def circles_vs_oracle(device) -> None:
    """Phase 4: the circles configuration against the numpy oracle."""
    from forma_tpu import Color, Composition
    from forma_tpu.backend_numpy import render as oracle
    from forma_tpu.demos import scenes
    from forma_tpu_torch import Caps, Renderer

    comp = Composition()
    scenes.circles(comp, 64, 256, 256)
    clear = Color(1.0, 1.0, 1.0, 1.0)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r = Renderer(device, caps=Caps(vline=8192, run=8192, virt=8192, k=16))
    t = time.perf_counter()
    img = r.render(comp, 256, 256, clear)  # returns on the host: synced
    ms = (time.perf_counter() - t) * 1e3
    want = oracle(comp, 256, 256, clear_color=clear)
    if img.shape != want.shape:
        raise AssertionError(f"circles: shape {img.shape} vs {want.shape}")
    diff = int(np.abs(img.astype(int) - want.astype(int)).max())
    times = []
    for _ in range(5):
        t = time.perf_counter()
        r.render(comp, 256, 256, clear)
        times.append((time.perf_counter() - t) * 1e3)
    say("circles", size="256x256", first_frame_ms=f"{ms:.1f}",
        frame_ms_median=f"{statistics.median(times):.2f}", frame_ms_min=f"{min(times):.2f}",
        frame_ms_max=f"{max(times):.2f}", max_diff_vs_oracle=diff, diag=r.last_diag.tolist(),
        peak_memory_above_baseline=torch.cuda.max_memory_allocated() - base)
    if diff > 1:
        raise AssertionError(f"circles: max channel diff {diff} > 1 vs the oracle")


def paris_frames(r, comp, n_timed: int = 5):
    """Phase 5: warm-up + timed frames through Renderer.render; returns
    (last frame, per-frame ms)."""
    from forma_tpu import Color

    clear = Color(1.0, 1.0, 1.0, 1.0)
    img = r.render(comp, PARIS_W, PARIS_H, clear)
    times = []
    for _ in range(n_timed):
        t = time.perf_counter()
        img = r.render(comp, PARIS_W, PARIS_H, clear)
        times.append((time.perf_counter() - t) * 1e3)
    return img, times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from forma_tpu import Color, Composition
    from forma_tpu.demos import scenes
    from forma_tpu_torch import Renderer
    from forma_tpu_torch.ops import _build

    # 1. device record
    card = gpu_record()
    try:
        import triton

        triton_ok = f"yes ({triton.__version__})"
    except ImportError:
        triton_ok = "no"
    say("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=shutil.which("nvcc") or _build._nvcc(), triton=triton_ok,
        count=torch.cuda.device_count())

    # 2. build
    t = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    say("build", seconds=f"{time.perf_counter() - t:.1f}", library=os.path.relpath(lib_path, REPO))
    for line in (lib_path.parent / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say("ptxas", info=line.strip())

    # 3. paris-30k: record kernel inputs from one real frame, check kernels
    t = time.perf_counter()
    paris = Composition()
    scenes.paris30k(paris, PARIS_W, PARIS_H)
    say("paris", scene_build_s=f"{time.perf_counter() - t:.1f}", layers=len(paris.layers))
    device = torch.device("cuda", 0)
    r = Renderer(device)
    taps = {}
    t = time.perf_counter()
    r.render_device(paris, PARIS_W, PARIS_H, Color(1.0, 1.0, 1.0, 1.0), taps=taps)
    torch.cuda.synchronize()
    say("paris", first_frame_s=f"{time.perf_counter() - t:.2f}", caps=tuple(r._caps),
        regrows=r.regrow_count)
    kres = check_kernels(taps)
    del taps

    # 4. circles vs the numpy oracle
    circles_vs_oracle(device)

    # 5. paris-30k through the main path
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    img, times = paris_frames(r, paris)
    launches = dict(_build.LAUNCHES)
    say("paris", frame_ms_median=f"{statistics.median(times):.2f}",
        frame_ms_min=f"{min(times):.2f}", frame_ms_max=f"{max(times):.2f}",
        frames=len(times), diag=r.last_diag.tolist(),
        max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
    if img.shape != (PARIS_H, PARIS_W, 4):
        raise AssertionError(f"paris: frame shape {img.shape}")
    for name, counter, _, _ in KERNELS:
        if launches[counter] < 1:
            raise AssertionError(f"paris: kernel {name} was never launched on the main path")
    ref, _ = r.render_device(paris, PARIS_W, PARIS_H, Color(1.0, 1.0, 1.0, 1.0), plain=True)
    ref = ref[:PARIS_H, :PARIS_W].cpu().numpy()
    diff = np.abs(img.astype(int) - ref.astype(int))
    say("paris", max_diff_vs_plain=int(diff.max()),
        differing_pixels=int((diff > 0).any(axis=-1).sum()),
        painted_pixels=int((img[..., :3] != 255).any(axis=-1).sum()))
    if diff.max() > 1:
        raise AssertionError(f"paris: max channel diff {diff.max()} > 1 vs the plain path")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[counter], "max_abs_err": kres[name][0],
         "ms": kres[name][1], "plain_ms": kres[name][2]}
        for name, counter, src, rep in KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
