"""GPU smoke test of the PyTorch/CUDA port (`forma_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and `nvcc`.
Imports nothing of the JAX package: the scenes come from
`forma_tpu_torch.demos.scenes`.  Phases, each printing its own lines; any
failure exits non-zero:

1. device record: card name and power limit, CUDA, nvcc, triton;
2. build of the CUDA kernels from `forma_tpu_torch/csrc` (one nvcc process
   per source, all at once), timed;
3. paris-30k at 1920x1080: one frame through `Renderer.render_device` on
   each expand path records the inputs of K4, K2 and K3 (`expand="fused"`)
   and of K1 (`expand="split"`); each kernel then runs on them against its
   plain PyTorch version (bit-equal required), with median times over 20
   runs by CUDA events, the plain version's time, the bound from the bytes
   (at the TPU function's 32-bit widths; the int64 layout the port moves
   is printed beside them) and f32 operations of these inputs, and the
   time of one PyTorch library call that computes most of the same
   function, where there is one;
4. the circles configuration (64 circles, 256x256, fixed capacities)
   through `Renderer.render` on the card, against the same composition
   rendered by the port on the CPU, every kernel's plain version (max
   channel diff <= 1), then timed over 5 more frames;
5. paris-30k through `Renderer.render` on each path, the default
   `expand="fused"` and `expand="split"`: launch counters reset, one
   warm-up and 5 timed frames, counters read (each kernel of the path must
   have launched); then the same frame through every kernel's plain
   version on the card (max channel diff <= 1).

The last three lines are a JSON object with per-kernel results, the card's
name and power limit, and the status line `{"ok": true, "device": {...}}`.
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
    # name (= launch counter), source, TPU kernel it replaces, the expand
    # path whose timed run counts its launches
    ("expand", "forma_tpu_torch/csrc/expand.cu",
     "forma_tpu/ops/expand_pallas.py:175", "split"),
    ("rasterize", "forma_tpu_torch/csrc/rasterize.cu",
     "forma_tpu/ops/expand_pallas.py:356", "fused"),
    ("grid", "forma_tpu_torch/csrc/grid.cu",
     "forma_tpu/ops/grid_pallas.py:314", "fused"),
    ("fold", "forma_tpu_torch/csrc/fold.cu",
     "forma_tpu/ops/paint_pallas.py:468", "fused"),
)
PATHS = {"fused": ("rasterize", "grid", "fold"), "split": ("expand", "grid", "fold")}
PARIS_W, PARIS_H = 1920, 1080

# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per unit of work, counted from the kernel sources:
# csrc/rasterize.cu per pixel segment in range (two float-float `find`s of
# 88 ops each, 2 clamps, 4 endpoints of 5 ops); csrc/fold.cu per unit and
# pixel (coverage 7, Over 22).  K1 and K2 do no float arithmetic.
K4_F32_OPS_PER_SEGMENT = 198
K3_F32_OPS_PER_UNIT_PIXEL = 29


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


def tensor_bytes(ts, port_layout: bool = False) -> int:
    """Bytes of the tensors in `ts` at the TPU function's own widths: JAX
    runs in 32 bits, so each int64 of the port (a u32 or i32 value,
    `forma_tpu_torch/ops/_u32.py`) counts 4 bytes.  `port_layout` counts
    the bytes the port's tensors really hold."""
    def width(t):
        return 4 if t.dtype == torch.int64 and not port_layout else t.element_size()
    return sum(t.numel() * width(t) for t in ts if isinstance(t, torch.Tensor))


def f32_ops(name: str, args) -> int:
    """f32 operations the kernel does on these inputs (data-dependent)."""
    if name == "rasterize":
        params, vline_ends, v_total, v_cap, k_seg = args[:5]
        # Segments in range: every live line's length, up to v_total vlines.
        assert int(v_total) == int(vline_ends[-1]) <= v_cap
        return K4_F32_OPS_PER_SEGMENT * int(params[:, 15].double().sum())
    if name == "fold":
        return K3_F32_OPS_PER_UNIT_PIXEL * 256 * int(args[1].long().sum())
    return 0


def library_call(name: str, args):
    """(description, fn) of one PyTorch call computing most of the kernel's
    function on the same inputs, or None.  Timed only: the port never
    calls these."""
    if name == "expand":
        params, vline_ends, _ = args
        n_v = torch.diff(vline_ends, prepend=vline_ends.new_zeros(1))
        total = int(vline_ends[-1])
        return ("torch.repeat_interleave(params, n_v, dim=0): the row gather "
                "without j, the [16, V] layout or padding",
                lambda: torch.repeat_interleave(params, n_v, dim=0, output_size=total))
    if name == "grid":
        rid, cell, area, cover, _, _, run_cap = args
        idx = rid.long() * 256 + cell.long()
        val = (area * 65536 + cover).to(torch.int32)
        flat = torch.zeros(run_cap * 256, dtype=torch.int32, device=rid.device)
        return ("Tensor.index_add_ of the packed area|cover grid: without "
                "rowcov or run keys", lambda: flat.index_add_(0, idx, val))
    return None


def check_kernels(taps) -> dict:
    """Phase 3: every kernel against its plain version on the frame's own
    inputs; returns {name: dict of the kernels line's numbers}."""
    from forma_tpu_torch.ops import expand_kernel as ek
    from forma_tpu_torch.ops import fold_kernel as fk
    from forma_tpu_torch.ops import grid_kernel as gk
    from forma_tpu_torch.ops import rasterize_kernel as rk

    pairs = {
        "expand": (ek.expand_params, ek.expand_params_torch),
        "rasterize": (rk.rasterize_blocks, rk.rasterize_blocks_torch),
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
        nbytes = tensor_bytes(args) + tensor_bytes(got)
        port_bytes = tensor_bytes(args, True) + tensor_bytes(got, True)
        ops = f32_ops(name, args)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        lib = library_call(name, args)
        library_ms = time_ms(lib[1]) if lib else None
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        say("kernel", name=name, max_abs_err=err, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bytes=nbytes, port_layout_bytes=port_bytes,
            f32_ops=ops,
            bound_ms=f"{max(bytes_ms, ops_ms):.4f}",
            library_ms="none" if library_ms is None else f"{library_ms:.4f}",
            input_shapes=str(shapes).replace(" ", ""))
        if lib:
            say("kernel", name=name, library_call=repr(lib[0]))
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain version ({err})")
        res[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        }
    return res


def circles_vs_cpu(device) -> None:
    """Phase 4: the circles configuration on the card against the port's
    CPU render (every plain version) of the same composition."""
    from forma_tpu_torch import Caps, Color, Composition, Renderer
    from forma_tpu_torch.demos import scenes

    comp = Composition()
    scenes.circles(comp, 64, 256, 256)
    clear = Color(1.0, 1.0, 1.0, 1.0)
    caps = Caps(vline=8192, run=8192, virt=8192, k=16)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r = Renderer(device, caps=caps)
    t = time.perf_counter()
    img = r.render(comp, 256, 256, clear)  # returns on the host: synced
    ms = (time.perf_counter() - t) * 1e3
    want = Renderer("cpu", caps=caps).render(comp, 256, 256, clear)
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
        frame_ms_max=f"{max(times):.2f}", max_diff_vs_cpu=diff, diag=r.last_diag.tolist(),
        peak_memory_above_baseline=torch.cuda.max_memory_allocated() - base)
    if diff > 1:
        raise AssertionError(f"circles: max channel diff {diff} > 1 vs the port on the CPU")


def paris_path(r, comp, ref, n_timed: int = 5) -> dict:
    """Phase 5 for one expand path: counters reset, warm-up + timed frames
    through Renderer.render, counters read; the frame against `ref`."""
    from forma_tpu_torch import Color
    from forma_tpu_torch.ops import _build

    clear = Color(1.0, 1.0, 1.0, 1.0)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    img = r.render(comp, PARIS_W, PARIS_H, clear)
    times = []
    for _ in range(n_timed):
        t = time.perf_counter()
        img = r.render(comp, PARIS_W, PARIS_H, clear)
        times.append((time.perf_counter() - t) * 1e3)
    launches = dict(_build.LAUNCHES)
    diff = np.abs(img.astype(int) - ref.astype(int))
    say("paris", expand=r.expand, frame_ms_median=f"{statistics.median(times):.2f}",
        frame_ms_min=f"{min(times):.2f}", frame_ms_max=f"{max(times):.2f}",
        frames=len(times), diag=r.last_diag.tolist(),
        max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
    say("paris", expand=r.expand, max_diff_vs_plain=int(diff.max()),
        differing_pixels=int((diff > 0).any(axis=-1).sum()),
        painted_pixels=int((img[..., :3] != 255).any(axis=-1).sum()))
    if img.shape != (PARIS_H, PARIS_W, 4):
        raise AssertionError(f"paris: frame shape {img.shape}")
    for name in PATHS[r.expand]:
        if launches[name] < 1:
            raise AssertionError(
                f"paris: kernel {name} was never launched on the {r.expand} path")
    if diff.max() > 1:
        raise AssertionError(f"paris ({r.expand}): max channel diff {diff.max()} > 1 vs the plain path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from forma_tpu_torch import Color, Composition, Renderer
    from forma_tpu_torch.demos import scenes
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
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            say("ptxas", info=line.strip())

    # 3. paris-30k: record kernel inputs from one real frame per path
    t = time.perf_counter()
    paris = Composition()
    scenes.paris30k(paris, PARIS_W, PARIS_H)
    say("paris", scene_build_s=f"{time.perf_counter() - t:.1f}", layers=len(paris.layers))
    device = torch.device("cuda", 0)
    clear = Color(1.0, 1.0, 1.0, 1.0)
    # The default Renderer is the main path (expand="fused").
    renderers = {"fused": Renderer(device), "split": Renderer(device, expand="split")}
    taps = {path: {} for path in PATHS}
    for path, r in renderers.items():
        t = time.perf_counter()
        r.render_device(paris, PARIS_W, PARIS_H, clear, taps=taps[path])
        torch.cuda.synchronize()
        say("paris", expand=path, first_frame_s=f"{time.perf_counter() - t:.2f}",
            caps=tuple(r._caps), regrows=r.regrow_count)
    kres = check_kernels({**taps["fused"], "expand": taps["split"]["expand"]})
    del taps

    # 4. circles on the card vs the port on the CPU
    circles_vs_cpu(device)

    # 5. paris-30k through the main path, each expand path
    r = renderers["fused"]
    ref, _ = r.render_device(paris, PARIS_W, PARIS_H, clear, plain=True)
    ref = ref[:PARIS_H, :PARIS_W].cpu().numpy()
    launches = {path: paris_path(rr, paris, ref) for path, rr in renderers.items()}

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[path][name], **kres[name]}
        for name, src, rep, path in KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
