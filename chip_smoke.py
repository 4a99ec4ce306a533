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
   plain PyTorch version (bit-equal required), with times by CUDA events
   (`ms`: median of 5 batches of 10 calls queued back to back; `ms_sync`:
   median of 20 calls, each synchronised alone, which also counts the
   wrapper's host work when it exceeds the queue's slack), the wrapper's
   host microseconds per call, the plain version's time (median of 3
   calls), the bound from the bytes (at the TPU function's 32-bit widths;
   for K3 only the rows the fold addresses, with the full capacity tables
   and the int64 layout the port moves printed beside them) and f32
   operations of these inputs, and the time of one PyTorch library call
   that computes most of the same function, where there is one;
4. the circles configuration (64 circles, 256x256, fixed capacities)
   through `Renderer.render` on the card, against the same composition
   rendered by the port on the CPU, every kernel's plain version (max
   channel diff <= 1), then timed over 5 more frames;
5. paris-30k through `Renderer.render` on each path, the default
   `expand="fused"` and `expand="split"`: launch counters reset, one
   warm-up and 5 timed frames, counters read (each kernel of the path must
   have launched); then the same frame through every kernel's plain
   version on the card (max channel diff <= 1);
6. paris-30k-styled at 1920x1080 (linear-gradient buildings, Screen-
   blended roads, radial-gradient parks): K3's styled specialisation on
   the frame's own inputs against its plain version, as in phase 3; then
   the frame through `Renderer.render` as in phase 5 (counters, warm-up
   and 5 timed frames, peak memory) against the plain path on the card;
7. the styled mix (`scenes.styled_mix`: 400 layers at 512x512 with
   gradients, all 16 blend modes, clips and clipped draws, both fill
   rules): K3's clip specialisation on its inputs against its plain
   version, then the frame through `Renderer.render` (counters read)
   against the port's CPU render (max channel diff <= 1);
8. paris-30k-textured at 1920x1080 (21,000 buildings filled from an atlas
   of 8 shared 32x32 images, roads and parks solid): K3's textured
   specialisation on the frame's own inputs against its plain version, as
   in phase 3; then the frame as in phase 6;
9. the textured mix (`scenes.textured_mix`: 300 layers at 512x512, most
   of them textured through rotated transforms, with gradients, blend
   modes, clips and clipped textured draws): K3's clip specialisation with
   textures against its plain version, then the frame against the port's
   CPU render, as in phase 7;
10. K5, the texture-fold probe (`forma_tpu_torch.probes.texture_fold`):
   its three modes against the plain version (bit-equal) at 8 blocks of
   32 tiles and 44 steps; then its entry point's measurement at the
   probe's paris shape (255 blocks), counters reset and read, each mode
   checked and timed there as in phase 3, and the probe's window gather.

The last three lines are a JSON object with per-kernel results (K3 once
per specialisation: solid, styled, textured, clip; K5 in its atlas_rowsel
mode), the card's name and power limit, and the status line
`{"ok": true, "device": {...}}`.

    python3 chip_smoke.py --fold-timing DIR [--scene paris|styled|textured]

times K3 alone instead, on one paris-30k (or paris-30k-styled, or
paris-30k-textured) frame's own inputs, with the port of the checkout in
DIR (for example a parent commit unpacked with `git archive`), in both ways
above and with the wrapper's host microseconds: run it for two trees in one
call to compare them.
"""

from __future__ import annotations

import argparse
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
K3 = "forma_tpu/ops/paint_pallas.py:468"
KERNELS = (
    # name (= launch counter), source, TPU kernel it replaces, the run whose
    # launches count for it: an expand path of paris-30k, the styled or
    # textured frame, the styled mix, or the probe's entry point
    ("expand", "forma_tpu_torch/csrc/expand.cu",
     "forma_tpu/ops/expand_pallas.py:175", "split"),
    ("rasterize", "forma_tpu_torch/csrc/rasterize.cu",
     "forma_tpu/ops/expand_pallas.py:356", "fused"),
    ("grid", "forma_tpu_torch/csrc/grid.cu",
     "forma_tpu/ops/grid_pallas.py:314", "fused"),
    ("fold", "forma_tpu_torch/csrc/fold.cu", K3, "fused"),
    ("fold_styled", "forma_tpu_torch/csrc/fold.cu", K3, "styled"),
    ("fold_tex", "forma_tpu_torch/csrc/fold.cu", K3, "textured"),
    ("fold_clip", "forma_tpu_torch/csrc/fold.cu", K3, "mix"),
    ("texture_probe", "forma_tpu_torch/csrc/texture_probe.cu",
     "tools/texture_fold_probe.py:157", "probe"),
)
PATHS = {
    "fused": ("rasterize", "grid", "fold"),
    "split": ("expand", "grid", "fold"),
    "styled": ("rasterize", "grid", "fold_styled"),
    "mix": ("rasterize", "grid", "fold_clip"),
    "textured": ("rasterize", "grid", "fold_tex"),
    "texmix": ("rasterize", "grid", "fold_clip"),
}
PARIS_W, PARIS_H = 1920, 1080
MIX_W, MIX_H = 512, 512
PARIS_SCENES = {"paris": "paris30k", "styled": "paris30k_styled",
                "textured": "paris30k_textured"}

# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per unit of work, counted from the kernel sources:
# csrc/rasterize.cu per pixel segment in range (two float-float `find`s of
# 88 ops each, 2 clamps, 4 endpoints of 5 ops); csrc/fold.cu per unit and
# pixel: coverage 7 and Over 22; a gradient fill 16 for t (linear and
# radial, select), one compare per stop and 25 to interpolate the one
# segment the pixel falls in (the work the stop chain needs; the select
# tree computes every segment); a texture fill 18 (two affine coordinates
# of 4, min, trunc and max on each, 4 float -> int conversions); a clip
# frame 2 (clip-mask and draw multiplies); a blend mode its count below
# (three channels).  K1 and K2 do no float arithmetic.
# csrc/texture_probe.cu per pixel and step: 9 for the coordinates (tx + k
# included), 2 more for the base mode's texel or 6 (trunc and a 2-sided
# clip per axis) for a sampling mode's, 4 to accumulate; per pixel once, 6
# for the parameters.
K4_F32_OPS_PER_SEGMENT = 198
K3_F32_OPS_PER_UNIT_PIXEL = 29
K3_GRAD_OPS, K3_STOP_OPS, K3_SEGMENT_OPS, K3_CLIP_OPS = 16, 1, 25, 2
K3_TEX_OPS = 18
K3_BLEND_OPS = (0, 3, 9, 21, 3, 3, 12, 15, 21, 51, 6, 12, 84, 84, 59, 59)
K5_COORD_OPS, K5_BASE_OPS, K5_SAMPLE_OPS, K5_ACC_OPS, K5_PRM_OPS = 9, 2, 6, 4, 6

def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def gpu_record() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, batches: int = 5, per_batch: int = 10) -> float:
    """Milliseconds per call of `fn()` by CUDA events, after one warm-up:
    the median over `batches` of the mean of `per_batch` calls queued back
    to back, so the host work of each call overlaps the device work of the
    one before (one synchronised call per event pair would also count the
    wrapper's host time whenever it exceeds the queue's slack)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_batch)
    return statistics.median(times)


def time_ms_sync(fn, runs: int = 20) -> float:
    """Median milliseconds of `fn()` by CUDA events, one synchronised call
    per event pair (after one warm-up): the device time plus whatever of
    the call's host work the queue does not hide."""
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


def host_us(fn, runs: int = 100) -> float:
    """Median host microseconds of one call of `fn()` on an idle device:
    the wrapper's checks, allocation and launch (the kernel runs on after
    it returns)."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
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


def fold_units(args) -> tuple:
    """The units K3 folds on these inputs, tile by tile (units ust[t] ..
    ust[t] + cnt[t] - 1 of tile t): (unit count, run of each unit, whether
    it is virtual), as the kernel addresses them."""
    ust, cnt, src2, tx_s, tiles_x = args[0], args[1], args[2], args[7], args[10]
    n = cnt.long()
    tile = torch.repeat_interleave(torch.arange(ust.shape[0], device=ust.device), n)
    k = torch.arange(tile.numel(), device=ust.device) - (torch.cumsum(n, 0) - n)[tile]
    u = (ust.long()[tile] + k).clamp(max=src2.shape[0] - 1)
    r = src2[u].long().clamp(0, tx_s.shape[0] - 1)
    return u.numel(), r, tx_s[r].long() != tile % tiles_x


def fold_bytes(args, out) -> int:
    """Bytes K3 must move on these inputs, 4 per i32 or f32 value: the tile
    spans; src2 (and virt_u in a clip frame) of each folded unit; the grid
    row and carry_in row of each run a real unit folds; the carry_after row
    of each run a virtual unit folds; tx_s and the style row of each run
    folded (a texture frame's row holds its 10 texture lanes); clear; the
    atlas of a texture frame, once; the output."""
    n_units, r, virt = fold_units(args)
    ust, virt_u, style_s, atlas = args[0], args[3], args[8], args[13]
    real_runs = torch.unique(r[~virt]).numel()
    virt_runs = torch.unique(r[virt]).numel()
    runs = torch.unique(r).numel()
    words = (2 * ust.numel() + n_units * (1 if virt_u is None else 2)
             + real_runs * (256 + 16) + virt_runs * 16 + runs * (1 + style_s.shape[1]) + 4)
    return 4 * words + tensor_bytes((atlas,)) + tensor_bytes(out)


def probe_bytes(args, out) -> int:
    """Bytes K5 must move: info, the f32 atlas once (not read by the base
    mode), the output."""
    info, atlas, mode = args[:3]
    return tensor_bytes((info,) if mode == "base" else (info, atlas)) + tensor_bytes(out)


def fold_unit_ops(args) -> torch.Tensor:
    """f32 operations per pixel of each unit K3 folds (data-dependent: its
    fill type and blend mode), int64 [units folded]."""
    from forma_tpu_torch.ops.fold_kernel import style_layout

    style_s, features, ms = args[8], args[11], args[12]
    lay = style_layout(features, ms)
    st = style_s[fold_units(args)[1]]
    ops = torch.full((st.shape[0],), K3_F32_OPS_PER_UNIT_PIXEL, dtype=torch.int64,
                     device=st.device)
    if lay.grad >= 0:
        grad = K3_GRAD_OPS + K3_STOP_OPS * ms + K3_SEGMENT_OPS
        ops += torch.where(st[:, lay.ft] == 1, grad, 0)
    if lay.tex >= 0:
        ops += torch.where(st[:, lay.ft] == 2, K3_TEX_OPS, 0)
    if lay.blend >= 0:
        table = torch.tensor(K3_BLEND_OPS, dtype=torch.int64, device=st.device)
        ops += table[st[:, lay.blend].long().clamp(0, 15)]
    if lay.func >= 0:
        ops += K3_CLIP_OPS
    return ops


def f32_ops(name: str, args) -> int:
    """f32 operations the kernel does on these inputs (data-dependent)."""
    if name == "rasterize":
        params, vline_ends, v_total, v_cap, k_seg = args[:5]
        # Segments in range: every live line's length, up to v_total vlines.
        assert int(v_total) == int(vline_ends[-1]) <= v_cap
        return K4_F32_OPS_PER_SEGMENT * int(params[:, 15].double().sum())
    if name.startswith("fold"):
        return 256 * int(fold_unit_ops(args).sum())
    if name == "texture_probe":
        info, _, mode, kmax = args
        texel = K5_BASE_OPS if mode == "base" else K5_SAMPLE_OPS
        per_step = K5_COORD_OPS + texel + K5_ACC_OPS
        return 256 * info.shape[0] * (kmax * per_step + K5_PRM_OPS)
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


def check_kernel(name: str, kern, plain, args) -> dict:
    """A kernel against its plain version on a frame's own inputs (bit-equal
    required); returns the kernels line's numbers for it."""
    got = kern(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(got, want)
    ms = time_ms(lambda: kern(*args))
    ms_sync = time_ms_sync(lambda: kern(*args))
    wrapper_us = host_us(lambda: kern(*args))
    plain_ms = time_ms(lambda: plain(*args), batches=3, per_batch=1)
    table_bytes = tensor_bytes(args) + tensor_bytes(got)
    port_bytes = tensor_bytes(args, True) + tensor_bytes(got, True)
    nbytes = (fold_bytes(args, got) if name.startswith("fold")
              else probe_bytes(args, got) if name == "texture_probe" else table_bytes)
    ops = f32_ops(name, args)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    lib = library_call(name, args)
    library_ms = time_ms(lib[1]) if lib else None
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    mode = {"mode": args[2]} if name == "texture_probe" else {}
    say("kernel", name=name, **mode, max_abs_err=err, ms=f"{ms:.4f}", ms_sync=f"{ms_sync:.4f}",
        host_us=f"{wrapper_us:.1f}", plain_ms=f"{plain_ms:.4f}", bytes=nbytes,
        table_bytes=table_bytes, port_layout_bytes=port_bytes, f32_ops=ops,
        bound_ms=f"{max(bytes_ms, ops_ms):.4f}",
        library_ms="none" if library_ms is None else f"{library_ms:.4f}",
        input_shapes=str(shapes).replace(" ", ""))
    if lib:
        say("kernel", name=name, library_call=repr(lib[0]))
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain version ({err})")
    return {
        "max_abs_err": err, "ms": ms, "ms_sync": ms_sync, "host_us": wrapper_us,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


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
    return {name: check_kernel(name, *pair, taps[name]) for name, pair in pairs.items()}


def check_fold(name: str, args) -> dict:
    """K3's specialisation `name` (the launch counter its features select)
    against its plain version on a frame's own inputs."""
    from forma_tpu_torch.ops import fold_kernel as fk

    if fk.variant(args[11]) != name:
        raise AssertionError(f"{name}: the frame's features {args[11]} select "
                             f"{fk.variant(args[11])}")
    return check_kernel(name, fk.paint_fold, fk.paint_fold_torch, args)


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


def frame_path(label: str, path: str, r, comp, size, ref, n_timed: int = 5) -> dict:
    """Phases 5-9 for one path: counters reset, warm-up + timed frames
    through Renderer.render, counters read; the frame against `ref`."""
    from forma_tpu_torch import Color
    from forma_tpu_torch.ops import _build

    w, h = size
    clear = Color(1.0, 1.0, 1.0, 1.0)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    img = r.render(comp, w, h, clear)
    times = []
    for _ in range(n_timed):
        t = time.perf_counter()
        img = r.render(comp, w, h, clear)
        times.append((time.perf_counter() - t) * 1e3)
    launches = dict(_build.LAUNCHES)
    diff = np.abs(img.astype(int) - ref.astype(int))
    say(label, path=path, frame_ms_median=f"{statistics.median(times):.2f}",
        frame_ms_min=f"{min(times):.2f}", frame_ms_max=f"{max(times):.2f}",
        frames=len(times), diag=r.last_diag.tolist(),
        max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
    say(label, path=path, max_diff_vs_ref=int(diff.max()),
        differing_pixels=int((diff > 0).any(axis=-1).sum()),
        painted_pixels=int((img[..., :3] != 255).any(axis=-1).sum()))
    if img.shape != (h, w, 4):
        raise AssertionError(f"{label}: frame shape {img.shape}")
    for name in PATHS[path]:
        if launches[name] < 1:
            raise AssertionError(f"{label}: kernel {name} was never launched on the {path} path")
    if diff.max() > 1:
        raise AssertionError(f"{label} ({path}): max channel diff {diff.max()} > 1")
    return launches


def paris_variant(device, label: str, counter: str) -> tuple:
    """Phases 6 and 8: a variant of paris-30k at 1920x1080 (`label` a key
    of PARIS_SCENES and of PATHS): K3's specialisation `counter` on the
    frame's own inputs against its plain version, then the frame through
    `Renderer.render` against the plain path on the card; returns (K3
    numbers, launches)."""
    from forma_tpu_torch import Color, Composition, Renderer
    from forma_tpu_torch.demos import scenes

    t = time.perf_counter()
    comp = Composition()
    getattr(scenes, PARIS_SCENES[label])(comp, PARIS_W, PARIS_H)
    say(label, scene_build_s=f"{time.perf_counter() - t:.1f}", layers=len(comp.layers))
    clear = Color(1.0, 1.0, 1.0, 1.0)
    r = Renderer(device)
    taps = {}
    t = time.perf_counter()
    r.render_device(comp, PARIS_W, PARIS_H, clear, taps=taps)
    torch.cuda.synchronize()
    say(label, first_frame_s=f"{time.perf_counter() - t:.2f}", caps=tuple(r._caps),
        regrows=r.regrow_count, features=str(taps["fold"][11]).replace(" ", ""))
    res = check_fold(counter, taps["fold"])
    del taps
    ref, _ = r.render_device(comp, PARIS_W, PARIS_H, clear, plain=True)
    ref = ref[:PARIS_H, :PARIS_W].cpu().numpy()
    launches = frame_path(label, label, r, comp, (PARIS_W, PARIS_H), ref)
    return res, launches


def mix_vs_cpu(device, label: str, build) -> tuple:
    """Phases 7 and 9: a mix at 512x512 (`build(comp)`) on the card: K3's
    clip specialisation on its inputs against its plain version, then the
    frame against the port's CPU render; returns (K3 clip numbers,
    launches)."""
    from forma_tpu_torch import Color, Composition, Renderer

    comp = Composition()
    build(comp)
    clear = Color(1.0, 1.0, 1.0, 1.0)
    r = Renderer(device)
    taps = {}
    r.render_device(comp, MIX_W, MIX_H, clear, taps=taps)
    say(label, layers=len(comp.layers), caps=tuple(r._caps),
        features=str(taps["fold"][11]).replace(" ", ""))
    res = check_fold("fold_clip", taps["fold"])
    del taps
    t = time.perf_counter()
    want = Renderer("cpu").render(comp, MIX_W, MIX_H, clear)
    say(label, cpu_render_s=f"{time.perf_counter() - t:.1f}")
    launches = frame_path(label, label, r, comp, (MIX_W, MIX_H), want)
    return res, launches


def texture_probe(device) -> tuple:
    """Phase 10: K5's three modes against the plain version at 8 blocks,
    then its entry point's measurement at the paris shape with the counters
    reset and read, each mode checked and timed there; returns (the
    atlas_rowsel numbers, launches)."""
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.probes import texture_fold as k5

    kmax = 44
    info, atlas = (t.to(device) for t in k5.probe_inputs(8))
    for mode in k5.MODES:
        got = k5.texture_fold(info, atlas, mode, kmax)
        torch.cuda.synchronize()
        err = max_abs_err((got,), (k5.texture_fold_torch(info, atlas, mode, kmax),))
        say("probe", mode=mode, nblk=8, kmax=kmax, max_abs_err=err)
        if err != 0.0:
            raise AssertionError(f"texture_probe {mode}: differs from its plain version ({err})")
    _build.reset_launches()
    res = k5.measure(255, kmax, device)
    launches = dict(_build.LAUNCHES)
    steps = res["tile_steps"]
    say("probe", nblk=255, kmax=kmax, tile_steps=steps, launches=launches["texture_probe"],
        **{f"{m}_ms": f"{res[m]:.4f}" for m in k5.MODES},
        **{f"{m}_marginal_ns_per_tile_step": f"{(res[m] - res['base']) / steps * 1e6:.3f}"
           for m in k5.MODES[1:]},
        window_gather_ms=f"{res['window_gather']:.4f}")
    if launches["texture_probe"] < 1:
        raise AssertionError("texture_probe was never launched by its entry point")
    info, atlas = (t.to(device) for t in k5.probe_inputs(255))
    out = {}
    for mode in k5.MODES:
        out[mode] = check_kernel("texture_probe", k5.texture_fold, k5.texture_fold_torch,
                                 (info, atlas, mode, kmax))
    return {"mode": "atlas_rowsel", **out["atlas_rowsel"]}, launches


def fold_timing(root: str, scene: str) -> int:
    """`--fold-timing DIR`: K3 on one frame's own inputs, with the port of
    the checkout in DIR."""
    sys.path.insert(0, os.path.abspath(root))
    import forma_tpu_torch
    from forma_tpu_torch import Color, Composition, Renderer
    from forma_tpu_torch.demos import scenes
    from forma_tpu_torch.ops import fold_kernel as fk

    comp = Composition()
    getattr(scenes, PARIS_SCENES[scene])(comp, PARIS_W, PARIS_H)
    taps = {}
    Renderer(torch.device("cuda", 0)).render_device(
        comp, PARIS_W, PARIS_H, Color(1.0, 1.0, 1.0, 1.0), taps=taps)
    args = taps["fold"]
    fn = lambda: fk.paint_fold(*args)  # noqa: E731
    say("fold-timing", port=os.path.dirname(forma_tpu_torch.__file__), scene=scene,
        card=repr(gpu_record()),
        ms=f"{time_ms(fn):.4f}", ms_sync=f"{time_ms_sync(fn):.4f}",
        host_us=f"{host_us(fn):.1f}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fold-timing", metavar="DIR",
                    help="time K3 alone with the port of the checkout in DIR")
    ap.add_argument("--scene", choices=sorted(PARIS_SCENES), default="paris",
                    help="the frame whose K3 inputs --fold-timing uses")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    if opts.fold_timing:
        return fold_timing(opts.fold_timing, opts.scene)
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
    launches = {
        path: frame_path("paris", path, rr, paris, (PARIS_W, PARIS_H), ref)
        for path, rr in renderers.items()
    }
    del renderers, paris, ref

    # 6. paris-30k-styled; 7. the styled mix
    kres["fold_styled"], launches["styled"] = paris_variant(device, "styled", "fold_styled")
    kres["fold_clip"], launches["mix"] = mix_vs_cpu(
        device, "mix", lambda comp: scenes.styled_mix(comp, 400, MIX_W, MIX_H))

    # 8. paris-30k-textured; 9. the textured mix; 10. K5
    kres["fold_tex"], launches["textured"] = paris_variant(device, "textured", "fold_tex")
    _, launches["texmix"] = mix_vs_cpu(
        device, "texmix", lambda comp: scenes.textured_mix(comp, 300, MIX_W, MIX_H))
    kres["texture_probe"], launches["probe"] = texture_probe(device)
    say("k5", question="marginal cost of sampling textures in the fold",
        fold_tex_minus_fold_ms=f"{kres['fold_tex']['ms'] - kres['fold']['ms']:.4f}",
        fold_tex_ms=f"{kres['fold_tex']['ms']:.4f}", fold_ms=f"{kres['fold']['ms']:.4f}")

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
