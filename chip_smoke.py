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
   operations of these inputs (at the card's rate for f32 operations
   that issue alone, since every kernel is built with --fmad=false; the
   bound at the data sheet's FMA rate is printed beside it), and the time
   of one PyTorch library call that computes most of the same function,
   where there is one; and K3's tile depths on the frame (max, median,
   p99, units folded, the virtual share) with a list-scheduling model's
   unit-steps for the card's block slots (8 and 12 per SM) taking the
   tiles in index order and deepest first (`fold_kernel.tile_order`);
   then K4 on edge lines built with numpy from a seed (vertical and
   horizontal lines, lines off the viewport's four sides and across its
   edges, zero-length and dead lines, padding vlines, a key of exactly
   31 bits) against its plain version (bit-equal required); and the
   frame's K4 words through the segment sort as int32 keys against the
   int64 path rebuilt from the same words (keys equal, each key's
   payloads equal as multisets), with both layouts' sorts timed;
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
   blended roads, radial-gradient parks): K4 and K3's styled
   specialisation on the frame's own inputs against their plain versions
   and K3's tile depths, as in phase 3; then
   the frame through `Renderer.render` as in phase 5 (counters, warm-up
   and 5 timed frames, peak memory) against the plain path on the card;
7. the styled mix (`scenes.styled_mix`: 400 layers at 512x512 with
   gradients, all 16 blend modes, clips and clipped draws, both fill
   rules): K4 and K3's clip specialisation on its inputs against their
   plain versions, then the frame through `Renderer.render` (counters read)
   against the port's CPU render (max channel diff <= 1);
8. paris-30k-textured at 1920x1080 (21,000 buildings filled from an atlas
   of 8 shared 32x32 images, roads and parks solid): K4 and K3's textured
   specialisation on the frame's own inputs against their plain versions,
   as in phase 3; then the frame as in phase 6;
9. the textured mix (`scenes.textured_mix`: 300 layers at 512x512, most
   of them textured through rotated transforms, with gradients, blend
   modes, clips and clipped textured draws): K4 and K3's clip
   specialisation with textures against their plain versions, then the
   frame against the port's CPU render, as in phase 7;
10. K5, the texture-fold probe (`forma_tpu_torch.probes.texture_fold`):
   its three modes against the plain version (bit-equal) at 8 blocks of
   32 tiles and 44 steps; then its entry point's measurement at the
   probe's paris shape (255 blocks), counters reset and read, each mode
   checked and timed there as in phase 3, and the probe's window gather;
11. K8, the fold ablation (`forma_tpu_torch.probes.fold_ablate`) on the
   TPU tool's paris-like inputs (seed 0: 465,747 units over 8,160 tiles),
   built once: its six variants against the plain version (bit-equal) on
   the first 8 blocks, `full` checked and timed at the full shape as in
   phase 3, then its entry point's measurement (counters reset and read)
   and each piece's cost beside K3 `fold` from phase 3;
12. K6 and K7 (`probes.microbench`) at the TPU tool's sizes: K6's grouping
   prep timed alone, each kernel against its plain version as in phase 3,
   then the entry point's measurement with the counters reset and read;
13. K9 (`probes.grid_scatter`), 2^20 segments in its two input modes, each
   against the plain version as in phase 3 with its rate in M segments/s
   beside K2's on the phase 3 frame, then the entry point's measurement
   with the counters reset and read.
   Phases 11-13 also time each kernel as 20 calls captured in one CUDA
   graph (`ms_graph`, and the library call's where it allows a graph):
   the device time alone, where `ms` of a ~20 us kernel reads its
   wrapper's host rate; the entry points report that device time.

The last three lines are a JSON object with per-kernel results (K3 once
per specialisation: solid, styled, textured, clip; K5 in its atlas_rowsel
mode; K8 `full`; K9 `independent`), the card's name and power limit, and
the status line `{"ok": true, "device": {...}}`.

    python3 chip_smoke.py --fold-timing DIR [DIR ...] [--scene paris|styled|textured|mix]

times K3 alone instead, on one paris-30k (or paris-30k-styled,
paris-30k-textured, or styled-mix) frame's own inputs as this checkout's port records
them, through the port of the checkout in each DIR in turn (for example a
parent commit unpacked with `git archive`; give them as parent, change,
change, parent), in both ways above and with the wrapper's host
microseconds, each output held bit-equal to this checkout's plain
version; `tile_order` is timed alone first.

    python3 chip_smoke.py --raster-timing DIR [DIR ...] [--scene ...]

does the same for K4: on one frame's own K4 inputs, through each DIR's
port, batched, synchronised and CUDA-graph ms and the wrapper's host
microseconds, each output held bit-equal to this checkout's plain version
once widened to u32 values (a port may store int64 values or int32
words), each DIR's whole `rasterize_sort` stage timed, and K4's ptxas
lines from each DIR's build; first the frame's keys through the segment
sort in both layouts (int32 and int64), held equal and timed alone.
"""

from __future__ import annotations

import argparse
import heapq
import importlib
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
    ("fold_ablate", "forma_tpu_torch/csrc/fold_ablate.cu",
     "tools/fold_kernel_ablate.py:153", "ablate"),
    ("unit_stream", "forma_tpu_torch/csrc/microbench.cu",
     "tools/tpu_microbench2.py:154", "micro"),
    ("seg_loop", "forma_tpu_torch/csrc/microbench.cu",
     "tools/tpu_microbench2.py:184", "micro"),
    ("grid_scatter", "forma_tpu_torch/csrc/grid_scatter.cu",
     "tools/pallas_scatter_probe.py:66", "scatter"),
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
# f32 operations per second when each add or multiply issues alone: 128
# f32 lanes x 132 SMs x 1.98 GHz.  Every kernel here is built with
# --fmad=false, so this is the rate the bounds use; the data sheet's 67
# TFLOP/s counts a fused multiply-add as two and is printed beside it.
F32_OPS_PER_S = 128 * 132 * 1.98e9
F32_FMA_FLOPS_PER_S = 67e12
# Block slots per SM in the list-scheduling model of K3's tile order: 8
# (blocks of 256 threads, one pixel each, as K3 ran before its tiles were
# ordered) and 12 (`fold.cu` now: 128 threads, at most 40 registers).
K3_BLOCKS_PER_SM = (8, 12)
# f32 operations per unit of work, counted from the kernel sources:
# csrc/rasterize.cu 76 per float-float `find` that depend on the crossing
# (88 less the 12 that depend only on the line: the splits of a_over.hi
# and b_over.hi, their two products with the low word 0 and two isfinite
# tests), one find for each pixel segment in range and one more for each
# live line (n segments share n + 1 crossings), 12 per live line, and 22
# per segment in range (2 clamps, 4 endpoints of 5 ops): 198 per segment
# while every segment ran two whole finds, the count printed beside;
# csrc/fold.cu per unit and
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
# for the parameters.  csrc/fold_ablate.cu per unit-pixel: K3's 29 with the
# Over blend, coverage 7 and 1 add without it.  csrc/microbench.cu K6 per
# unit-pixel: 3 (1 - c, the multiply, + c); K7 and K9 do no float
# arithmetic.
K4_F32_OPS_PER_FIND, K4_F32_OPS_PER_LINE, K4_F32_OPS_PER_SEGMENT = 76, 12, 22
K4_F32_OPS_PER_SEGMENT_TWO_FINDS = 198
K3_F32_OPS_PER_UNIT_PIXEL = 29
K3_GRAD_OPS, K3_STOP_OPS, K3_SEGMENT_OPS, K3_CLIP_OPS = 16, 1, 25, 2
K3_TEX_OPS = 18
K3_BLEND_OPS = (0, 3, 9, 21, 3, 3, 12, 15, 21, 51, 6, 12, 84, 84, 59, 59)
K5_COORD_OPS, K5_BASE_OPS, K5_SAMPLE_OPS, K5_ACC_OPS, K5_PRM_OPS = 9, 2, 6, 4, 6
K8_NO_BLEND_OPS = 8
K6_F32_OPS_PER_UNIT_PIXEL = 3
K8_LANES = 277  # u_mat lanes a K8 step reads: grid 256, carries 16, fill 4, rule 1
# The segment words' layouts (`forma_tpu_torch/ops/_u32.py`,
# `rasterize_kernel.py`, `rasterize.py`), restated so that `--raster-timing`
# reads any tree's output: the u32 sentinel and mask of the int64 values,
# K4's int32 key sentinel, and tx's bits in the canonical key_hi.
U32_SENTINEL = MASK32 = 0xFFFFFFFF
PACKED_SENTINEL = 0x7FFFFFFF
KEY_HI_TX_BITS = 13

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


def ablate_bytes(args, out) -> int:
    """Bytes K8 must move: the 277 lanes of each row the fold addresses
    (not the 384-lane padding, not the window's spare rows), blkinfo,
    clear, the output."""
    from forma_tpu_torch.probes import fold_ablate as k8

    blkinfo, clear = args[1:3]
    rows = k8.addressed_rows(blkinfo)
    return 4 * rows * K8_LANES + tensor_bytes((blkinfo, clear)) + tensor_bytes(out)


def kernel_bytes(name: str, args, out) -> int:
    """Bytes the kernel must move on these inputs: each input read once and
    each output written once, at the TPU function's widths."""
    if name == "fold_ablate":
        return ablate_bytes(args, out)
    if name.startswith("fold"):
        return fold_bytes(args, out)
    if name == "texture_probe":
        return probe_bytes(args, out)
    return tensor_bytes(args) + tensor_bytes(out)


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


def k4_work(args) -> tuple:
    """(pixel segments in range, live vlines, live lines) of K4's inputs:
    every live line's length, its ceil(length / k_seg) vlines, up to
    v_total, and the lines of non-zero length."""
    params, vline_ends, v_total, v_cap, k_seg = args[:5]
    assert int(v_total) == int(vline_ends[-1]) <= v_cap
    lengths = params[:, 15].double()
    return (int(lengths.sum()), int(torch.ceil(lengths / k_seg).sum()),
            int((lengths > 0).sum()))


def f32_ops(name: str, args) -> int:
    """f32 operations the kernel does on these inputs (data-dependent)."""
    if name == "rasterize":
        segs, _, lines = k4_work(args)
        return (K4_F32_OPS_PER_SEGMENT * segs + K4_F32_OPS_PER_FIND * (segs + lines)
                + K4_F32_OPS_PER_LINE * lines)
    if name == "fold_ablate":
        from forma_tpu_torch.probes import fold_ablate as k8

        blend = k8.VARIANTS[args[3]][3]
        per = K3_F32_OPS_PER_UNIT_PIXEL if blend else K8_NO_BLEND_OPS
        return 256 * per * k8.addressed_rows(args[1])
    if name.startswith("fold"):
        return 256 * int(fold_unit_ops(args).sum())
    if name == "texture_probe":
        info, _, mode, kmax = args
        texel = K5_BASE_OPS if mode == "base" else K5_SAMPLE_OPS
        per_step = K5_COORD_OPS + texel + K5_ACC_OPS
        return 256 * info.shape[0] * (kmax * per_step + K5_PRM_OPS)
    if name == "unit_stream":
        return 256 * K6_F32_OPS_PER_UNIT_PIXEL * args[0].numel()
    return 0


def library_call(name: str, args):
    """(description, fn, capturable) of one PyTorch call computing most of
    the kernel's function on the same inputs, or None; `capturable` says
    whether it runs inside a CUDA graph (it does not synchronise with the
    host).  Timed only: the port never calls these."""
    if name == "expand":
        params, vline_ends, _ = args
        n_v = torch.diff(vline_ends, prepend=vline_ends.new_zeros(1))
        total = int(vline_ends[-1])
        return ("torch.repeat_interleave(params, n_v, dim=0): the row gather "
                "without j, the [16, V] layout or padding",
                lambda: torch.repeat_interleave(params, n_v, dim=0, output_size=total), True)
    if name == "grid":
        rid, cell, area, cover, _, _, run_cap = args
        idx = rid.long() * 256 + cell.long()
        val = (area * 65536 + cover).to(torch.int32)
        flat = torch.zeros(run_cap * 256, dtype=torch.int32, device=rid.device)
        return ("Tensor.index_add_ of the packed area|cover grid: without "
                "rowcov or run keys", lambda: flat.index_add_(0, idx, val), True)
    if name == "seg_loop":
        (segs,) = args
        # bincount reads the input's maximum back to the host: no graph.
        return ("torch.bincount(segs, minlength=256): int64 counts, not the "
                "f32 [2, 128]", lambda: torch.bincount(segs, minlength=256), False)
    if name == "grid_scatter":
        row, cell, val = args
        idx = row.long() * 256 + cell.long()
        flat = torch.zeros(256 * 256, dtype=torch.int32, device=row.device)
        return ("Tensor.index_add_ of the flattened [256, 256] window",
                lambda: flat.index_add_(0, idx, val), True)
    return None


def check_kernel(name: str, kern, plain, args, graph: bool = False, **label) -> dict:
    """A kernel against its plain version on a frame's own inputs (bit-equal
    required); returns the kernels line's numbers for it.  `graph` adds
    the device time per call from CUDA graph replays (`ms_graph`, and
    `library_ms_graph` where the library call allows a graph).  `label` is
    printed with the numbers."""
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
    nbytes = kernel_bytes(name, args, got)
    ops = f32_ops(name, args)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    fma_rate_ms = ops / F32_FMA_FLOPS_PER_S * 1e3
    lib = library_call(name, args)
    library_ms = time_ms(lib[1]) if lib else None
    if name == "rasterize":
        before_ms = K4_F32_OPS_PER_SEGMENT_TWO_FINDS * k4_work(args)[0] / F32_OPS_PER_S * 1e3
        label["bound_ms_at_two_finds_per_segment"] = f"{max(bytes_ms, before_ms):.4f}"
    graphs = {}
    if graph:
        from forma_tpu_torch.probes import time_ms_graph

        graphs["ms_graph"] = time_ms_graph(lambda: kern(*args))
        if lib and lib[2]:
            graphs["library_ms_graph"] = time_ms_graph(lib[1])
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    mode = {"mode": args[2]} if name == "texture_probe" else {}
    say("kernel", name=name, **mode, **label, max_abs_err=err, ms=f"{ms:.4f}", ms_sync=f"{ms_sync:.4f}",
        host_us=f"{wrapper_us:.1f}", plain_ms=f"{plain_ms:.4f}", bytes=nbytes,
        table_bytes=table_bytes, port_layout_bytes=port_bytes, f32_ops=ops,
        bound_ms=f"{max(bytes_ms, ops_ms):.4f}", bytes_ms=f"{bytes_ms:.4f}",
        ops_ms=f"{ops_ms:.4f}", bound_ms_at_fma_rate=f"{max(bytes_ms, fma_rate_ms):.4f}",
        library_ms="none" if library_ms is None else f"{library_ms:.4f}",
        **{k: f"{v:.4f}" for k, v in graphs.items()},
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
        **graphs,
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


def list_schedule_steps(cnt, order, slots: int) -> int:
    """Unit-steps until the last tile ends when `slots` block slots take
    the tiles in `order`, each as soon as a slot frees, one step per unit
    (the model of the card's block scheduler behind `fold_depths`)."""
    heap = [0] * slots
    for depth in cnt[order].tolist():
        heapq.heapreplace(heap, heap[0] + depth)
    return max(heap)


def fold_depths(label: str, args) -> None:
    """K3's tile depths on a frame's own inputs, and the list-scheduling
    model's unit-steps for the card's block slots in index order and
    deepest first (`tile_order`), beside the ideal (units over slots)."""
    from forma_tpu_torch.ops import fold_kernel as fk

    cnt = args[1]
    n_units, _, virt = fold_units(args)
    order = fk.tile_order(cnt).long().cpu()
    c = cnt.long().cpu()
    p50, p99 = np.percentile(c.numpy(), [50, 99])
    model = {}
    for per_sm in K3_BLOCKS_PER_SM:
        slots = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
        model[f"slots_{slots}_steps_index_order"] = list_schedule_steps(
            c, torch.arange(c.numel()), slots)
        model[f"slots_{slots}_steps_deepest_first"] = list_schedule_steps(c, order, slots)
        model[f"slots_{slots}_steps_ideal"] = f"{n_units / slots:.1f}"
    say(label, k3_tiles=c.numel(), k3_units=n_units, depth_max=int(c.max()),
        depth_p50=f"{p50:g}", depth_p99=f"{p99:g}",
        virtual_share=f"{float(virt.double().mean()):.4f}", **model)


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


def check_k4(label: str, args) -> tuple:
    """K4 against its plain version on `args` (a frame's own inputs, or the
    edge lines), bit-equal required, untimed (phase 3 times it on
    paris-30k); returns K4's output."""
    from forma_tpu_torch.ops import rasterize_kernel as rk

    got = rk.rasterize_blocks(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, rk.rasterize_blocks_torch(*args))
    say(label, kernel="rasterize", segments=k4_work(args)[0], max_abs_err=err)
    if err != 0.0:
        raise AssertionError(f"{label}: K4 differs from its plain version ({err})")
    return got


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
    fold_depths(label, taps["fold"])
    check_k4(label, taps["rasterize"])
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
    check_k4(label, taps["rasterize"])
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


def fold_ablation(device, k3: dict) -> tuple:
    """Phase 11: K8's six variants against the plain version on the first 8
    blocks of the TPU tool's inputs, `full` checked and timed at the full
    shape, then its entry point's measurement with the counters reset and
    read; each piece's cost beside K3 `fold` (`k3`, phase 3); returns
    (the `full` numbers, launches)."""
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.probes import fold_ablate as k8

    t = time.perf_counter()
    u_mat, blkinfo = k8.paris_inputs()
    say("ablate", inputs_build_s=f"{time.perf_counter() - t:.1f}", tiles=blkinfo.shape[0] * k8.TB,
        units=k8.addressed_rows(blkinfo), u_mat_rows=u_mat.shape[0])
    u_mat, blkinfo = u_mat.to(device), blkinfo.to(device)
    clear = torch.ones(4, dtype=torch.float32, device=device)
    cut = blkinfo[:8].contiguous()
    for variant in k8.VARIANTS:
        got = k8.fold_ablate(u_mat, cut, clear, variant)
        torch.cuda.synchronize()
        err = max_abs_err((got,), (k8.fold_ablate_torch(u_mat, cut, clear, variant),))
        say("ablate", variant=variant, nblk=8, units=k8.addressed_rows(cut), max_abs_err=err)
        if err != 0.0:
            raise AssertionError(f"fold_ablate {variant}: differs from its plain version ({err})")
    res = check_kernel("fold_ablate", k8.fold_ablate, k8.fold_ablate_torch,
                       (u_mat, blkinfo, clear, "full"), graph=True, variant="full")
    _build.reset_launches()
    m = k8.measure((u_mat, blkinfo), device)
    launches = dict(_build.LAUNCHES)
    say("ablate", tiles=m["tiles"], units=m["units"], launches=launches["fold_ablate"],
        **{f"{v}_ms": f"{m[v]:.4f}" for v in k8.VARIANTS})
    say("k8", question="what each piece of a fold step costs, against K3 fold",
        **{f"piece_{p}_ms": f"{ms:.4f}" for p, ms in k8.pieces(m).items()},
        k3_fold_ms=f"{k3['ms']:.4f}", k3_fold_bound_ms=f"{k3['bound_ms']:.4f}",
        full_bound_ms=f"{res['bound_ms']:.4f}")
    if launches["fold_ablate"] < 1:
        raise AssertionError("fold_ablate was never launched by its entry point")
    return res, launches


def microbenchmarks(device) -> tuple:
    """Phase 12: K6 (its grouping prep timed alone) and K7 against their
    plain versions at the TPU tool's sizes, then the entry point's
    measurement with the counters reset and read; returns ({name:
    numbers}, launches)."""
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.probes import microbench as mb

    tile_of, cov = (x.to(device) for x in mb.unit_inputs())
    perm, start = mb.group_units(tile_of, mb.T)
    say("micro", kernel="unit_stream", units=mb.U, tiles=mb.T,
        grouping_prep_ms=f"{time_ms(lambda: mb.group_units(tile_of, mb.T)):.4f}",
        prep="torch.sort(tile_of, stable=True) + searchsorted")
    out = {"unit_stream": check_kernel("unit_stream", mb.unit_stream_grouped,
                                       mb.unit_stream_grouped_torch, (perm, start, cov),
                                       graph=True)}
    del tile_of, cov, perm, start
    segs = mb.seg_inputs().to(device)
    out["seg_loop"] = check_kernel("seg_loop", mb.seg_loop, mb.seg_loop_torch, (segs,),
                                   graph=True)
    del segs
    _build.reset_launches()
    m = mb.measure(device)
    launches = dict(_build.LAUNCHES)
    say("micro", launches={k: launches[k] for k in ("unit_stream", "seg_loop")},
        **{f"{k}_ms": f"{v:.4f}" for k, v in m.items()},
        unit_stream_M_units_per_s=f"{mb.U / m['unit_stream'] / 1e3:.1f}",
        seg_loop_M_segments_per_s=f"{mb.S / m['seg_loop'] / 1e3:.1f}")
    for name in ("unit_stream", "seg_loop"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was never launched by its entry point")
    return out, launches


def scatter_probe(device, k2_slots: int, k2_live: int, k2: dict) -> tuple:
    """Phase 13: K9 in both input modes against the plain version, each
    with its rate beside K2's on the phase 3 frame (`k2_slots` segment
    slots, `k2_live` of them live, K2's numbers `k2`), then the entry
    point's measurement with the counters reset and read; returns (the
    `independent` numbers, launches)."""
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.probes import grid_scatter as k9

    out = {}
    for mode in k9.MODES:
        args = tuple(t.to(device) for t in k9.scatter_inputs(mode))
        out[mode] = check_kernel("grid_scatter", k9.grid_scatter, k9.grid_scatter_torch, args,
                                 graph=True, mode=mode)
        say("scatter", mode=mode, segments=args[0].numel(),
            M_segments_per_s=f"{args[0].numel() / out[mode]['ms'] / 1e3:.1f}",
            library_M_segments_per_s=f"{args[0].numel() / out[mode]['library_ms'] / 1e3:.1f}",
            graph_M_segments_per_s=f"{args[0].numel() / out[mode]['ms_graph'] / 1e3:.1f}",
            library_graph_M_segments_per_s=(
                f"{args[0].numel() / out[mode]['library_ms_graph'] / 1e3:.1f}"))
    say("scatter", k2_grid_ms=f"{k2['ms']:.4f}", k2_segment_slots=k2_slots,
        k2_live_segments=k2_live,
        k2_M_slots_per_s=f"{k2_slots / k2['ms'] / 1e3:.1f}",
        k2_M_live_segments_per_s=f"{k2_live / k2['ms'] / 1e3:.1f}")
    _build.reset_launches()
    m = k9.measure(device)
    launches = dict(_build.LAUNCHES)
    say("scatter", launches=launches["grid_scatter"],
        **{f"{mode}_ms": f"{m[mode]:.4f}" for mode in k9.MODES})
    if launches["grid_scatter"] < 1:
        raise AssertionError("grid_scatter was never launched by its entry point")
    return {"mode": "independent", **out["independent"]}, launches


def u32_values(packed, payload) -> tuple:
    """K4's output as int64 u32 values, whichever layout a port stores:
    int32 words (the key sentinel 0x7FFFFFFF mapped to 0xFFFFFFFF, the
    payload's 32 bits) or int64 values, as they are."""
    if packed.dtype == torch.int64:
        return packed, payload
    key = packed.long()
    return torch.where(key == PACKED_SENTINEL, U32_SENTINEL, key), payload.long() & MASK32


def int64_stream(packed, payload, slot_bits: int, tx_bits: int) -> tuple:
    """The int64 path K4's words took before they stayed 32-bit: widened to
    u32 values with the 0xFFFFFFFF sentinel, one unstable sort of the int64
    keys, the payload gathered along, the keys unpacked into (key_hi,
    key_lo) as `rasterize.unpack_packed_keys` did on int64 keys."""
    key, pay = u32_values(packed, payload)
    key, order = torch.sort(key, stable=False)
    pay = pay[order]
    invalid = key == U32_SENTINEL
    txb = key & ((1 << tx_bits) - 1)
    rowb = key >> (slot_bits + tx_bits)
    key_hi = torch.where(invalid, U32_SENTINEL, (rowb << KEY_HI_TX_BITS) | txb)
    key_lo = torch.where(invalid, 0, (key >> tx_bits) & ((1 << slot_bits) - 1))
    return key_hi, key_lo, pay


def same_stream(got, want) -> bool:
    """Two sorted segment streams: keys equal element by element, and the
    payloads of each key equal as multisets (the sort is unstable)."""
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        return False
    kh, kl = got[0], got[1]
    new = torch.ones_like(kh, dtype=torch.bool)
    new[1:] = (kh[1:] != kh[:-1]) | (kl[1:] != kl[:-1])
    group = torch.cumsum(new, 0) << 32
    return torch.equal(torch.sort(group | got[2]).values, torch.sort(group | want[2]).values)


def sort_layouts(label: str, args, timed: bool = False) -> None:
    """K4's words on one frame's inputs (`args`) through the segment sort in
    both layouts: `rasterize.sort_segments` (int32 keys, the int32 payload
    gathered, then widened) against the int64 path rebuilt from the same
    words (`int64_stream`), held equal (`same_stream`); `timed` also times
    each layout's `torch.sort` alone, its sort with the payload gather,
    and the whole sort-and-unpack (batched and CUDA-graph device ms)."""
    from forma_tpu_torch.ops import rasterize_kernel as rk
    from forma_tpu_torch.ops.rasterize import sort_segments
    from forma_tpu_torch.probes import time_ms_graph

    slot_bits, tx_bits = args[8], args[9]
    packed, payload = (t.reshape(-1) for t in rk.rasterize_blocks(*args))
    got = sort_segments(packed, payload, slot_bits, tx_bits)
    want = int64_stream(packed, payload, slot_bits, tx_bits)
    ok = same_stream(got, want)
    say(label, check="sorted stream: int32 words against the int64 path", keys=packed.numel(),
        valid=int((packed != PACKED_SENTINEL).sum()), equal=ok)
    if not ok:
        raise AssertionError(f"{label}: the int32 sort's stream differs from the int64 path's")
    if not timed:
        return
    key64, pay64 = u32_values(packed, payload)
    fns = {
        "i32_sort": lambda: torch.sort(packed, stable=False),
        "i64_sort": lambda: torch.sort(key64, stable=False),
        "i32_sort_gather": lambda: payload[torch.sort(packed, stable=False)[1]],
        "i64_sort_gather": lambda: pay64[torch.sort(key64, stable=False)[1]],
        "i32_sort_unpack": lambda: sort_segments(packed, payload, slot_bits, tx_bits),
        "i64_sort_unpack": lambda: int64_stream(packed, payload, slot_bits, tx_bits),
    }
    times = {f"{k}_ms": time_ms(fn) for k, fn in fns.items()}
    times.update({f"{k}_ms_graph": time_ms_graph(fn) for k, fn in fns.items()})
    say(label, **{k: f"{v:.4f}" for k, v in times.items()})


# The K4 edge phase's frame: 1920x1080, tile rows [5, 65) of 68 (row_lo >
# 0, lines above and below), 120 tiles across; [row | slot | tx] takes
# exactly 31 bits: 6 + 18 + 7.
EDGE_W, EDGE_H, EDGE_ROW_LO, EDGE_ROWS, EDGE_TILES_X, EDGE_SLOT_BITS = 1920, 1080, 5, 60, 120, 18


def k4_edge_inputs(seed: int = 4) -> tuple:
    """K4's inputs (CPU tensors) for lines built with numpy from `seed`
    through the port's `line_setup`: vertical and horizontal lines (a or b
    non-finite), lines left and right of the viewport and across its
    edges, lines in the rows above row_lo and below row_lo + rows,
    zero-length lines, dead lines (alone, and a run of 300), one-vline
    lines between dead ones (a warp's vlines then span more lines than its
    window), long lines, layer slots up to 2^18 - 1 and segments in the
    last tile row and column; 1,000 padding vlines past v_total."""
    from forma_tpu_torch.ops import line_setup as ls

    rng = np.random.default_rng(seed)
    w, h = float(EDGE_W), float(EDGE_H)
    y_lo, y_hi = EDGE_ROW_LO * 16.0, (EDGE_ROW_LO + EDGE_ROWS) * 16.0

    def pts(n, x0, x1, y0, y1):
        return np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], 1)

    segs = []  # (start, end) pairs, each drawn; the lines between them are dead
    a = pts(300, -50, w + 50, -50, h + 50)
    segs.append((a, a + np.stack([np.zeros(300), rng.uniform(-90, 90, 300)], 1)))  # vertical
    a = pts(300, -50, w + 50, -50, h + 50)
    segs.append((a, a + np.stack([rng.uniform(-90, 90, 300), np.zeros(300)], 1)))  # horizontal
    segs.append((pts(200, -400, -1, 0, h), pts(200, -400, -1, 0, h)))  # left of the viewport
    segs.append((pts(200, -300, -1, 0, h), pts(200, 1, w, 0, h)))  # into it from the left
    segs.append((pts(200, w + 1, w + 400, 0, h), pts(200, w + 1, w + 400, 0, h)))  # right
    segs.append((pts(200, 0, w, 0, y_lo), pts(200, 0, w, 0, y_lo)))  # above row_lo
    segs.append((pts(200, 0, w, y_hi, h), pts(200, 0, w, y_hi, h)))  # below the rows
    a = pts(100, 0, w, 0, h)
    segs.append((a, a.copy()))  # zero length
    segs.append((pts(100, w - 16, w - 1, y_hi - 16, y_hi - 1),
                 pts(100, w - 16, w - 1, y_hi - 16, y_hi - 1)))  # the last tile
    segs.append((pts(60, -100, w + 100, -100, h + 100), pts(60, -100, w + 100, -100, h + 100)))
    order = rng.permutation(sum(s.shape[0] for s, _ in segs))
    a = pts(400, 0, w, 0, h)  # short, one vline each, kept together
    start = np.concatenate([np.concatenate([s for s, _ in segs])[order], a])
    end = np.concatenate([np.concatenate([e for _, e in segs])[order],
                          a + rng.uniform(-3, 3, (400, 2))])
    n = start.shape[0]
    p = np.empty((2 * n, 2))
    p[0::2], p[1::2] = start, end
    g_slot = np.asarray([(1 << EDGE_SLOT_BITS) - 1, 0, 1 << 17, 4321], np.int32)
    line_slot = np.full(2 * n - 1, -1, np.int32)  # the lines between drawn ones
    line_slot[0::2] = rng.integers(0, 4, n)
    line_slot[0::2][rng.random(n) < 0.05] = -1  # dead lines alone
    line_slot[1000:1600] = -1  # a run of 300 dead lines
    g = (g_slot, np.ones(4, bool), np.tile(np.asarray([1, 0, 0, 1, 0, 0], np.float32), (4, 1)),
         np.zeros(4, bool))
    px, py = p[:, 0].astype(np.float32), p[:, 1].astype(np.float32)
    params, _, _, ends = ls.line_setup(
        *map(torch.from_numpy, (px, py, line_slot, *g)), EDGE_W, EDGE_H, k_seg=8)
    tx_bits = (EDGE_TILES_X + 1).bit_length()
    assert (EDGE_ROWS + 1).bit_length() + EDGE_SLOT_BITS + tx_bits == 31
    v_total = int(ends[-1])
    return (params, ends, torch.tensor(v_total), v_total + 1000, 8, EDGE_ROWS, EDGE_TILES_X,
            EDGE_ROW_LO, EDGE_SLOT_BITS, tx_bits)


def k4_edges(device) -> None:
    """Phase 3: K4 on the edge lines (`k4_edge_inputs`) on the card against
    its plain version on the card (`check_k4`), with what the lines reach:
    warps whose vlines pass the search's window, the clamped tile -1, the
    last tile column, keys in the top bit, the sentinel."""
    from forma_tpu_torch.ops import rasterize_kernel as rk

    assert rk.PACKED_SENTINEL == PACKED_SENTINEL
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in k4_edge_inputs())
    key = check_k4("k4-edges", args)[0].long()
    valid = key != PACKED_SENTINEL
    tx_field = key & ((1 << args[9]) - 1)
    # Warps whose 32 vlines span more lines than `warp_owning_line`'s
    # window (csrc/vlines.cuh), where lanes finish with a search of their own.
    li = torch.searchsorted(args[1], torch.arange(args[3], device=device), right=True)
    n = li.numel() // 32 * 32
    say("k4-edges", lines=args[0].shape[0], vlines=k4_work(args)[1], v_cap=args[3],
        warps_past_window=int((li[31:n:32] - li[0:n:32] >= 31).sum()),
        valid_keys=int(valid.sum()), sentinels=int((~valid).sum()),
        left_of_viewport=int((valid & (tx_field == 0)).sum()),
        last_tile_column=int((valid & (tx_field == args[6])).sum()),
        max_key=hex(int(key[valid].max())), min_key=int(key[valid].min()),
        key_bits=(args[5] + 1).bit_length() + args[8] + args[9])
    if not (int(key[valid].min()) >= 0 and (1 << 30) <= int(key[valid].max()) < PACKED_SENTINEL):
        raise AssertionError("K4 edge lines: valid keys outside [0, 2^31 - 1) or short of bit 30")


def frame_taps(scene: str) -> dict:
    """Every kernel's inputs on one frame (paris-30k or a variant at
    1920x1080, or the styled mix), recorded by this checkout's port on the
    card."""
    from forma_tpu_torch import Color, Composition, Renderer
    from forma_tpu_torch.demos import scenes

    comp = Composition()
    if scene == "mix":
        w, h = MIX_W, MIX_H
        scenes.styled_mix(comp, 400, w, h)
    else:
        w, h = PARIS_W, PARIS_H
        getattr(scenes, PARIS_SCENES[scene])(comp, w, h)
    taps = {}
    Renderer(torch.device("cuda", 0)).render_device(
        comp, w, h, Color(1.0, 1.0, 1.0, 1.0), taps=taps)
    return taps


def import_port(root: str, *modules: str) -> tuple:
    """A fresh import of the port from the checkout at `root`: its modules
    `forma_tpu_torch.<name>` for each name in `modules`."""
    for name in [m for m in sys.modules if m.split(".")[0] == "forma_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        return tuple(importlib.import_module(f"forma_tpu_torch.{m}") for m in modules)
    finally:
        sys.path.remove(root)


def raster_timing(roots, scene: str) -> int:
    """`--raster-timing DIR [DIR ...]`: K4 on one frame's own inputs,
    recorded by this checkout's port, through the port of the checkout in
    each DIR in turn, each output held bit-equal (as u32 values) to this
    checkout's plain version; the segment sort in both layouts first
    (`sort_layouts`), and each DIR's whole `rasterize_sort` stage."""
    from forma_tpu_torch.ops import rasterize_kernel as rk
    from forma_tpu_torch.probes import time_ms_graph

    taps = frame_taps(scene)
    args, stage_args = taps["rasterize"], taps["rasterize_sort"]
    want = u32_values(*rk.rasterize_blocks_torch(*args))
    segs, vlines, lines = k4_work(args)
    say("raster-timing", scene=scene, card=repr(gpu_record()), segments=segs, vlines=vlines,
        lines=lines, v_cap=args[3])
    sort_layouts("raster-timing", args, timed=True)
    ports = {}
    for root in map(os.path.abspath, roots):
        if root not in ports:
            ports[root] = import_port(root, "ops.rasterize_kernel", "ops.rasterize", "ops._build")
        kern, stage, build = ports[root]
        fn = lambda: kern.rasterize_blocks(*args)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        err = max_abs_err(u32_values(*got), want)
        whole = lambda: stage.rasterize_sort(*stage_args)  # noqa: E731
        say("raster-timing", port=root, scene=scene, words=str(got[0].dtype), max_abs_err=err,
            ms=f"{time_ms(fn):.4f}", ms_sync=f"{time_ms_sync(fn):.4f}",
            ms_graph=f"{time_ms_graph(fn):.4f}", host_us=f"{host_us(fn):.1f}",
            rasterize_sort_ms=f"{time_ms(whole):.4f}",
            rasterize_sort_ms_graph=f"{time_ms_graph(whole):.4f}")
        log = (build.library_path().parent / "nvcc.log").read_text().splitlines()
        for i, line in enumerate(log):
            if "Compiling entry" in line and "rasterize_kernel" in line:
                for info in log[i + 1:i + 4]:
                    say("raster-timing", port=root, ptxas=info.strip())
        if err != 0.0:
            raise AssertionError(f"{root}: K4 differs from the plain version ({err})")
    return 0


def fold_timing(roots, scene: str) -> int:
    """`--fold-timing DIR [DIR ...]`: K3 on one frame's own inputs, recorded
    by this checkout's port, through the port of the checkout in each DIR
    in turn, each output held bit-equal to this checkout's plain version."""
    from forma_tpu_torch.ops import fold_kernel as fk
    from forma_tpu_torch.probes import time_ms_graph

    args = frame_taps(scene)["fold"]
    want = fk.paint_fold_torch(*args)
    order = lambda: fk.tile_order(args[1])  # noqa: E731
    say("fold-timing", scene=scene, card=repr(gpu_record()),
        tile_order_ms=f"{time_ms(order):.4f}",
        tile_order_ms_graph=f"{time_ms_graph(order):.4f}")
    ports = {}
    for root in map(os.path.abspath, roots):
        if root not in ports:
            (ports[root],) = import_port(root, "ops.fold_kernel")
        fold = ports[root].paint_fold
        fn = lambda: fold(*args)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        err = max_abs_err((got,), (want,))
        say("fold-timing", port=root, scene=scene, max_abs_err=err,
            ms=f"{time_ms(fn):.4f}", ms_sync=f"{time_ms_sync(fn):.4f}",
            ms_graph=f"{time_ms_graph(fn):.4f}", host_us=f"{host_us(fn):.1f}")
        if err != 0.0:
            raise AssertionError(f"{root}: K3 differs from the plain version ({err})")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fold-timing", metavar="DIR", nargs="+",
                    help="time K3 alone with the port of the checkout in each DIR")
    ap.add_argument("--raster-timing", metavar="DIR", nargs="+",
                    help="time K4 and the segment sort alone with the port of the "
                         "checkout in each DIR")
    ap.add_argument("--scene", choices=sorted(PARIS_SCENES) + ["mix"], default="paris",
                    help="the frame whose inputs --fold-timing or --raster-timing uses")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if opts.fold_timing:
        return fold_timing(opts.fold_timing, opts.scene)
    if opts.raster_timing:
        return raster_timing(opts.raster_timing, opts.scene)
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
    fold_depths("paris", taps["fused"]["fold"])
    kres = check_kernels({**taps["fused"], "expand": taps["split"]["expand"]})
    k4_edges(device)
    sort_layouts("paris", taps["fused"]["rasterize"])
    rid, _, area, cover = taps["fused"]["grid"][:4]
    k2_slots, k2_live = rid.numel(), int(((area != 0) | (cover != 0)).sum())
    del taps, rid, area, cover

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

    # 11. K8; 12. K6 and K7; 13. K9
    kres["fold_ablate"], launches["ablate"] = fold_ablation(device, kres["fold"])
    micro, launches["micro"] = microbenchmarks(device)
    kres.update(micro)
    kres["grid_scatter"], launches["scatter"] = scatter_probe(
        device, k2_slots, k2_live, kres["grid"])

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
