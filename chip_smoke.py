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
10. the two-key route (frames whose [row | slot | tx] key passes 31 bits:
   K1, the emit in PyTorch and the int64 two-key sort, the runs re-sorted
   into carry-chain order, K2, and K3 reading grid rows by src_u):
   (a) paris-30k at 7680x4320 (slot_bits 0 asserted, K4 never launched):
   K1, K2 and K3 `fold` on the frame's own inputs against their plain
   versions and timed as in phase 3, the real units whose src_u differs
   from src2_u counted (more than 0 required), the two-key emit, the int64
   sort, the whole rasterize_sort and run_data's re-sort timed, then the
   frame as in phase 5 (expand, grid and fold launched, rasterize never)
   against the plain path on the card; (b) paris-30k-styled and
   -textured at 7680x4320: K3 `fold_styled` and `fold_tex` against their
   plain versions; (c) the envelope tool's lattice (140,000 layers at
   1920x1080, 18 slot bits, built with the port's classes): the kernels
   and the frame as in (a), and its top-left 64x15 strip against the
   port's CPU render of the first 2,000 layers (exact there: max diff <=
   1); (d) the styled and textured mixes with the route forced
   (`pipeline.slot_bits_for` replaced by 0): K3 `fold_clip` against its
   plain version, and each frame bit-equal to its packed-path frame;
11. K5, the texture-fold probe (`forma_tpu_torch.probes.texture_fold`):
   its three modes against the plain version (bit-equal) at 8 blocks of
   32 tiles and 44 steps; then its entry point's measurement at the
   probe's paris shape (255 blocks), counters reset and read, each mode
   checked and timed there as in phase 3, and the probe's window gather;
12. K8, the fold ablation (`forma_tpu_torch.probes.fold_ablate`) on the
   TPU tool's paris-like inputs (seed 0: 465,747 units over 8,160 tiles),
   built once: its six variants in both designs (`DESIGNS`: grid words
   from device memory, or rows staged by TMA) against the plain version
   (bit-equal) on the first 8 blocks and at the full shape; each variant
   of the default design checked and timed at the full shape as in phase
   3; the kernels' ptxas registers and spills; then its entry point's
   measurement (counters reset and read) and each design's pieces beside
   K3 `fold` from phase 3 (also timed there by CUDA graph);
13. K6 and K7 (`probes.microbench`) at the TPU tool's sizes: K6's grouping
   prep timed alone, each kernel against its plain version as in phase 3;
   K7 also on a ragged cut (2^20 - 3 segments in [-3, 259)) and twice
   back to back on each input (its counter row resets), one launch a call
   by its counter and by the profiler's count, timed by CUDA graph and
   by calls queued back to back, beside an empty
   kernel's graph time (the launch floor) and two library calls
   (`torch.bincount`, and a zeroed int32 [256] `index_add_` of ones, which
   a graph can hold); then the entry point's measurement with the counters
   reset and read;
14. K9 (`probes.grid_scatter`), 2^20 segments in its two input modes, each
   against the plain version as in phase 3 with its rate in M segments/s
   beside K2's on the phase 3 frame; a ragged cut with segments outside
   the window bit-equal too (fewer clusters); the kernel's ptxas lines;
   then the entry point's measurement (CUDA graph ms) with the counters
   reset and read.
   Phases 12-14 also time each kernel as 20 calls captured in one CUDA
   graph (`ms_graph`, and the library call's where it allows a graph):
   the device time alone, where `ms` of a ~20 us kernel reads its
   wrapper's host rate; the entry points report that device time;
15. crop: paris-30k-styled and -textured at 1920x1080 (the compositions
   of phases 6 and 8) cropped to tile rows [20, 50) and tile columns
   [10, 100) through `Renderer.render_into(crop=)` with no cache: K3
   `fold_styled` and `fold_tex` on the cropped frame's own inputs
   (row_lo 20) against their plain versions as in phase 3, the rect
   against the uncropped frame (0 differing pixels), every byte outside
   it untouched, the cropped frame's ms beside the full frame's (5 each),
   launches counted over one cropped render; then a damage-cached
   paris-30k frame after 1% of its layers moved: K3 `fold` with its
   tile-skip mask against its plain version, the frame against a fresh
   render (equal) and its damage partial;
16. the spaceship at 1920x1080 (`demos/spaceship.py`, the JAX bench's
   config, `bench.py:104-151`) through the damage cache: 3 warm-up frames,
   60 synchronous `render_into` frames (launches counted over those calls
   alone), each byte-equal to a fresh uncached `Renderer.render` of the
   same state; an unchanged scene (no launch, nothing read back or
   written); K3 `fold` on a cached frame's own inputs against its plain
   version; then the same 63 steps from a fresh ship, the last 60 with
   `pipelined=True` and a `flush_pending()`, each buffer byte-equal to
   the synchronous buffer of one frame earlier; ms per frame (median,
   min, max) of both, damaged tiles and bytes read back per frame beside
   the full frame's 8.3 MB, regrow_count, DIAG_K against the uncached
   frame's, and a `torch.profiler` window of 10 more cached frames (wall
   and device ms a frame, the device's busy share, launches a frame);
17. animation: paris-30k at 1920x1080 and at 3840x2160 rotated as the
   JAX bench's animated configs (`bench.py:207-235`): warm-up, then 10
   frames of `render_device(check_caps=False)` under
   `torch.cuda.set_sync_debug_mode("warn")` (any synchronising call
   fails, printed by source line), fenced once at the end, their
   diagnostics checked after the loop (no bucket overflowed), beside the
   same frames with `check_caps=True` (no regrow); at 3840x2160 the packed
   key (slot_bits > 0) and the last frame against the plain path on the
   card (max channel diff <= 1); then a fresh renderer zooms each scene
   from 0.6 to 0.9 (1.5x) over 10 frames after `announce_max_scale(1.5)`
   with no regrow after its two warm-up frames;
18. the SVG front end: (a) `scenes.paris30k_svg_text(1920, 1080)` parsed
   by `demos.svg.Svg` and composed (the text, parse and compose seconds
   on a line of their own), K4, K2 and K3 `fold` on the parsed frame's
   own inputs against their plain versions as in phase 3, the frame
   through `Renderer.render` as in phase 5 (counters reset, warm-up + 5
   timed frames, each kernel launched; within 1/255 of the plain path on
   the card) and within 3/255 of phase 5's directly built paris-30k frame
   (the fills pass through 8-bit hex); (d) `Renderer.profile_frame` on
   the parsed frame, its `Timings` line (every stage finite and > 0,
   `k_active` the frame's DIAG_K, the stages' sum within 2x of
   `fused_frame`); (b) 3 pans (`compose(pan_x=2 i)`) through `render_into`
   with a damage cache: the segment buffer's version unchanged, each
   frame equal to a fresh render, damaged tiles and bytes read back per
   frame, the pan's host seconds apart from the render's; (c) the SVG
   sample document (`scenes.SVG_SAMPLE`, 64x64: gradients, groups, arcs,
   `mix-blend-mode: multiply`): K3 `fold_styled` on its inputs against its
   plain version, its frame and circles-64 at 256x256 against the port's
   numpy oracle (`backend_numpy`, max channel diff <= 1); (e) the demo CLI
   in-process, `gpu svg FILE` at 1920x1080 (3 frames, `--timings`,
   `--no-save`) and `oracle circles 16` at 64x64;
19. the multi-device frames, run right after phase 5 on its paris-30k
   composition (phases 15 and 17 move its layers), in 4 shards that all
   sit on the one card and run in turn (`devices=(card,) * 4`; every
   time is labelled so: none is a scaling figure): (a) the row-sharded
   frame (`Renderer.render_device_sharded`) and (b) the line-sharded
   frame (`render_device_sharded_lines`), each 0 pixels off
   `render_device` with the diag entries a max over shards keeps equal,
   launches counted over a warm-up and 5 fenced frames (every kernel at
   least once a shard), and K4, K2 and K3 `fold` on shard 2's own inputs
   (K4 at rows 17, row_lo 34 on a row shard, at the frame's 68 rows from
   row 0 on a line shard; K3 at row_lo 34) against their plain versions
   as in phase 3; for (b) the largest exchange block against `xcap`, the
   most segments a shard received against the frame's segments inside
   its rows over 4, the
   blocks' bytes a frame and the regrows; (c) ms per fenced frame
   (median, min, max of 5 after 1 warm-up) of (a), (b), the line path at
   one shard (its frame equal to `render_device`'s) and `render_device`,
   with each one's peak memory, and a `torch.profiler` window of 3 frames
   of `render_device` and of each sharded frame (wall and device ms a
   frame, launches a frame); (d) 5 line-sharded frames with
   `check_caps=False` under `torch.cuda.set_sync_debug_mode("warn")` (any
   synchronising call fails), their diagnostics checked after the loop;
   (e) on a machine with more than one card (skipped, and said so, on
   one), one shard on each card (`devices=None`) through both entry
   points: each shard's frame on its own card, the frames 0 pixels off
   `render_device`'s, launches of every kernel on every shard, ms per
   frame with every card synchronised;
20. the render-target envelope (`probes.envelope.measure_size`, the
   counterpart of `tools/envelope_probe.py:big_frames`): paris-30k at
   paths=8000 at ENVELOPE_SIZES, 16384x8192 (where the TPU failed) and
   32768x32768 (the largest size the probe's ladder renders on the H100), each
   rendered cold and warm, its route, ms, DIAG_SEGS, peak memory and the
   stage holding it, and its top-left and bottom-right 256x256 windows
   within 1/255 of the numpy oracle's render of them, each frame through
   the renderer's CUDA graph (the cold call captures it); at 32768x32768
   also one renderer's `render_device` and two `render_into` frames
   through the damage cache (`cache_ok` false, then true: one graph), each
   within 1/255 of the oracle's windows; then the format's limit,
   65536x32768, beside a live graph of two of its tile rows: the capture
   runs out of memory, evicts that graph, runs out again alone and raises,
   and the same renderer renders the rows again equal to a fresh
   renderer's;
21. the compiled frame (`forma_tpu_torch/graphs.py`: on the card a frame
   replays its key's CUDA graph), graph against eager, each configuration
   beside the phase whose scene it reuses: paris-30k at 1920x1080 on both
   expand paths (after phase 5), paris-30k-styled and -textured (6, 8),
   the styled and textured mixes (7, 9), paris-30k at 7680x4320 and the
   140,000-layer lattice on the two-key route (10), phase 15's crop and
   two more rectangles of its 30 tile rows on one renderer (one capture
   for the three), the spaceship's
   SHIP_FRAMES frames through the damage cache synchronous and pipelined
   (after 16: a graph renderer and an eager one on the same ship in
   lockstep, the host buffers byte-equal after every frame), and the
   animation at 1080p and 4K (17: ANIM_FRAMES `check_caps=False` frames
   each way under `torch.cuda.set_sync_debug_mode("error")`).  Each must
   show 0 differing pixels and an equal diag, its path's kernels launched
   inside the replay (K4 or K1, K2, K3's specialisation; never K4 on the
   two-key route), each a node of the recorded graph (`graph_witness`),
   and no capture after its first frame; each prints, graph
   beside eager (`render_device(taps={})`, or the eager renderer), ms a
   frame as median/min/max of GRAPH_FRAMES frames in each of GRAPH_REPEATS
   repeats (the animation also back to back, as phase 17 times it), the
   host's CUDA calls a frame and the device's busy share (`torch.profiler`,
   3 frames), and the capture's warm-up and recording seconds and pool
   bytes; the summary lines come after phase 20.  Every frame of phases
   4-18 and 20 that is not `plain=True` or `taps=` is a graph frame, and
   phase 5's timed frames are held to be replays.

The last three lines are a JSON object with per-kernel results (K1 on the
7680x4320 two-key frame; K3 once per specialisation, solid, styled,
textured, clip, and `fold` again on the 7680x4320 two-key frame, then
`fold_styled` on phase 15's cropped frame (row_lo 20) and `fold` on a
phase 16 spaceship frame (its unchanged tiles skipped); K4, K2 and K3
`fold` again on phase 18's parsed paris frame and `fold_styled` on the SVG
sample; K4, K2 and K3 `fold` on shard 2 of phase 19's row-sharded and
line-sharded frames; K5 in its atlas_rowsel mode; K8 `full`; K9 `independent`; each
entry names its frame), the card's name and power limit, and the status line
`{"ok": true, "device": {...}}`.

    python3 chip_smoke.py --multi-card

runs only phase 19 (e), on a machine with two cards or more.

    python3 chip_smoke.py --graph-check

runs only a quick subset of phase 21 (paris-30k at 1920x1080 on both
paths and its three crops, the mixes, the styled mix forced two-key, the
spaceship and the 1080p animation) and its summary.

    python3 chip_smoke.py --fold-timing DIR [DIR ...] [--scene paris|styled|textured|mix]

times K3 alone instead, on one paris-30k (or paris-30k-styled,
paris-30k-textured, or styled-mix) frame's own inputs as this checkout's port records
them, through the port of the checkout in each DIR in turn (for example a
parent commit unpacked with `git archive`; give them as parent, change,
change, parent), in both ways above and with the wrapper's host
microseconds, each output held bit-equal to this checkout's plain
version (a port whose fold takes no `row_lo` gets the arguments before
it: these frames' row_lo is 0); `tile_order` is timed alone first.

    python3 chip_smoke.py --probe-timing DIR [DIR ...]

times K8's six variants, K9's two modes and K7 (the tool's 2^20 segments
and the ragged cut) instead, on this checkout's inputs (the TPU tools'
shapes), through the port of the checkout in each DIR in turn (parent,
change, change, parent) at that port's defaults, each output held
bit-equal to this checkout's plain version: batched, synchronised and
CUDA-graph ms, the wrapper's host microseconds and each DIR's ptxas lines
for the three kernels, with `index_add_` beside K9 and K7 once, and the
empty kernel's graph time.

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
import functools
import heapq
import importlib
import inspect
import json
import math
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
    # launches count for it (an expand path of paris-30k, the styled or
    # textured frame, the styled mix, the two-key paris-30k at 7680x4320, or
    # the probe's entry point), the key of its numbers, the frame they
    # were measured on
    ("expand", "forma_tpu_torch/csrc/expand.cu",
     "forma_tpu/ops/expand_pallas.py:175", "wide", "expand_wide",
     "paris-30k 7680x4320 (two-key)"),
    ("rasterize", "forma_tpu_torch/csrc/rasterize.cu",
     "forma_tpu/ops/expand_pallas.py:356", "fused", "rasterize", "paris-30k 1920x1080"),
    ("grid", "forma_tpu_torch/csrc/grid.cu",
     "forma_tpu/ops/grid_pallas.py:314", "fused", "grid", "paris-30k 1920x1080"),
    ("fold", "forma_tpu_torch/csrc/fold.cu", K3, "fused", "fold", "paris-30k 1920x1080"),
    ("fold", "forma_tpu_torch/csrc/fold.cu", K3, "wide", "fold_wide",
     "paris-30k 7680x4320 (two-key)"),
    ("fold_styled", "forma_tpu_torch/csrc/fold.cu", K3, "styled", "fold_styled",
     "paris-30k-styled 1920x1080"),
    ("fold_tex", "forma_tpu_torch/csrc/fold.cu", K3, "textured", "fold_tex",
     "paris-30k-textured 1920x1080"),
    ("fold_clip", "forma_tpu_torch/csrc/fold.cu", K3, "mix", "fold_clip",
     "styled mix 512x512"),
    ("fold_styled", "forma_tpu_torch/csrc/fold.cu", K3, "crop", "fold_styled_crop",
     "paris-30k-styled 1920x1080, cropped to tile rows [20, 50) x columns [10, 100) "
     "(row_lo 20)"),
    ("fold", "forma_tpu_torch/csrc/fold.cu", K3, "spaceship", "fold_spaceship",
     "spaceship 1920x1080, damage-cached (unchanged tiles skipped)"),
    ("rasterize", "forma_tpu_torch/csrc/rasterize.cu",
     "forma_tpu/ops/expand_pallas.py:356", "svg", "rasterize_svg",
     "paris-30k parsed from SVG 1920x1080"),
    ("grid", "forma_tpu_torch/csrc/grid.cu",
     "forma_tpu/ops/grid_pallas.py:314", "svg", "grid_svg",
     "paris-30k parsed from SVG 1920x1080"),
    ("fold", "forma_tpu_torch/csrc/fold.cu", K3, "svg", "fold_svg",
     "paris-30k parsed from SVG 1920x1080"),
    ("fold_styled", "forma_tpu_torch/csrc/fold.cu", K3, "svgdoc", "fold_styled_svg",
     "the SVG sample document 64x64"),
    ("rasterize", "forma_tpu_torch/csrc/rasterize.cu",
     "forma_tpu/ops/expand_pallas.py:356", "rows", "rasterize_rows",
     "paris row shard 2 of 4 (4 shards in turn on one card)"),
    ("grid", "forma_tpu_torch/csrc/grid.cu",
     "forma_tpu/ops/grid_pallas.py:314", "rows", "grid_rows",
     "paris row shard 2 of 4 (4 shards in turn on one card)"),
    ("fold", "forma_tpu_torch/csrc/fold.cu", K3, "rows", "fold_rows",
     "paris row shard 2 of 4 (4 shards in turn on one card)"),
    ("rasterize", "forma_tpu_torch/csrc/rasterize.cu",
     "forma_tpu/ops/expand_pallas.py:356", "lines", "rasterize_lines",
     "paris line shard 2 of 4 (4 shards in turn on one card)"),
    ("grid", "forma_tpu_torch/csrc/grid.cu",
     "forma_tpu/ops/grid_pallas.py:314", "lines", "grid_lines",
     "paris line shard 2 of 4 (4 shards in turn on one card)"),
    ("fold", "forma_tpu_torch/csrc/fold.cu", K3, "lines", "fold_lines",
     "paris line shard 2 of 4 (4 shards in turn on one card)"),
    ("texture_probe", "forma_tpu_torch/csrc/texture_probe.cu",
     "tools/texture_fold_probe.py:157", "probe", "texture_probe", "the probe's paris shape"),
    ("fold_ablate", "forma_tpu_torch/csrc/fold_ablate.cu",
     "tools/fold_kernel_ablate.py:153", "ablate", "fold_ablate", "the TPU tool's inputs"),
    ("unit_stream", "forma_tpu_torch/csrc/microbench.cu",
     "tools/tpu_microbench2.py:154", "micro", "unit_stream", "the TPU tool's sizes"),
    ("seg_loop", "forma_tpu_torch/csrc/microbench.cu",
     "tools/tpu_microbench2.py:184", "micro", "seg_loop", "the TPU tool's sizes"),
    ("grid_scatter", "forma_tpu_torch/csrc/grid_scatter.cu",
     "tools/pallas_scatter_probe.py:66", "scatter", "grid_scatter", "2^20 segments"),
)
PATHS = {
    "fused": ("rasterize", "grid", "fold"),
    "split": ("expand", "grid", "fold"),
    "styled": ("rasterize", "grid", "fold_styled"),
    "mix": ("rasterize", "grid", "fold_clip"),
    "textured": ("rasterize", "grid", "fold_tex"),
    "texmix": ("rasterize", "grid", "fold_clip"),
    "wide": ("expand", "grid", "fold"),  # the two-key route: K1, never K4
    "crop": ("rasterize", "grid", "fold_styled"),
    "spaceship": ("rasterize", "grid", "fold"),
    "svg": ("rasterize", "grid", "fold"),
    "svgdoc": ("rasterize", "grid", "fold_styled"),
    "rows": ("rasterize", "grid", "fold"),  # phase 19: every shard
    "lines": ("rasterize", "grid", "fold"),
}
PARIS_W, PARIS_H = 1920, 1080
MIX_W, MIX_H = 512, 512
N_SCATTER = 1 << 20  # K9's segments (the TPU tool's)
N_SEG_EDGES = (1 << 20) - 3  # K7's ragged cut
# Phase 20: the largest frame the envelope probe's ladder renders on the
# H100 (`PERF.md`), and the size where the TPU failed.
ENVELOPE_SIZES = ((16384, 8192), (32768, 32768))
ENVELOPE_MOVED = 16  # layers moved before the largest size's cached frames
ENVELOPE_SPAN = (0, 2)  # tile rows rendered at the format's limit beside its capture
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
    ust[t] + cnt[t] - 1 of tile t): (unit count, run of each unit in
    carry-chain order (src2_u), its grid row (src_u), whether it is
    virtual), as the kernel addresses them."""
    ust, cnt, src, src2, tx_s, tiles_x = (args[i] for i in (0, 1, 2, 3, 8, 11))
    n = cnt.long()
    tile = torch.repeat_interleave(torch.arange(ust.shape[0], device=ust.device), n)
    k = torch.arange(tile.numel(), device=ust.device) - (torch.cumsum(n, 0) - n)[tile]
    u = (ust.long()[tile] + k).clamp(max=src2.shape[0] - 1)
    r = src2[u].long().clamp(0, tx_s.shape[0] - 1)
    g = src[u].long().clamp(0, tx_s.shape[0] - 1)
    return u.numel(), r, g, tx_s[r].long() != tile % tiles_x


def fold_bytes(args, out) -> int:
    """Bytes K3 must move on these inputs, 4 per i32 or f32 value: the tile
    spans; src2 (src too, where it is another array; virt_u in a clip
    frame) of each folded unit; the grid row (by src) and carry_in row of
    each run a real unit folds; the carry_after row of each run a virtual
    unit folds; tx_s and the style row of each run folded (a texture
    frame's row holds its 10 texture lanes); clear; the atlas of a texture
    frame, once; the output."""
    n_units, r, g, virt = fold_units(args)
    ust, src, src2, virt_u, style_s, atlas = (args[i] for i in (0, 2, 3, 4, 9, 14))
    grid_rows = torch.unique(g[~virt]).numel()
    real_runs = torch.unique(r[~virt]).numel()
    virt_runs = torch.unique(r[virt]).numel()
    runs = torch.unique(r).numel()
    per_unit = 1 + (src is not src2) + (virt_u is not None)
    words = (2 * ust.numel() + n_units * per_unit + grid_rows * 256
             + real_runs * 16 + virt_runs * 16 + runs * (1 + style_s.shape[1]) + 4)
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

    style_s, features, ms = args[9], args[12], args[13]
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


# K4's and K3's argument index of `row_lo` (`rasterize_blocks`, `paint_fold`).
ROW_LO_ARG = {"rasterize": 7, "fold": 15, "fold_styled": 15, "fold_tex": 15, "fold_clip": 15}


def row_lo_on_device(name: str, args, build=None) -> tuple:
    """`args` of kernel `name` with an int `row_lo` made the int32 device
    scalar that a graph frame passes: the wrapper writes an int there
    with a fill, which would be timed with the kernel.  `build`, a port's
    `ops._build`, leaves the int to a port whose kernels take it by
    value (one without `row_lo_tensor`)."""
    i = ROW_LO_ARG.get(name)
    if (i is None or i >= len(args) or isinstance(args[i], torch.Tensor)
            or (build is not None and not hasattr(build, "row_lo_tensor"))):
        return args
    return (*args[:i], torch.full((), args[i], dtype=torch.int32, device="cuda"),
            *args[i + 1:])


def check_kernel(name: str, kern, plain, args, graph: bool = False, **label) -> dict:
    """A kernel against its plain version on a frame's own inputs (bit-equal
    required); returns the kernels line's numbers for it.  `graph` adds
    the device time per call from CUDA graph replays (`ms_graph`, and
    `library_ms_graph` where the library call allows a graph).  `label` is
    printed with the numbers.  K4's and K3's `row_lo` is passed as the
    device scalar a graph frame passes (`row_lo_on_device`)."""
    args = row_lo_on_device(name, args)
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
    # K3 also by CUDA graph replays: phase 12 sets K8 beside it.
    return {name: check_kernel(name, *pair, taps[name], graph=name == "fold")
            for name, pair in pairs.items()}


def check_fold(name: str, args, **label) -> dict:
    """K3's specialisation `name` (the launch counter its features select)
    against its plain version on a frame's own inputs; `label` is printed
    with the numbers."""
    from forma_tpu_torch.ops import fold_kernel as fk

    if fk.variant(args[12]) != name:
        raise AssertionError(f"{name}: the frame's features {args[12]} select "
                             f"{fk.variant(args[12])}")
    return check_kernel(name, fk.paint_fold, fk.paint_fold_torch, args, **label)


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
    n_units, _, _, virt = fold_units(args)
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
    through Renderer.render (each timed frame a replay of the frame's CUDA
    graph, whose kernel nodes `graph_witness` checks), counters read; the
    frame against `ref`."""
    from forma_tpu_torch import Color
    from forma_tpu_torch.ops import _build

    w, h = size
    clear = Color(1.0, 1.0, 1.0, 1.0)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    img = r.render(comp, w, h, clear)
    captures, replays = r.graphs.captures, r.graphs.replays
    times = []
    for _ in range(n_timed):
        t = time.perf_counter()
        img = r.render(comp, w, h, clear)
        times.append((time.perf_counter() - t) * 1e3)
    launches = dict(_build.LAUNCHES)
    if r.graphs.captures != captures or r.graphs.replays - replays != n_timed:
        raise AssertionError(f"{label} ({path}): the timed frames were not graph replays "
                             f"({r.graphs.captures - captures} captures, "
                             f"{r.graphs.replays - replays} replays)")
    nodes = graph_witness(f"{label} ({path})", r.graphs.last_capture, PATHS[path])
    diff = np.abs(img.astype(int) - ref.astype(int))
    say(label, path=path, frame_ms_median=f"{statistics.median(times):.2f}",
        frame_ms_min=f"{min(times):.2f}", frame_ms_max=f"{max(times):.2f}",
        frames=len(times), diag=r.last_diag.tolist(),
        max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
        graph_kernel_nodes=nodes)
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
    numbers, launches, the composition)."""
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
        regrows=r.regrow_count, features=str(taps["fold"][12]).replace(" ", ""))
    fold_depths(label, taps["fold"])
    check_k4(label, taps["rasterize"])
    res = check_fold(counter, taps["fold"])
    del taps
    ref, _ = r.render_device(comp, PARIS_W, PARIS_H, clear, plain=True)
    ref = ref[:PARIS_H, :PARIS_W].cpu().numpy()
    launches = frame_path(label, label, r, comp, (PARIS_W, PARIS_H), ref)
    graph_frame(f"paris-30k-{label} 1920x1080", r, comp, (PARIS_W, PARIS_H), PATHS[label])
    return res, launches, comp


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
        features=str(taps["fold"][12]).replace(" ", ""))
    check_k4(label, taps["rasterize"])
    res = check_fold("fold_clip", taps["fold"])
    del taps
    t = time.perf_counter()
    want = Renderer("cpu").render(comp, MIX_W, MIX_H, clear)
    say(label, cpu_render_s=f"{time.perf_counter() - t:.1f}")
    launches = frame_path(label, label, r, comp, (MIX_W, MIX_H), want)
    graph_frame(f"{label} 512x512", r, comp, (MIX_W, MIX_H), PATHS[label])
    return res, launches


WIDE_W, WIDE_H = 7680, 4320
LATTICE_LAYERS, LATTICE_COLS, LATTICE_ROWS = 140_000, 400, 350
LATTICE_STRIP_LAYERS = 2_000


def two_key_stages(label: str, taps) -> dict:
    """The two-key route's PyTorch stages on a frame's own inputs, each
    timed by CUDA events (batches of back-to-back calls): the emit after
    K1 (`rasterize._emit_two_key`), the int64 sort (`sort_two_key`), the
    whole `rasterize_sort` stage, and `run_data` with and without its
    re-sort into carry-chain order (`presorted` False and True on the same
    runs; the difference is the re-sort: the int64 sort, the inverse
    permutation, the rowcov gather and the real_flags scatter)."""
    from forma_tpu_torch.ops import expand_kernel as ek
    from forma_tpu_torch.ops import rasterize as ras
    from forma_tpu_torch.ops import runs

    stage = taps["rasterize_sort"]
    v_total, v_cap, k_seg, rows, tiles_x, row_lo = stage[4:10]
    pt, j = ek.expand_params(*taps["expand"])
    v_live = torch.arange(v_cap, device=pt.device) < v_total

    def emit():
        return ras._emit_two_key(lambda i: pt[i], j, v_live, k_seg, rows, tiles_x, row_lo)

    kh, kl, pl = (t.reshape(-1) for t in emit())
    rd_args = taps["run_data"]
    times = {
        "two_key_emit_ms": time_ms(emit, batches=3, per_batch=3),
        "int64_sort_ms": time_ms(lambda: ras.sort_two_key(kh, kl, pl), batches=3,
                                 per_batch=3),
        "rasterize_sort_ms": time_ms(
            lambda: ras.rasterize_sort(*stage[:10], slot_bits=stage[10]), batches=3,
            per_batch=3),
        "run_data_ms": time_ms(lambda: runs.run_data(*rd_args, presorted=False),
                               batches=3, per_batch=3),
        "run_data_without_resort_ms": time_ms(
            lambda: runs.run_data(*rd_args, presorted=True), batches=3, per_batch=3),
    }
    times["run_data_resort_ms"] = times["run_data_ms"] - times["run_data_without_resort_ms"]
    say(label, segment_slots=kh.numel(), valid_segments=int((kh != U32_SENTINEL).sum()),
        runs=int(rd_args[5]), **{k: f"{v:.4f}" for k, v in times.items()})
    return times


def two_key_units(label: str, args) -> int:
    """Real units K3 folds whose grid row (src_u) is not their carry-chain
    run (src2_u), on a two-key frame's fold inputs; fails unless some are,
    and unless the inputs take the assembly mode (src_u another array)."""
    _, r, g, virt = fold_units(args)
    n = int((g != r)[~virt].sum())
    say(label, real_units=int((~virt).sum()), real_units_src_ne_src2=n,
        virtual_units=int(virt.sum()))
    if args[2] is args[3] or n < 1:
        raise AssertionError(f"{label}: no real unit with src_u != src2_u on a two-key frame")
    return n


def wide_frame(device, label: str, build, size, counter: str, frame_check: bool) -> tuple:
    """One two-key frame at `size` built by `build(comp)`: slot_bits 0
    asserted, K1, K2 and K3 (specialisation `counter`) held bit-equal to
    their plain versions on the frame's own inputs and timed; with
    `frame_check`, the two-key stages timed and the frame through
    `Renderer.render` (counters reset, warm-up, 5 timed frames, counters
    read: expand, grid and `counter` launched, rasterize never) against
    the plain path on the card.  Returns ({kernel: numbers}, launches or
    None, renderer, composition)."""
    from forma_tpu_torch import Color, Composition, Renderer

    w, h = size
    t = time.perf_counter()
    comp = Composition()
    build(comp)
    say(label, size=f"{w}x{h}", scene_build_s=f"{time.perf_counter() - t:.1f}",
        layers=len(comp.layers))
    clear = Color(1.0, 1.0, 1.0, 1.0)
    r = Renderer(device)
    taps = {}
    t = time.perf_counter()
    r.render_device(comp, w, h, clear, taps=taps)
    torch.cuda.synchronize()
    slot_bits = taps["rasterize_sort"][10]
    say(label, first_frame_s=f"{time.perf_counter() - t:.2f}", caps=tuple(r._caps),
        regrows=r.regrow_count, slot_bits=slot_bits, has_rasterize_taps="rasterize" in taps,
        features=str(taps["fold"][12]).replace(" ", ""))
    if slot_bits != 0 or "rasterize" in taps:
        raise AssertionError(f"{label}: slot_bits {slot_bits}: not the two-key route")
    from forma_tpu_torch.ops import expand_kernel as ek
    from forma_tpu_torch.ops import grid_kernel as gk

    fold_depths(label, taps["fold"])
    two_key_units(label, taps["fold"])
    res = {}
    if frame_check:
        res["expand"] = check_kernel("expand", ek.expand_params, ek.expand_params_torch,
                                     taps["expand"], frame=label)
        res["grid"] = check_kernel("grid", gk.grid_build, gk.grid_build_torch, taps["grid"],
                                   frame=label)
    res[counter] = check_fold(counter, taps["fold"], frame=label)
    launches = None
    if frame_check:
        res["stages"] = two_key_stages(label, taps)
        del taps
        ref, _ = r.render_device(comp, w, h, clear, plain=True)
        ref = ref[:h, :w].cpu().numpy()
        launches = frame_path(label, "wide" if counter == "fold" else counter, r, comp,
                              (w, h), ref)
        if launches["rasterize"] != 0:
            raise AssertionError(f"{label}: K4 launched {launches['rasterize']} times "
                                 "on the two-key route")
        if counter == "fold":  # 21. the compiled frame on the two-key route
            scene = {"wide": "paris-30k", "lattice": "the 140,000-layer lattice"}[label]
            graph_frame(f"{scene} {w}x{h} (two-key)", r, comp, size, PATHS["wide"],
                        never=("rasterize",))
    return res, launches, r, comp


def envelope_lattice(comp, n_layers: int = LATTICE_LAYERS, width: int = PARIS_W) -> None:
    """The envelope tool's wide-key lattice (`tools/envelope_probe.py:89-115`)
    with the port's classes: layer i a 3.5x2.5 rectangle at ((i % 400) *
    width / 400, ((i // 400) % 350) * 3), solid fill ((i % 97) / 97,
    (i % 31) / 31, (i % 7) / 7, 0.9)."""
    from forma_tpu_torch import Color, Fill, Func, Order, Point, Props, Style
    from forma_tpu_torch.path import PathBuilder

    for i in range(n_layers):
        x = (i % LATTICE_COLS) * (width / LATTICE_COLS)
        y = ((i // LATTICE_COLS) % LATTICE_ROWS) * 3.0
        layer = comp.get_mut_or_insert_default(Order(i))
        layer.insert(PathBuilder().move_to(Point(x, y)).line_to(Point(x, y + 2.5))
                     .line_to(Point(x + 3.5, y + 2.5)).line_to(Point(x + 3.5, y)).build())
        layer.set_props(Props(func=Func.Draw(Style(fill=Fill.Solid(
            Color((i % 97) / 97, (i % 31) / 31, (i % 7) / 7, 0.9))))))


def forced_two_key_mix(device, label: str, build) -> tuple:
    """A mix at 512x512 with the two-key route forced (`pipeline.
    slot_bits_for` replaced by 0, as `tests/test_multichip_lines.py:290`
    does in the JAX package): K3 `fold_clip` on its inputs against its
    plain version, and the frame through `Renderer.render` bit-equal to
    the same scene's packed-path frame on the card (0 differing pixels
    expected: every accumulation is integer and the units fold in the same
    order); returns (K3 numbers, launches)."""
    from forma_tpu_torch import Color, Composition, Renderer
    from forma_tpu_torch.ops import _build, pipeline

    comp = Composition()
    build(comp)
    clear = Color(1.0, 1.0, 1.0, 1.0)
    packed = Renderer(device).render(comp, MIX_W, MIX_H, clear)
    real = pipeline.slot_bits_for
    pipeline.slot_bits_for = lambda *_: 0
    try:
        r = Renderer(device)
        taps = {}
        r.render_device(comp, MIX_W, MIX_H, clear, taps=taps)
        if taps["rasterize_sort"][10] != 0 or "rasterize" in taps:
            raise AssertionError(f"{label}: the two-key route was not taken")
        two_key_units(label, taps["fold"])
        res = check_fold("fold_clip", taps["fold"], frame=label)
        del taps
        _build.reset_launches()
        img = r.render(comp, MIX_W, MIX_H, clear)
        launches = dict(_build.LAUNCHES)
    finally:
        pipeline.slot_bits_for = real
    diff = np.abs(img.astype(int) - packed.astype(int))
    say(label, forced_slot_bits=0, launches=launches, max_diff_vs_packed=int(diff.max()),
        differing_pixels_vs_packed=int((diff > 0).any(axis=-1).sum()))
    if diff.max() != 0:
        raise AssertionError(f"{label}: the two-key frame differs from the packed frame")
    for name in ("expand", "grid", "fold_clip"):
        if launches[name] < 1:
            raise AssertionError(f"{label}: {name} was never launched")
    if launches["rasterize"] != 0:
        raise AssertionError(f"{label}: K4 launched on the two-key route")
    return res, launches


def wide_key(device) -> tuple:
    """Phase 10, the two-key route: (a) paris-30k at 7680x4320 (K1, K2 and
    K3 `fold`, the stages, the frame); (b) paris-30k-styled and -textured
    at 7680x4320 (K3 `fold_styled` and `fold_tex`); (c) the envelope
    tool's 140,000-layer lattice at 1920x1080 (the kernels, the frame, and
    its top-left strip against the port's CPU render of the first 2,000
    layers); (d) the styled and textured mixes with the route forced,
    against their packed frames.  Returns ({result key: numbers},
    launches of the 7680x4320 run)."""
    from forma_tpu_torch import Color, Composition, Renderer
    from forma_tpu_torch.demos import scenes

    size = (WIDE_W, WIDE_H)
    out = {}
    res, launches, r, comp = wide_frame(
        device, "wide", lambda c: scenes.paris30k(c, *size), size, "fold", True)
    out.update({"expand_wide": res["expand"], "grid_wide": res["grid"],
                "fold_wide": res["fold"], "stages_wide": res["stages"]})
    del r, comp
    for label, counter in (("styled", "fold_styled"), ("textured", "fold_tex")):
        res, _, r, comp = wide_frame(
            device, f"wide-{label}",
            lambda c, n=PARIS_SCENES[label]: getattr(scenes, n)(c, *size), size, counter,
            False)
        out[f"{counter}_wide"] = res[counter]
        del r, comp

    res, lattice_launches, r, comp = wide_frame(
        device, "lattice", envelope_lattice, (PARIS_W, PARIS_H), "fold", True)
    out["lattice"] = res
    clear = Color(1.0, 1.0, 1.0, 1.0)
    img = r.render(comp, PARIS_W, PARIS_H, clear)
    del r, comp
    strip = Composition()
    envelope_lattice(strip, LATTICE_STRIP_LAYERS)
    want = Renderer("cpu").render(strip, 64, 16, clear)
    # Rows y < 15 are painted only by layers (i // 400) % 350 <= 4, that
    # is i < 2,000 (`tools/envelope_probe.py:145-147`): the strip is exact.
    diff = int(np.abs(img[:15, :64].astype(int) - want[:15, :64].astype(int)).max())
    say("lattice", strip="64x15", strip_layers=LATTICE_STRIP_LAYERS,
        max_diff_vs_cpu_strip=diff, painted=int((img[:15, :64, :3] != 255).any(-1).sum()))
    if diff > 1:
        raise AssertionError(f"lattice: top-left strip max diff {diff} > 1 vs the CPU render")

    out["fold_clip_wide_mix"], _ = forced_two_key_mix(
        device, "wide-mix", lambda c: scenes.styled_mix(c, 400, MIX_W, MIX_H))
    out["fold_clip_wide_texmix"], _ = forced_two_key_mix(
        device, "wide-texmix", lambda c: scenes.textured_mix(c, 300, MIX_W, MIX_H))
    return out, launches


def texture_probe(device) -> tuple:
    """Phase 11: K5's three modes against the plain version at 8 blocks,
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


def ptxas_lines(log_path, needle: str) -> list:
    """(entry, registers line, spill line) of every kernel whose mangled
    name holds `needle` in the nvcc log at `log_path`."""
    log = log_path.read_text().splitlines()
    out = []
    for i, line in enumerate(log):
        if "Compiling entry" in line and needle in line:
            rest = [x.strip() for x in log[i + 1:i + 5]]
            regs = next((x for x in rest if "registers" in x), "")
            spill = next((x for x in rest if "spill" in x), "")
            name = line.split("'")[1] if "'" in line else line.strip()
            out.append((needle + name.split(needle, 1)[1][:36], regs, spill))
    return out


def say_ptxas(phase: str, log_path, needle: str) -> None:
    for entry, regs, spill in ptxas_lines(log_path, needle):
        say(phase, entry=entry, ptxas=repr(regs.replace("ptxas info    : ", "")),
            spills=repr(spill))


def fold_ablation(device, k3: dict) -> tuple:
    """Phase 12: K8's six variants in both designs against the plain
    version, bit-equal on the first 8 blocks of the TPU tool's inputs and at
    their full shape; each variant of the default design checked and timed
    at the full shape as in phase 3 (with CUDA graph ms); the kernels'
    ptxas lines; then its entry point's measurement with the counters reset
    and read; each piece's cost beside K3 `fold` (`k3`, phase 3); returns
    (the `full` numbers, launches)."""
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.probes import fold_ablate as k8

    t = time.perf_counter()
    u_mat, blkinfo = k8.paris_inputs()
    say("ablate", inputs_build_s=f"{time.perf_counter() - t:.1f}", tiles=blkinfo.shape[0] * k8.TB,
        units=k8.addressed_rows(blkinfo), u_mat_rows=u_mat.shape[0], design=k8.DESIGN)
    u_mat, blkinfo = u_mat.to(device), blkinfo.to(device)
    clear = torch.ones(4, dtype=torch.float32, device=device)
    cut = blkinfo[:8].contiguous()
    for variant in k8.VARIANTS:
        for bi in (cut, blkinfo):
            want = k8.fold_ablate_torch(u_mat, bi, clear, variant)
            for design in k8.DESIGNS:
                got = k8.fold_ablate(u_mat, bi, clear, variant, design)
                torch.cuda.synchronize()
                err = max_abs_err((got,), (want,))
                say("ablate", variant=variant, design=design, nblk=bi.shape[0],
                    units=k8.addressed_rows(bi), max_abs_err=err)
                if err != 0.0:
                    raise AssertionError(f"fold_ablate {variant} ({design}): differs from its "
                                         f"plain version ({err})")
    res = {}
    for variant in k8.VARIANTS:
        res[variant] = check_kernel("fold_ablate", k8.fold_ablate, k8.fold_ablate_torch,
                                    (u_mat, blkinfo, clear, variant), graph=True,
                                    variant=variant, design=k8.DESIGN)
    say_ptxas("ablate", _build.library_path().parent / "nvcc.log", "fold_ablate_kernel")
    _build.reset_launches()
    m = k8.measure((u_mat, blkinfo), device)
    launches = dict(_build.LAUNCHES)
    say("ablate", tiles=m["tiles"], units=m["units"], launches=launches["fold_ablate"])
    for design in k8.DESIGNS:
        say("ablate", design=design, **{f"{v}_ms": f"{m[design][v]:.4f}" for v in k8.VARIANTS})
        say("k8", question="what each piece of a fold step costs, against K3 fold",
            design=design,
            **{f"piece_{p}_ms": f"{ms:.4f}" for p, ms in k8.pieces(m[design]).items()},
            k3_fold_ms=f"{k3['ms']:.4f}", k3_fold_ms_graph=f"{k3['ms_graph']:.4f}",
            k3_fold_bound_ms=f"{k3['bound_ms']:.4f}",
            full_bound_ms=f"{res['full']['bound_ms']:.4f}")
    if launches["fold_ablate"] < 1:
        raise AssertionError("fold_ablate was never launched by its entry point")
    return res["full"], launches


def microbenchmarks(device) -> tuple:
    """Phase 13: K6 (its grouping prep timed alone) and K7 against their
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
    seg_loop_checks(device, segs)
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


def seg_edges(n: int = N_SEG_EDGES, seed: int = 3) -> torch.Tensor:
    """K7's ragged cut: n segments from a numpy seed in [-3, 259)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-3, 259, n).astype(np.int32))


def kernels_in(fn) -> tuple:
    """(kernel launches through the CUDA runtime, names of the device
    kernels) of one call of `fn()`, by the profiler; memory copies and
    sets are not kernels.  A profiler session after an earlier one in the
    same process may record no device activity, so a caller reads the
    launches and holds the names only where there are any."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                              "cuLaunchKernelEx") for e in events)
    names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.lower().startswith(("memcpy", "memset"))]
    return launches, names


def seg_loop_checks(device, segs) -> None:
    """Phase 13's K7 checks: the tool's segments and the ragged cut
    bit-equal to the plain version across two calls back to back (the
    kernel's reset works); one launch a call by the counter and by the
    profiler; its graph time beside the empty kernel's and the library
    calls'."""
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.probes import microbench as mb
    from forma_tpu_torch.probes import time_ms_graph

    edges = seg_edges().to(device)
    errs = []
    for v in (segs, edges):
        want = mb.seg_loop_torch(v)
        got = [mb.seg_loop(v) for _ in range(2)]
        torch.cuda.synchronize()
        errs += [max_abs_err((g,), (want,)) for g in got]
    if max(errs) != 0.0:
        raise AssertionError(f"seg_loop: differs from its plain version ({max(errs)})")
    fn = lambda: mb.seg_loop(segs)  # noqa: E731
    _build.reset_launches()
    fn()
    torch.cuda.synchronize()
    counted = _build.LAUNCHES["seg_loop"]
    runtime_launches, names = kernels_in(fn)
    idx, ones = segs.long(), torch.ones_like(segs)
    flat = torch.zeros(mb.BINS, dtype=torch.int32, device=device)
    lib = lambda: flat.index_add_(0, idx, ones)  # noqa: E731
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    say("micro", kernel="seg_loop", blocks=mb.seg_blocks(segs.numel(), sms),
        max_abs_err_tool_ragged_back_to_back=max(errs),
        launches_a_call=counted, profiler_launches=runtime_launches,
        profiler_device_kernels=repr(names),
        ms_graph=f"{time_ms_graph(fn):.4f}", ms=f"{time_ms(fn):.4f}",
        empty_kernel_ms_graph=f"{time_ms_graph(mb.launch_floor):.4f}",
        bincount_ms=f"{time_ms(lambda: torch.bincount(segs, minlength=mb.BINS)):.4f}",
        index_add_ms=f"{time_ms(lib):.4f}", index_add_ms_graph=f"{time_ms_graph(lib):.4f}")
    if counted != 1 or runtime_launches != 1 or len(names) > 1:
        raise AssertionError(f"seg_loop: {counted} counted launches, {runtime_launches} "
                             f"runtime launches and kernels {names} in one call, not one")


def scatter_edges(n: int = 8 * 16384 + 3, seed: int = 3) -> tuple:
    """(row, cell, val) i32 [n] from a numpy seed, row and cell in [-3,
    259): a ragged length and segments outside the window."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32))
                 for lo, hi in ((-3, 259), (-3, 259), (-1000, 1000)))


def scatter_probe(device, k2_slots: int, k2_live: int, k2: dict) -> tuple:
    """Phase 14: K9 in both input modes against the plain version, each
    with its rate beside K2's on the phase 3 frame (`k2_slots` segment
    slots, `k2_live` of them live, K2's numbers `k2`), a ragged cut with
    segments outside the window bit-equal too, the kernel's ptxas lines,
    then the entry point's measurement with the counters reset and read;
    returns (the `independent` numbers, launches)."""
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.probes import grid_scatter as k9

    edges = tuple(t.to(device) for t in scatter_edges())
    got = k9.grid_scatter(*edges)
    torch.cuda.synchronize()
    err = max_abs_err((got,), (k9.grid_scatter_torch(*edges),))
    say("scatter", mode="edges", segments=edges[0].numel(),
        clusters=k9.cluster_count(edges[0].numel()), max_abs_err=err)
    if err != 0.0:
        raise AssertionError(f"grid_scatter on the ragged cut: differs from its plain "
                             f"version ({err})")
    out = {}
    for mode in k9.MODES:
        args = tuple(t.to(device) for t in k9.scatter_inputs(mode))
        out[mode] = check_kernel("grid_scatter", k9.grid_scatter, k9.grid_scatter_torch, args,
                                 graph=True, mode=mode, clusters=k9.cluster_count(N_SCATTER))
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
    say_ptxas("scatter", _build.library_path().parent / "nvcc.log", "grid_scatter_kernel")
    _build.reset_launches()
    m = k9.measure(device)
    launches = dict(_build.LAUNCHES)
    say("scatter", launches=launches["grid_scatter"],
        **{f"{mode}_ms": f"{m[mode]:.4f}" for mode in k9.MODES})
    if launches["grid_scatter"] < 1:
        raise AssertionError("grid_scatter was never launched by its entry point")
    return {"mode": "independent", **out["independent"]}, launches


# Phase 15's crop: tile rows [20, 50) and tile columns [10, 100) of a
# 1920x1080 frame; bytes outside it start as SENTINEL_BYTE.
CROP_ROWS, CROP_COLS = (20, 50), (10, 100)
SENTINEL_BYTE = 0xA5
SHIP_WARM, SHIP_FRAMES = 3, 60  # phase 16 (`bench.py:104-151`)
SHIP_CLEAR = (0.02, 0.02, 0.08, 1.0)
ANIM_FRAMES = 10  # phase 17 (`bench.py:207-271`), at 1920x1080 and at ANIM_4K
ANIM_4K = (3840, 2160)
ZOOM_FROM, ZOOM_BY = 0.6, 1.5  # phase 17's zoom: scale 0.6 -> 0.9


def paris_orders(comp) -> np.ndarray:
    return np.asarray([o.as_u32() for o in comp.layers], np.uint32)


def timed(fn) -> float:
    """Host milliseconds of `fn()` (which returns on the host, synced)."""
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


def spread(label: str, values) -> dict:
    """{label_median, label_min, label_max} of a list of numbers."""
    return {f"{label}_median": f"{statistics.median(values):.3f}",
            f"{label}_min": f"{min(values):.3f}", f"{label}_max": f"{max(values):.3f}"}


def count_launches(total: dict, fn):
    """Runs `fn()` and adds the kernel launches it made to `total`."""
    from forma_tpu_torch.ops import _build

    _build.reset_launches()
    out = fn()
    for k, v in _build.LAUNCHES.items():
        total[k] = total.get(k, 0) + v
    return out


def stems(counts: dict) -> dict:
    """Launch counts by kernel stem (`graphs.KERNELS`): K3's
    specialisations (`fold_styled`, ...) count as `fold`; zeros dropped."""
    out = {}
    for name, v in counts.items():
        if v:
            out[name.split("_")[0]] = out.get(name.split("_")[0], 0) + v
    return out


def graph_witness(label: str, cap, kernels) -> dict:
    """The kernel nodes of the graph whose `Capture` is `cap`, read from the
    recorded graph itself (`FrameGraphs.witness`, which main sets): each
    of `kernels` (launch counter names) must have a node, and the nodes
    must equal, stem by stem, what the capture grew the launch counters
    by (what each replay adds to them)."""
    nodes = cap.kernel_nodes
    missing = [k for k in kernels if not (nodes or {}).get(k.split("_")[0])]
    if nodes is None or missing or nodes != stems(cap.launches):
        raise AssertionError(f"{label}: the graph's kernel nodes {nodes} lack {missing} or "
                             f"differ from its capture's launches {cap.launches}")
    return nodes


def crop_phase(device, comps: dict, paris) -> tuple:
    """Phase 15: paris-30k-styled and -textured at 1920x1080 (`comps`, the
    compositions of phases 6 and 8) cropped to tile rows CROP_ROWS and
    tile columns CROP_COLS through `render_into(crop=)` with no cache: K3
    `fold_styled` and `fold_tex` on the cropped frame's own inputs (row_lo
    20) against their plain versions, the rect against the uncropped frame
    (0 differing pixels), the bytes outside it untouched, the cropped
    frame's ms beside the full frame's; then K3 `fold` with a tile-skip
    mask, on a damage-cached paris-30k frame (`paris`) after 1% of its
    layers moved, against its plain version, and that frame against a fresh
    render.  Returns ({result key: numbers}, launches of the styled crop's
    counted run)."""
    from forma_tpu_torch import RGBA, Buffer, Color, LinearLayout, Rect, Renderer
    from forma_tpu_torch.ops import pipeline as pipe

    w, h = PARIS_W, PARIS_H
    clear = Color(1.0, 1.0, 1.0, 1.0)
    (r0, r1), (c0, c1) = CROP_ROWS, CROP_COLS
    y0, y1, x0, x1 = 16 * r0, 16 * r1, 16 * c0, 16 * c1
    rect = Rect.new(range(x0, x1), range(y0, y1))
    out, launches = {}, None
    for label, counter in (("styled", "fold_styled"), ("textured", "fold_tex")):
        comp = comps[label]
        r = Renderer(device)
        full = r.render(comp, w, h, clear)
        taps = {}
        r.render_device(comp, w, h, clear, row_span=CROP_ROWS, crop_x=CROP_COLS, taps=taps)
        torch.cuda.synchronize()
        if taps["fold"][15] != r0:
            raise AssertionError(f"crop {label}: K3 row_lo {taps['fold'][15]}, not {r0}")
        out[f"{counter}_crop"] = check_fold(counter, taps["fold"], frame=f"{label}-crop",
                                            row_lo=r0)
        del taps
        buf = np.full((h, w * 4), SENTINEL_BYTE, np.uint8)
        buffer = Buffer(buffer=buf, layout=LinearLayout(w, w * 4, h))
        run = {}
        count_launches(run, lambda: r.render_into(comp, buffer, clear, crop=rect))
        crop_ms = [timed(lambda: r.render_into(comp, buffer, clear, crop=rect))
                   for _ in range(5)]
        full_ms = [timed(lambda: r.render(comp, w, h, clear)) for _ in range(5)]
        img = buf.reshape(h, w, 4)
        diff = np.abs(img[y0:y1, x0:x1].astype(int) - full[y0:y1, x0:x1].astype(int))
        outside = np.ones((h, w), bool)
        outside[y0:y1, x0:x1] = False
        untouched = bool((img[outside] == SENTINEL_BYTE).all())
        say("crop", frame=label, rect=f"rows[{y0},{y1})xcols[{x0},{x1})", row_lo=r0,
            max_diff_vs_full=int(diff.max()),
            differing_pixels=int((diff > 0).any(axis=-1).sum()),
            outside_untouched=untouched, launches=run,
            **spread("crop_frame_ms", crop_ms), **spread("full_frame_ms", full_ms))
        if diff.max() != 0 or not untouched:
            raise AssertionError(f"crop {label}: the rect differs from the full frame or "
                                 "the bytes outside it changed")
        for name in ("rasterize", "grid", counter):
            if run[name] < 1:
                raise AssertionError(f"crop {label}: {name} was never launched")
        if label == "styled":
            launches = run
            graph_crops("paris-30k-styled", device, comp, PATHS["crop"])
        del r, full, buf, img

    # K3 with a tile-skip mask: a cached paris-30k frame after 1% of its
    # layers (300) moved by (3, 2) pixels.
    r = Renderer(device)
    cache = r.create_buffer_layer_cache()
    backing = np.zeros((h, w * 4), np.uint8)
    r.render_into(paris, Buffer(buffer=backing, layout=LinearLayout(w, w * 4, h),
                                layer_cache=cache), clear)
    orders = paris_orders(paris)
    moved = orders[1: 1 + max(1, len(orders) // 100)]  # layer 0 is the background
    paris.set_transforms(moved, np.tile(np.asarray([1, 0, 0, 1, 3, 2], np.float32),
                                        (len(moved), 1)))
    taps = {}
    frame, d = r._render_device_cached(paris, cache, w, h, clear, RGBA, taps=taps)
    args = taps["fold"]
    n_tiles = args[0].shape[0]
    fresh = Renderer(device).render(paris, w, h, clear)
    same = bool(np.array_equal(frame[:h, :w].cpu().numpy(), fresh))
    say("crop", frame="paris cached", moved_layers=len(moved), tiles=n_tiles,
        damaged_tiles=int(d[pipe.DIAG_DMG]), folded_tiles=int((args[1] > 0).sum()),
        diag=d.tolist(), cached_equals_fresh=same)
    out["fold_skip"] = check_fold("fold", args, frame="paris-cached")
    if not same or not 0 < int(d[pipe.DIAG_DMG]) < n_tiles:
        raise AssertionError("paris cached: the frame differs from a fresh render, or the "
                             "damage is not partial")
    return out, launches


def spaceship_phase(device) -> tuple:
    """Phase 16: the spaceship at 1920x1080 (`bench.py:104-151`) through the
    damage cache: SHIP_WARM warm-up frames, then SHIP_FRAMES synchronous
    `render_into` frames, each byte-equal to a fresh uncached render of the
    same state; an unchanged scene (no dispatch, no launch, nothing
    written); the same steps from a fresh ship with `pipelined=True` and
    `flush_pending()`, each buffer byte-equal to the synchronous buffer of
    one frame earlier; then K3 `fold` on a cached frame's own inputs
    against its plain version.  Returns (K3 numbers, launches of the
    synchronous run's render_into calls, results)."""
    import hashlib

    from forma_tpu_torch import RGBA, Buffer, Color, Composition, LinearLayout, Renderer
    from forma_tpu_torch.demos.spaceship import Spaceship
    from forma_tpu_torch.ops import pipeline as pipe

    w, h = PARIS_W, PARIS_H
    clear = Color(*SHIP_CLEAR)

    def setup():
        comp = Composition()
        ship = Spaceship(width=w, height=h)
        ship.build(comp)
        r = Renderer(device)
        backing = np.zeros((h, w * 4), np.uint8)
        buf = Buffer(buffer=backing, layout=LinearLayout(w, w * 4, h),
                     layer_cache=r.create_buffer_layer_cache())
        for _ in range(SHIP_WARM):
            ship.step()
            r.render_into(comp, buf, clear)
        return comp, ship, r, backing, buf

    def digest(a) -> str:
        return hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest()

    comp, ship, r, backing, buf = setup()
    fresh = Renderer(device)
    warm_regrows = r.regrow_count
    launches, sync_ms, dmg, nbytes, k_cached, k_fresh, digests, bad = {}, [], [], [], [], [], [], []
    for i in range(SHIP_FRAMES):
        ship.step()
        b0 = r.readback_bytes
        sync_ms.append(timed(lambda: count_launches(launches,
                                                    lambda: r.render_into(comp, buf, clear))))
        nbytes.append(r.readback_bytes - b0)
        dmg.append(int(r.last_diag[pipe.DIAG_DMG]))
        k_cached.append(int(r.last_diag[pipe.DIAG_K]))
        want = fresh.render(comp, w, h, clear)
        k_fresh.append(int(fresh.last_diag[pipe.DIAG_K]))
        if not np.array_equal(backing.reshape(h, w, 4), want):
            bad.append(i)
        digests.append(digest(backing))
    regrows = r.regrow_count - warm_regrows
    profile = frame_profile(lambda: (ship.step(), r.render_into(comp, buf, clear)), 10)

    # An unchanged scene: no dispatch, nothing written.
    noop = {}
    b0, before = r.readback_bytes, digest(backing)
    count_launches(noop, lambda: r.render_into(comp, buf, clear))
    noop_ok = (not any(noop.values()) and int(r.last_diag[pipe.DIAG_DMG]) == 0
               and r.readback_bytes == b0 and digest(backing) == before)

    # K3 on a cached frame's own inputs (its unchanged tiles skipped).
    ship.step()
    taps = {}
    r._render_device_cached(comp, buf.layer_cache, w, h, clear, RGBA, taps=taps)
    k3 = check_fold("fold", taps["fold"], frame="spaceship-cached")
    del taps, fresh

    comp, ship, rp, pbacking, pbuf = setup()
    piped_ms, piped_bad = [], []
    for i in range(SHIP_FRAMES):
        ship.step()
        piped_ms.append(timed(lambda: rp.render_into(comp, pbuf, clear, pipelined=True)))
        if i and digest(pbacking) != digests[i - 1]:
            piped_bad.append(i)
    flush_ms = timed(rp.flush_pending)
    if digest(pbacking) != digests[-1]:
        piped_bad.append(SHIP_FRAMES)
    res = {"sync_ms": statistics.median(sync_ms), "pipelined_ms": statistics.median(piped_ms),
           "damaged_tiles": statistics.median(dmg), "readback_bytes": statistics.median(nbytes)}
    say("spaceship", size=f"{w}x{h}", layers=len(comp.layers), frames=SHIP_FRAMES,
        warm_frames=SHIP_WARM, **spread("sync_ms", sync_ms), **spread("pipelined_ms", piped_ms),
        flush_ms=f"{flush_ms:.3f}",
        pipelined_ms_per_frame_with_flush=f"{(sum(piped_ms) + flush_ms) / SHIP_FRAMES:.3f}",
        damaged_tiles_median=statistics.median(dmg), damaged_tiles_max=max(dmg),
        tiles=(w // 16) * -(-h // 16), readback_bytes_median=statistics.median(nbytes),
        readback_bytes_max=max(nbytes), full_frame_bytes=w * h * 4,
        regrow_count=r.regrow_count, regrows_after_warmup=regrows,
        k_cached_median=statistics.median(k_cached), k_cached_max=max(k_cached),
        k_uncached_median=statistics.median(k_fresh), k_uncached_max=max(k_fresh),
        frames_differing_from_fresh=len(bad), pipelined_frames_differing=len(piped_bad),
        unchanged_scene_launches=sum(noop.values()), unchanged_scene_ok=noop_ok,
        launches=launches)
    say("spaceship", question="where a cached frame's time goes", **profile)
    if bad or piped_bad or not noop_ok:
        raise AssertionError(f"spaceship: frames {bad} differ from fresh renders, pipelined "
                             f"frames {piped_bad} from the synchronous stream, or the "
                             f"unchanged scene dispatched ({noop}, ok {noop_ok})")
    for name in ("rasterize", "grid", "fold"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"spaceship: {name} was never launched")
    return k3, launches, res


def frame_profile(step, frames: int) -> dict:
    """`host_profile` over `frames` calls of `step()`, as printed: wall ms
    a frame (fenced once at the end), device ms a frame (device-side
    events' self time), the device's busy share, kernel launches (or graph
    launches) and PyTorch ops a frame."""
    p = host_profile(step, frames)
    return {"wall_ms_per_frame": f"{p['wall_ms']:.3f}",
            "device_ms_per_frame": f"{p['device_ms']:.3f}",
            "device_busy_share": p["busy"] and f"{p['busy']:.3f}",
            "kernel_launches_per_frame": p["host_calls"].get("cudaLaunchKernel", 0.0),
            "graph_launches_per_frame": p["host_calls"].get("cudaGraphLaunch", 0.0),
            "aten_ops_per_frame": p["aten_ops"]}


def rotation(n: int, i: int) -> np.ndarray:
    """`bench.py:207-220`'s frame transform i for n layers: a rotation by
    0.0005 (i + 1) rad, scaled by 0.999."""
    a = 0.0005 * (i + 1)
    row = np.asarray([math.cos(a) * 0.999, math.sin(a) * 0.999, -math.sin(a) * 0.999,
                      math.cos(a) * 0.999, 0.0, 0.0], np.float32)
    return np.tile(row, (n, 1))


def zoom(n: int, s: float, w: int, h: int) -> np.ndarray:
    """A zoom by s about the frame's centre for n layers."""
    row = np.asarray([s, 0.0, 0.0, s, w / 2 * (1 - s), h / 2 * (1 - s)], np.float32)
    return np.tile(row, (n, 1))


def syncs_during(fn) -> dict:
    """Runs `fn()` under `torch.cuda.set_sync_debug_mode("warn")`; returns
    {call site: count} of the synchronising calls it made, each site the
    innermost three Python frames ("file:line < caller < caller")."""
    import traceback
    import warnings

    found = {}
    armed = []  # set once the mode is on: enabling it may sync once itself

    def record(message, category, filename, lineno, file=None, line=None):
        if not armed or "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not f.filename.endswith(os.path.join("", "warnings.py"))]
        site = " < ".join(f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"
                          for f in reversed(frames[-3:]))
        found[site] = found.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        armed.append(True)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return found


def animation_phase(device, paris) -> dict:
    """Phase 17: paris-30k at 1920x1080 (`paris`) and at 3840x2160, animated
    as `bench.py`'s animated configs: warm-up as `bench.py:222-235`, then
    ANIM_FRAMES frames with `render_device(check_caps=False)` under the
    sync debug mode (no synchronising call allowed), fenced once at the
    end, their diagnostics checked after the loop (no bucket overflowed);
    the same frames with `check_caps=True` (no regrow); at 3840x2160 the
    packed key (slot_bits > 0) and one frame against the plain path on the
    card; then a fresh renderer zooms by ZOOM_BY over ANIM_FRAMES frames
    after `announce_max_scale(ZOOM_BY)` with no regrow after its two
    warm-up frames.  Returns {size: results}."""
    from forma_tpu_torch import Color, Composition, Renderer
    from forma_tpu_torch.demos import scenes
    from forma_tpu_torch.ops import pipeline as pipe

    clear = Color(1.0, 1.0, 1.0, 1.0)
    out = {}
    for w, h in ((PARIS_W, PARIS_H), ANIM_4K):
        size = f"{w}x{h}"
        if w == PARIS_W:
            comp = paris
        else:
            t = time.perf_counter()
            comp = Composition()
            scenes.paris30k(comp, w, h)
            say("anim", size=size, scene_build_s=f"{time.perf_counter() - t:.1f}")
        orders = paris_orders(comp)
        n = len(orders)
        r = Renderer(device)
        t = time.perf_counter()
        r.render_device(comp, w, h, clear)
        comp.set_transforms(orders, rotation(n, ANIM_FRAMES - 1))
        r.render_device(comp, w, h, clear)
        comp.set_transforms(orders, rotation(n, 0))
        r.render_device(comp, w, h, clear)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
        warm = r.regrow_count
        caps = r._caps
        diags = []

        def loop():
            for i in range(ANIM_FRAMES):
                comp.set_transforms(orders, rotation(n, i))
                diags.append(r.render_device(comp, w, h, clear, check_caps=False)[1])

        t = time.perf_counter()
        syncs = syncs_during(loop)
        torch.cuda.synchronize()
        unchecked_ms = (time.perf_counter() - t) * 1e3 / ANIM_FRAMES
        d = torch.stack(diags).cpu().numpy()
        overflow = [i for i, di in enumerate(d) if not r._fits(di, caps)]
        t = time.perf_counter()
        for i in range(ANIM_FRAMES):
            comp.set_transforms(orders, rotation(n, i))
            frame, _ = r.render_device(comp, w, h, clear)
        torch.cuda.synchronize()
        checked_ms = (time.perf_counter() - t) * 1e3 / ANIM_FRAMES
        regrows = r.regrow_count - warm
        n_slots = r._styles_cache[0].orders.shape[0]
        rows, tiles_x = -(-h // 16), -(-w // 16)
        slot_bits = pipe.slot_bits_for(n_slots, rows, tiles_x)
        res = {"check_caps_false_ms": unchecked_ms, "check_caps_true_ms": checked_ms,
               "regrows": regrows, "syncs": syncs, "slot_bits": slot_bits}
        extra = {}
        if w != PARIS_W:
            img = frame[:h, :w].cpu().numpy()
            ref, _ = r.render_device(comp, w, h, clear, plain=True)
            diff = np.abs(img.astype(int) - ref[:h, :w].cpu().numpy().astype(int))
            extra = {"max_diff_vs_plain": int(diff.max()),
                     "differing_pixels_vs_plain": int((diff > 0).any(axis=-1).sum())}
            res.update(extra)
        say("anim", size=size, layers=n, frames=ANIM_FRAMES, warmup_s=f"{warm_s:.2f}",
            caps=tuple(caps), check_caps_false_ms_per_frame=f"{unchecked_ms:.3f}",
            check_caps_true_ms_per_frame=f"{checked_ms:.3f}",
            syncs_in_check_caps_false_loop=sum(syncs.values()), sync_sites=syncs,
            overflowed_frames=overflow, regrows_after_warmup=regrows,
            diag_last=d[-1].tolist(), slot_bits=slot_bits,
            key_bits=(rows + 1).bit_length() + max((tiles_x + 1).bit_length(), 1)
            + max((n_slots - 1).bit_length(), 1), **extra)
        if syncs or overflow or regrows:
            raise AssertionError(f"anim {size}: synchronising calls {syncs}, overflowed "
                                 f"frames {overflow} or {regrows} regrows after warm-up")
        if w != PARIS_W and (slot_bits == 0 or extra["max_diff_vs_plain"] > 1):
            raise AssertionError(f"anim {size}: slot_bits {slot_bits} or max diff vs plain "
                                 f"{extra['max_diff_vs_plain']} > 1")

        # The zoom: ZOOM_FROM -> ZOOM_FROM * ZOOM_BY after announce_max_scale.
        rz = Renderer(device)
        rz.announce_max_scale(ZOOM_BY)
        comp.set_transforms(orders, zoom(n, ZOOM_FROM, w, h))
        rz.render_device(comp, w, h, clear)
        # A half-pixel move flips the renderer to animating.
        comp.set_transforms(orders, zoom(n, ZOOM_FROM, w, h)
                            + np.asarray([0, 0, 0, 0, 0.5, 0.5], np.float32))
        rz.render_device(comp, w, h, clear)
        warm = rz.regrow_count
        zoom_ms = []
        for i in range(ANIM_FRAMES):
            s = ZOOM_FROM * (1 + (ZOOM_BY - 1) * i / (ANIM_FRAMES - 1))
            comp.set_transforms(orders, zoom(n, s, w, h))
            zoom_ms.append(timed(lambda: rz.render_device(comp, w, h, clear)))
        res["zoom_regrows"] = rz.regrow_count - warm
        say("anim", size=size, zoom=f"{ZOOM_FROM}->{ZOOM_FROM * ZOOM_BY:.2f}",
            announced=ZOOM_BY, frames=ANIM_FRAMES, warm_regrows=warm,
            regrows_after_warmup=res["zoom_regrows"], caps=tuple(rz._caps),
            diag_last=rz.last_diag.tolist(), **spread("frame_ms", zoom_ms))
        if res["zoom_regrows"]:
            raise AssertionError(f"anim {size}: the announced zoom regrew "
                                 f"{res['zoom_regrows']} times")
        out[size] = res
        del r, rz
        graph_anim(size, comp, orders, w, h, device)
        del comp
    return out


SVG_PANS = 3  # phase 18 (b)
# Phase 19: paris-30k in SHARDS shards, all on the one card, in turn; the
# kernels are checked on shard SHARD's own inputs.
SHARDS, SHARD = 4, 2
SHARD_LABEL = "4 shards in turn on one card"
SHARDED = {"rows": "render_device_sharded", "lines": "render_device_sharded_lines"}


def svg_phase(device, card: str, direct) -> tuple:
    """Phase 18: the SVG front end.  paris-30k as SVG text at 1920x1080,
    parsed and composed; K4, K2 and K3 on the parsed frame's inputs; the
    frame through the main path against the plain path and against
    `direct` (phase 5's frame of the directly built scene);
    `profile_frame`; pans through the damage cache; the SVG sample's
    `fold_styled` and frame, and circles, against the port's numpy
    oracle; the demo CLI on `gpu` and `oracle`.  Returns ({result key:
    numbers}, {path: launches}); the parsed frame's ms and `Timings` are
    under "frame_ms" and "timings"."""
    import tempfile

    from forma_tpu_torch import Buffer, Color, Composition, LinearLayout, Renderer
    from forma_tpu_torch.backend_numpy import render as oracle_render
    from forma_tpu_torch.demos import main as demo_main
    from forma_tpu_torch.demos import scenes
    from forma_tpu_torch.demos.svg import Svg
    from forma_tpu_torch.ops import grid_kernel as gk
    from forma_tpu_torch.ops import pipeline as pipe
    from forma_tpu_torch.ops import rasterize_kernel as rk
    from forma_tpu_torch.profiling import timings_line

    w, h = PARIS_W, PARIS_H
    clear = Color(1.0, 1.0, 1.0, 1.0)
    out, launches = {}, {}

    # (a) parse and render
    t = time.perf_counter()
    text = scenes.paris30k_svg_text(w, h)
    text_s = time.perf_counter() - t
    t = time.perf_counter()
    svg = Svg(text)
    parse_s = time.perf_counter() - t
    t = time.perf_counter()
    comp = Composition()
    svg.compose(comp)
    compose_s = time.perf_counter() - t
    say("svg", question="what the front end costs on the host", text_bytes=len(text),
        paths=text.count("<path"), layers=len(comp.layers), text_s=f"{text_s:.3f}",
        parse_s=f"{parse_s:.3f}", compose_s=f"{compose_s:.3f}")
    r = Renderer(device)
    taps = {}
    r.render_device(comp, w, h, clear, taps=taps)
    torch.cuda.synchronize()
    say("svg", caps=tuple(r._caps), features=str(taps["fold"][12]).replace(" ", ""))
    out["rasterize_svg"] = check_kernel("rasterize", rk.rasterize_blocks,
                                        rk.rasterize_blocks_torch, taps["rasterize"],
                                        frame="paris-svg")
    out["grid_svg"] = check_kernel("grid", gk.grid_build, gk.grid_build_torch, taps["grid"],
                                   frame="paris-svg")
    out["fold_svg"] = check_fold("fold", taps["fold"], frame="paris-svg")
    del taps
    ref, _ = r.render_device(comp, w, h, clear, plain=True)
    ref = ref[:h, :w].cpu().numpy()
    launches["svg"] = frame_path("svg", "svg", r, comp, (w, h), ref)
    frame_ms = [timed(lambda: r.render(comp, w, h, clear)) for _ in range(5)]
    img = r.render(comp, w, h, clear)
    diff = np.abs(img.astype(int) - direct.astype(int))
    say("svg", card=repr(card), **spread("frame_ms", frame_ms),
        max_diff_vs_direct=int(diff.max()),
        differing_pixels_vs_direct=int((diff > 0).any(axis=-1).sum()))
    out["frame_ms"] = statistics.median(frame_ms)
    if diff.max() > 3:
        raise AssertionError(f"svg: the parsed frame is {diff.max()}/255 from the direct "
                             "scene's (> 3)")

    # (d) profiling
    tm = r.profile_frame(comp, w, h, clear)
    stages = sum(tm[:7])
    say("svg", timings=repr(timings_line(tm)), card=repr(card),
        **{f: f"{v:.3f}" if isinstance(v, float) else v for f, v in tm._asdict().items()},
        stage_sum_ms=f"{stages:.3f}", diag_k=int(r.last_diag[pipe.DIAG_K]))
    out["timings"] = tm
    if (not all(math.isfinite(v) and v > 0 for v in tm[:9])
            or tm.k_active != int(r.last_diag[pipe.DIAG_K])
            or not 0.5 * tm.fused_frame <= stages <= 2.0 * tm.fused_frame):
        raise AssertionError(f"svg: incomplete Timings {tm}")

    # (b) pans through the damage cache
    backing = np.zeros((h, w * 4), np.uint8)
    buf = Buffer(buffer=backing, layout=LinearLayout(w, w * 4, h),
                 layer_cache=r.create_buffer_layer_cache())
    r.render_into(comp, buf, clear)
    version = comp.shared_segment_buffer().version
    fresh = Renderer(device)
    pans = []
    for i in range(1, SVG_PANS + 1):
        t = time.perf_counter()
        svg.compose(comp, pan_x=2.0 * i)
        pan_s = time.perf_counter() - t
        b0 = r.readback_bytes
        ms = timed(lambda: r.render_into(comp, buf, clear))
        same = np.array_equal(backing.reshape(h, w, 4), fresh.render(comp, w, h, clear))
        pans.append((pan_s, ms, int(r.last_diag[pipe.DIAG_DMG]), r.readback_bytes - b0, same))
        say("svg", pan=i, pan_x=2.0 * i, pan_host_s=f"{pan_s:.3f}", render_into_ms=f"{ms:.3f}",
            damaged_tiles=pans[-1][2], readback_bytes=pans[-1][3],
            version_kept=comp.shared_segment_buffer().version == version,
            equals_fresh=same)
    if comp.shared_segment_buffer().version != version or not all(p[4] for p in pans):
        raise AssertionError("svg pans: the segment buffer's version changed or a frame "
                             "differs from a fresh render")
    del r, fresh, buf, backing, comp, svg, text

    # (c) the SVG sample's styled fold, and frames against the oracle
    doc = Composition()
    Svg(scenes.SVG_SAMPLE).compose(doc)
    rd = Renderer(device)
    taps = {}
    rd.render_device(doc, 64, 64, clear, taps=taps)
    out["fold_styled_svg"] = check_fold("fold_styled", taps["fold"], frame="svg-sample")
    del taps
    launches["svgdoc"] = {}
    got = count_launches(launches["svgdoc"], lambda: rd.render(doc, 64, 64, clear))
    circles = Composition()
    scenes.circles(circles, 64, 256, 256)
    for label, comp, n, got in (
        ("svg-sample", doc, 64, got),
        ("circles-64", circles, 256, Renderer(device).render(circles, 256, 256, clear)),
    ):
        want = oracle_render(comp, n, n, clear_color=clear)
        d = int(np.abs(got.astype(int) - want.astype(int)).max())
        say("svg", frame=label, size=f"{n}x{n}", max_diff_vs_oracle=d)
        if d > 1:
            raise AssertionError(f"svg: {label} is {d}/255 from the numpy oracle (> 1)")
    for name in PATHS["svgdoc"]:
        if launches["svgdoc"].get(name, 0) < 1:
            raise AssertionError(f"svg-sample: {name} was never launched")

    # (e) the demo CLI in-process
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "paris-30k.svg")
        with open(path, "w") as f:
            f.write(scenes.paris30k_svg_text(w, h))
        cli = {}
        t = time.perf_counter()
        count_launches(cli, lambda: demo_main.main(
            ["gpu", "svg", path, "--width", str(w), "--height", str(h), "--frames", "3",
             "--timings", "--no-save"]))
        gpu_s = time.perf_counter() - t
    t = time.perf_counter()
    demo_main.main(["oracle", "circles", "16", "--width", "64", "--height", "64",
                    "--no-save"])
    say("svg", cli_gpu_svg_s=f"{gpu_s:.1f}", cli_gpu_launches=cli,
        cli_oracle_circles_s=f"{time.perf_counter() - t:.1f}")
    for name in PATHS["svg"]:
        if cli.get(name, 0) < 1:
            raise AssertionError(f"svg CLI: {name} was never launched")
    return out, launches


def envelope_phase(device, card: str) -> None:
    """Phase 20: paris-30k at paths=8000 at each of ENVELOPE_SIZES through
    `probes.envelope.measure_size` (cold and warm renders, both windows
    against the numpy oracle within 1/255); nothing is caught."""
    from forma_tpu_torch import Composition
    from forma_tpu_torch.demos import scenes
    from forma_tpu_torch.probes import envelope as ev

    for w, h in ENVELOPE_SIZES:
        torch.cuda.empty_cache()
        comp = Composition()
        t = time.perf_counter()
        scenes.paris30k(comp, w, h, paths=ev.PATHS)
        compose_s = time.perf_counter() - t
        row = ev.measure_size(comp, w, h, device)
        say("envelope", card=repr(card), compose_s=f"{compose_s:.1f}",
            **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in row.items()
               if k not in ("tensor_bytes", "stage_peaks")},
            **{f"bytes_{k}": v for k, v in row["tensor_bytes"].items()})
        say("envelope", size=row["size"], stage_peak_bytes=row["stage_peaks"])
        if (w, h) == ENVELOPE_SIZES[-1]:
            envelope_cache_frames(comp, w, h, device, card)
        del comp
    torch.cuda.empty_cache()
    envelope_limit(device, card)


def envelope_cache_frames(comp, w: int, h: int, device, card: str) -> None:
    """Phase 20 at its largest size, on one renderer: `render_device`, then
    two `render_into` frames of a full-frame buffer through the damage
    cache (`cache_ok` false, then true), each after ENVELOPE_MOVED layers
    from the middle of the scene moved, by (5, 3) and then (10, 6): the
    first move flips the renderer to animating, whose headroom may grow
    the buckets (a new key); the second frame replays the first's graph
    unless it regrew.  Each frame is held against the oracle's two far
    windows within 1/255 (re-emitted from the cache in the second); the
    damaged tiles, graphs live, captures, evictions, the shared pool's
    bytes, and the bytes reserved and at peak, printed."""
    from forma_tpu_torch import Buffer, LinearLayout, Renderer
    from forma_tpu_torch.ops import pipeline
    from forma_tpu_torch.probes import envelope as ev

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    wins = ev.windows(w, h)

    def diffs(img):  # img: a u8 [H, W, 4] tensor on the card or a numpy array
        out = []
        for x0, y0, ww, wh in wins:
            win = img[y0:y0 + wh, x0:x0 + ww]
            win = win.cpu().numpy() if isinstance(win, torch.Tensor) else win
            want = ev.oracle_window(comp, w, h, (x0, y0, ww, wh), ev.CLEAR)
            out.append(int(np.abs(win.astype(np.int32) - want.astype(np.int32)).max()))
        return out

    r = Renderer(device)
    frame, _ = r.render_device(comp, w, h, ev.CLEAR)
    got = {"render_device": diffs(frame)}
    del frame
    backing = np.zeros((h, w * 4), np.uint8)
    buf = Buffer(buffer=backing, layout=LinearLayout(w, w * 4, h),
                 layer_cache=r.create_buffer_layer_cache())
    captures, replays = [], r.graphs.replays
    orders = paris_orders(comp)
    moved = orders[len(orders) // 2:len(orders) // 2 + ENVELOPE_MOVED]
    for i in range(2):
        shift = np.asarray([1, 0, 0, 1, 5 * (i + 1), 3 * (i + 1)], np.float32)
        comp.set_transforms(moved, np.tile(shift, (len(moved), 1)))
        c, regrows = r.graphs.captures, r.regrow_count
        r.render_into(comp, buf, ev.CLEAR)
        captures.append(r.graphs.captures - c)
        got[f"render_into_{i}"] = diffs(backing.reshape(h, w, 4))
    replays = r.graphs.replays - replays
    regrew = r.regrow_count - regrows
    say("envelope", card=repr(card), size=f"{w}x{h}",
        then="render_device, then render_into twice on one renderer",
        layers_moved=len(moved), damaged_tiles=int(r.last_diag[pipeline.DIAG_DMG]),
        regrows_in_second=regrew,
        window_max_diff=got, graphs_live=len(r.graphs),
        captures_by_render_into=captures, replays_by_render_into=replays,
        evictions=r.graphs.evictions, graph_pool_bytes=r.graphs.pool_bytes(),
        reserved_bytes=torch.cuda.memory_reserved(device),
        peak_bytes=torch.cuda.max_memory_allocated(device))
    del r, buf, backing
    torch.cuda.empty_cache()
    if (max(max(v) for v in got.values()) > ev.TOLERANCE or (captures[1] and not regrew)
            or replays < 2):
        raise AssertionError(f"envelope {w}x{h}: cached frames differ from the oracle ({got}), "
                             f"or the second was not a replay of the first's graph "
                             f"({captures} captures, {replays} replays)")


def envelope_limit(device, card: str) -> None:
    """Phase 20's last step, at the format's limit (65536x32768): a renderer
    first renders tile rows ENVELOPE_SPAN of the frame (a graph at the
    frame's caps); the whole frame's capture, beside that graph, runs out
    of the card's memory, drops the graph (`evictions`), runs alone and
    runs out again (in its eager warm-up), and raises; the same renderer
    then renders the span again, equal to a fresh renderer's."""
    from forma_tpu_torch import Color, Composition, Renderer, consts
    from forma_tpu_torch.demos import scenes
    from forma_tpu_torch.probes import envelope as ev

    clear = Color(1.0, 1.0, 1.0, 1.0)
    w, h = consts.MAX_WIDTH, consts.MAX_HEIGHT
    comp = Composition()
    scenes.paris30k(comp, w, h, paths=ev.PATHS)
    r = Renderer(device)
    r.render_device(comp, w, h, clear, row_span=ENVELOPE_SPAN)
    try:
        r.render_device(comp, w, h, clear)
    except torch.cuda.OutOfMemoryError as e:
        error = f"{type(e).__name__}: {str(e)[:160]}"
    else:
        raise AssertionError(f"envelope: {w}x{h} rendered on one card")
    torch.cuda.empty_cache()
    captures, evictions, live = r.graphs.captures, r.graphs.evictions, len(r.graphs)
    got = r.render_device(comp, w, h, clear, row_span=ENVELOPE_SPAN)[0].cpu().numpy()
    want = Renderer(device).render_device(comp, w, h, clear, row_span=ENVELOPE_SPAN)[0]
    differing = int((got != want.cpu().numpy()).any(axis=-1).sum())
    recaptured = r.graphs.captures - captures
    say("envelope", card=repr(card), size=f"{w}x{h}", ok=False, error=repr(error),
        evictions=evictions, graphs_live_after_oom=live,
        then=f"tile rows {ENVELOPE_SPAN} of the frame again on the same renderer",
        differing_pixels_vs_fresh_renderer=differing, captures_after_oom=recaptured)
    del comp, r
    torch.cuda.empty_cache()
    if differing or not evictions or live or not recaptured:
        raise AssertionError("envelope: the capture beside a graph did not evict it, or the "
                             "renderer did not render after running out of memory at the "
                             "format's limit")


def fenced_ms(fn, n: int = 5) -> list:
    """Host milliseconds of each of n calls of `fn()`, each ended by
    `torch.cuda.synchronize()`, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def sharded_phase(device, card: str, paris) -> tuple:
    """Phase 19: paris-30k at 1920x1080 (`paris`, phase 5's composition) in
    SHARDS shards, all on `device` (SHARD_LABEL).  (a) The row-sharded and
    (b) the line-sharded frame: 0 pixels off `render_device`'s, the diag
    equal to the single frame's where the max (or, for DIAG_SEGS on the
    line path, the sum) over the shards keeps it, launch counters reset
    around a warm-up and 5 fenced frames, then K4, K2 and K3 `fold` on
    shard SHARD's own inputs against their plain versions; for (b) the
    exchange: the largest block against `xcap`, the most segments a shard
    received against the frame's segments inside its rows over SHARDS
    (the skew), the bytes the blocks hold a frame, the regrows.  (c) ms
    per fenced frame of (a), (b), the line path at one shard and
    `render_device`, with the peak memory of each, and `frame_profile`
    over 3 frames of `render_device` and of each sharded frame.  (d) 5
    line-sharded frames with `check_caps=False` under the sync debug mode
    (no synchronising call allowed), their diagnostics checked after the
    loop.  Returns ({result key: numbers}, {path: launches})."""
    from forma_tpu_torch import Color, Renderer
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.ops import grid_kernel as gk
    from forma_tpu_torch.ops import pipeline as pipe
    from forma_tpu_torch.ops import rasterize_kernel as rk

    w, h = PARIS_W, PARIS_H
    clear = Color(1.0, 1.0, 1.0, 1.0)
    devices = (device,) * SHARDS
    rows = -(-h // (16 * SHARDS))  # a shard's tile rows
    row_lo = SHARD * rows
    rs = Renderer(device)
    t1 = {}
    single, d1 = rs.render_device(paris, w, h, clear, taps=t1)
    single = single[:h, :w]
    # The segments inside the frame's rows: what the exchange moves.
    in_frame = int((rk.rasterize_blocks_torch(*t1["rasterize"])[0] != rk.PACKED_SENTINEL).sum())
    del t1
    out, launches, times, memory = {}, {}, {}, {}

    def measure(key, fn):
        """(c): fenced frames of `fn`, the peak memory above the baseline."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times[key] = fenced_ms(fn)
        memory[key] = torch.cuda.max_memory_allocated() - base

    renderers, frame_fns = {}, {"single": lambda: rs.render_device(paris, w, h, clear)}
    for path, method in SHARDED.items():
        r = renderers[path] = Renderer(device)
        call = getattr(r, method)
        frame_fns[path] = functools.partial(call, paris, w, h, clear, devices=devices)
        taps = {}
        frames, d = call(paris, w, h, clear, devices=devices, taps=taps)
        torch.cuda.synchronize()
        whole = torch.cat(frames)
        differing = int((whole[:h, :w] != single).any(-1).sum())
        kept = [pipe.DIAG_K, pipe.DIAG_SEGS, pipe.DIAG_DMG]
        if path == "rows":
            kept.append(pipe.DIAG_VLINES)  # every row shard sees every line
        say("sharded", path=path, shards=SHARDS, on=repr(SHARD_LABEL),
            frame_shape=tuple(whole.shape), differing_pixels_vs_single=differing,
            diag=d.tolist(), single_diag=d1.tolist(),
            caps=tuple(r._caps if path == "rows" else r._caps_lines),
            regrows=r.regrow_count)
        if differing or any(d[i] != d1[i] for i in kept):
            raise AssertionError(f"sharded {path}: {differing} pixels off render_device, or "
                                 f"diag {d.tolist()} against {d1.tolist()} at {kept}")
        args = taps[SHARD]
        want = (rows, row_lo) if path == "rows" else (rows * SHARDS, 0)
        got = (args["rasterize"][5], args["rasterize"][7])
        if got != want or args["fold"][15] != row_lo:
            raise AssertionError(f"sharded {path}: K4 (rows, row_lo) {got} against {want}, "
                                 f"K3 row_lo {args['fold'][15]} against {row_lo}")
        _build.reset_launches()
        measure(path, frame_fns[path])
        launches[path] = dict(_build.LAUNCHES)
        for name in PATHS[path]:
            if launches[path].get(name, 0) < SHARDS:
                raise AssertionError(f"sharded {path}: {name} launched "
                                     f"{launches[path].get(name, 0)} times")
        frame = f"paris-{path}-shard{SHARD}of{SHARDS}"
        out[f"rasterize_{path}"] = check_kernel(
            "rasterize", rk.rasterize_blocks, rk.rasterize_blocks_torch, args["rasterize"],
            frame=frame, rows=got[0], row_lo=got[1])
        out[f"grid_{path}"] = check_kernel("grid", gk.grid_build, gk.grid_build_torch,
                                           args["grid"], frame=frame)
        out[f"fold_{path}"] = check_fold("fold", args["fold"], frame=frame, row_lo=row_lo)
        if path == "lines":
            xcap = min(r._xcap, r._caps_lines.vline * pipe.K_SEG)
            ideal = in_frame / SHARDS
            say("sharded", path=path, xpair=int(d[pipe.DIAG_XPAIR]), xcap=xcap,
                in_frame_segments=in_frame, xrecv=int(d[pipe.DIAG_XRECV]),
                ideal_recv=f"{ideal:.1f}",
                skew=f"{d[pipe.DIAG_XRECV] / ideal:.4f}",
                exchange_bytes_per_frame=SHARDS ** 2 * xcap * 8, regrows=r.regrow_count)
        del taps, args, frames, whole

    # (c) the line path at one shard, and the single frame, in the same call
    r1 = Renderer(device)
    one, _ = r1.render_device_sharded_lines(paris, w, h, clear, devices=(device,))
    same = bool(torch.equal(one[0][:h, :w], single))
    measure("lines_n1", lambda: r1.render_device_sharded_lines(paris, w, h, clear,
                                                                devices=(device,)))
    measure("single", frame_fns["single"])
    say("sharded", question="what the sharded frames cost", on=repr(SHARD_LABEL),
        card=repr(card), lines_n1_equals_single=same,
        **{k: v for key, ms in times.items() for k, v in spread(f"{key}_ms", ms).items()},
        **{f"{key}_peak_memory": v for key, v in memory.items()},
        exchange_overhead_ms=f"{statistics.median(times['lines_n1']) - statistics.median(times['single']):.3f}")
    if not same:
        raise AssertionError("sharded lines at one shard: the frame differs from render_device")
    for key, fn in frame_fns.items():
        say("sharded", profile=key, on=repr(SHARD_LABEL), **frame_profile(fn, 3))

    # (d) no synchronising call with check_caps=False
    r = renderers["lines"]
    caps, xcap, diags = r._caps_lines, r._xcap, []

    def loop():
        for _ in range(5):
            diags.append(r.render_device_sharded_lines(paris, w, h, clear, devices=devices,
                                                       check_caps=False)[1])

    syncs = syncs_during(loop)
    torch.cuda.synchronize()
    dd = torch.stack(diags).cpu().numpy()
    overflow = [i for i, di in enumerate(dd)
                if not r._fits(di, caps) or di[pipe.DIAG_XPAIR] > xcap]
    say("sharded", path="lines", check_caps=False, frames=len(diags),
        syncs=sum(syncs.values()), sync_sites=syncs, overflowed_frames=overflow,
        diag_last=dd[-1].tolist())
    if syncs or overflow:
        raise AssertionError(f"sharded lines, check_caps=False: synchronising calls {syncs} "
                             f"or overflowed frames {overflow}")
    return out, launches


def distinct_cards(paris, card: str) -> None:
    """Phase 19 (e): on a machine with more than one card, paris-30k at
    1920x1080 (`paris`) in one shard per card (`devices=None`) through
    both sharded entry points: every shard's frame on its own card, the
    frames moved to card 0 0 pixels off `render_device`'s, the diag
    entries a max over shards keeps equal, every kernel of the path
    launched at least once a shard over a warm-up and 5 fenced frames
    (each fenced by a synchronize of every card), and ms per frame
    beside `render_device` on card 0.  With one card it says so and
    checks nothing."""
    from forma_tpu_torch import Color, Renderer
    from forma_tpu_torch.ops import _build
    from forma_tpu_torch.ops import pipeline as pipe

    n = torch.cuda.device_count()
    if n < 2:
        say("sharded", distinct_cards="skipped: this machine has one card")
        return
    w, h = PARIS_W, PARIS_H
    clear = Color(1.0, 1.0, 1.0, 1.0)
    label = f"{n} shards on {n} cards, one a card"

    def fenced(fn):
        def call():
            fn()
            for i in range(n):
                torch.cuda.synchronize(i)
        return fenced_ms(call)

    rs = Renderer("cuda:0")
    single, d1 = rs.render_device(paris, w, h, clear)
    single = single[:h, :w]
    times = {"single": fenced(lambda: rs.render_device(paris, w, h, clear))}
    for path, method in SHARDED.items():
        r = Renderer("cuda:0")
        call = functools.partial(getattr(r, method), paris, w, h, clear)
        frames, d = call()
        placed = [str(f.device) for f in frames]
        whole = torch.cat([f.to("cuda:0") for f in frames])
        differing = int((whole[:h, :w] != single).any(-1).sum())
        kept = [pipe.DIAG_K, pipe.DIAG_SEGS, pipe.DIAG_DMG]
        if path == "rows":
            kept.append(pipe.DIAG_VLINES)
        _build.reset_launches()
        times[path] = fenced(call)
        launches = dict(_build.LAUNCHES)
        say("sharded", path=path, on=repr(label), card=repr(card), shards_on=placed,
            differing_pixels_vs_single=differing, diag=d.tolist(), single_diag=d1.tolist(),
            launches={k: v for k, v in launches.items() if v},
            regrows=r.regrow_count, **spread(f"{path}_ms", times[path]),
            **spread("single_ms", times["single"]))
        if (placed != [f"cuda:{i}" for i in range(n)] or differing
                or any(d[i] != d1[i] for i in kept)
                or any(launches.get(k, 0) < 6 * n for k in PATHS[path])):
            raise AssertionError(
                f"sharded {path} on {n} cards: shards on {placed}, {differing} pixels off "
                f"render_device, diag {d.tolist()} against {d1.tolist()} at {kept}, "
                f"launches {launches}")
        del frames, whole


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
        kargs = row_lo_on_device("rasterize", args, build)
        fn = lambda: kern.rasterize_blocks(*kargs)  # noqa: E731
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


def probe_timing(roots) -> int:
    """`--probe-timing DIR [DIR ...]`: K8's six variants and K9's two modes
    on this checkout's inputs (the TPU tools' shapes) through the port of
    the checkout in each DIR in turn, each at that port's defaults and each
    output held bit-equal to this checkout's plain version; batched, sync
    and CUDA-graph ms and the wrapper's host microseconds, and each DIR's
    ptxas lines for both kernels; `index_add_` beside K9 once."""
    from forma_tpu_torch.probes import fold_ablate as k8
    from forma_tpu_torch.probes import grid_scatter as k9
    from forma_tpu_torch.probes import microbench as mb
    from forma_tpu_torch.probes import time_ms_graph

    device = torch.device("cuda", 0)
    u_mat, blkinfo = (t.to(device) for t in k8.paris_inputs())
    clear = torch.ones(4, dtype=torch.float32, device=device)
    want8 = {v: k8.fold_ablate_torch(u_mat, blkinfo, clear, v) for v in k8.VARIANTS}
    inputs9 = {m: tuple(t.to(device) for t in k9.scatter_inputs(m)) for m in k9.MODES}
    want9 = {m: k9.grid_scatter_torch(*a) for m, a in inputs9.items()}
    inputs7 = {"tool": mb.seg_inputs().to(device), "ragged": seg_edges().to(device)}
    want7 = {k: mb.seg_loop_torch(v) for k, v in inputs7.items()}
    say("probe-timing", card=repr(gpu_record()), units=k8.addressed_rows(blkinfo),
        segments=N_SCATTER)
    segs = inputs7["tool"]
    idx7, ones7 = segs.long(), torch.ones_like(segs)
    flat7 = torch.zeros(mb.BINS, dtype=torch.int32, device=device)
    lib7 = lambda: flat7.index_add_(0, idx7, ones7)  # noqa: E731
    say("probe-timing", kernel="seg_loop", library="index_add_",
        library_ms=f"{time_ms(lib7):.4f}", library_ms_graph=f"{time_ms_graph(lib7):.4f}",
        bincount_ms=f"{time_ms(lambda: torch.bincount(segs, minlength=mb.BINS)):.4f}",
        empty_kernel_ms_graph=f"{time_ms_graph(mb.launch_floor):.4f}")
    for mode, (row, cell, val) in inputs9.items():
        flat = torch.zeros(256 * 256, dtype=torch.int32, device=device)
        idx = row.long() * 256 + cell.long()
        lib = lambda: flat.index_add_(0, idx, val)  # noqa: E731
        say("probe-timing", kernel="grid_scatter", mode=mode, library="index_add_",
            library_ms=f"{time_ms(lib):.4f}", library_ms_graph=f"{time_ms_graph(lib):.4f}")
    ports = {}
    for root in map(os.path.abspath, roots):
        if root not in ports:
            ports[root] = import_port(root, "probes.fold_ablate", "probes.grid_scatter",
                                      "probes.microbench", "ops._build")
        p8, p9, p7, build = ports[root]
        runs = [("fold_ablate", v, lambda v=v: p8.fold_ablate(u_mat, blkinfo, clear, v),
                 want8[v]) for v in k8.VARIANTS]
        runs += [("grid_scatter", m, lambda a=a: p9.grid_scatter(*a), want9[m])
                 for m, a in inputs9.items()]
        runs += [("seg_loop", k, lambda v=v: p7.seg_loop(v), want7[k])
                 for k, v in inputs7.items()]
        for name, what, fn, want in runs:
            got = fn()
            again = fn()  # K7's counter row resets between calls
            torch.cuda.synchronize()
            err = max_abs_err((got, again), (want, want))
            say("probe-timing", port=root, kernel=name, case=what, max_abs_err=err,
                ms=f"{time_ms(fn):.4f}", ms_sync=f"{time_ms_sync(fn):.4f}",
                ms_graph=f"{time_ms_graph(fn):.4f}", host_us=f"{host_us(fn):.1f}")
            if err != 0.0:
                raise AssertionError(f"{root}: {name} {what} differs from the plain version "
                                     f"({err})")
        for needle in ("fold_ablate_kernel", "grid_scatter_kernel", "seg_"):
            say_ptxas(f"probe-timing {root}", build.library_path().parent / "nvcc.log", needle)
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
            ports[root] = import_port(root, "ops.fold_kernel", "ops._build")
        fold, build = ports[root][0].paint_fold, ports[root][1]
        # A port from before the fold took src_u reads the grid row at
        # src2_u: the same row on these table-mode inputs (src_u is src2_u).
        params = inspect.signature(fold).parameters
        # A port from before the fold took row_lo: these frames' row_lo is 0.
        fargs = args if "row_lo" in params else args[:15]
        fargs = fargs if "src_u" in params else fargs[:2] + fargs[3:]
        fargs = row_lo_on_device("fold", fargs, build)
        fn = lambda: fold(*fargs)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        err = max_abs_err((got,), (want,))
        say("fold-timing", port=root, scene=scene, max_abs_err=err,
            ms=f"{time_ms(fn):.4f}", ms_sync=f"{time_ms_sync(fn):.4f}",
            ms_graph=f"{time_ms_graph(fn):.4f}", host_us=f"{host_us(fn):.1f}")
        if err != 0.0:
            raise AssertionError(f"{root}: K3 differs from the plain version ({err})")
    return 0


# Phase 21: the compiled frame.  Each configuration runs beside the phase
# whose scene it reuses (paris-30k takes half a minute to build), and its
# row joins GRAPH_ROWS; the phase's summary prints them after phase 20.
GRAPH_REPEATS, GRAPH_FRAMES = 2, 5
GRAPH_ROWS = []
CARD = ""  # the card's name and power limit, set by main
HOST_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
              "cudaMemcpyAsync", "cudaMemsetAsync")
# Two more crop rectangles of phase 15's 30 tile rows (so the same key).
CROP_MORE = (((0, 30), (0, 50)), ((37, 67), (60, 120)))


def eager(r):
    """`r` with every frame run eagerly, op by op, as `taps=` runs one
    frame: phase 21's yardstick for frame sequences."""
    r._frame = lambda entry, args, kwargs, scalars: entry(*args, **kwargs, **scalars)
    return r


def host_profile(step, frames: int = 3) -> dict:
    """`torch.profiler` over `frames` calls of `step()`, fenced once at the
    end: the host's CUDA calls a frame by name (HOST_CALLS), the
    device-side events' self time a frame (a host op's own device time
    would count its kernels twice), the device's busy share of the wall
    time (None where the profiler recorded no device event) and PyTorch
    ops a frame."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / frames
    ka = prof.key_averages()
    calls = {k: sum(e.count for e in ka if e.key == k) / frames for k in HOST_CALLS}
    dev = sum(e.self_device_time_total for e in ka
              if str(e.device_type).endswith("CUDA")) / 1e3 / frames
    return {"host_calls": {k: v for k, v in calls.items() if v},
            "host_calls_total": sum(calls.values()), "device_ms": dev,
            "busy": dev / wall if dev else None, "wall_ms": wall,
            "aten_ops": sum(e.count for e in ka if e.key.startswith("aten::")) / frames}


def say_graphs(label: str, row: dict) -> None:
    """Phase 21's line for one configuration, graph beside eager."""
    def ms(mode):
        return {f"{mode}_ms_rep{i}": (f"{statistics.median(v):.3f}/{min(v):.3f}/{max(v):.3f}")
                for i, v in enumerate(row["times"][mode])}

    prof, cap = row["profile"], row["capture"]
    say("graphs", config=label, card=repr(CARD), differing_pixels=row["differing_pixels"],
        diag_equal=row["diag_equal"], launches_in_replay=row["launches"],
        graph_kernel_nodes=cap.kernel_nodes,
        **ms("graph"), **ms("eager"), ms_format="median/min/max",
        host_calls_graph=prof["graph"]["host_calls"], host_calls_eager=prof["eager"]["host_calls"],
        busy_graph=prof["graph"]["busy"] and f"{prof['graph']['busy']:.3f}",
        busy_eager=prof["eager"]["busy"] and f"{prof['eager']['busy']:.3f}",
        device_ms_graph=f"{prof['graph']['device_ms']:.3f}",
        device_ms_eager=f"{prof['eager']['device_ms']:.3f}",
        capture_warmup_s=f"{cap.warmup_s:.3f}", capture_s=f"{cap.capture_s:.3f}",
        pool_bytes=cap.pool_bytes, **row.get("extra", {}))


def graph_row(label: str, r, graph_step, eager_step, kernels, never=()) -> dict:
    """Phase 21 for one frame configuration on renderer `r`: a first graph
    frame (capturing the key if it is new); then one replay with the
    launch counters reset and read (each of `kernels` launched inside it,
    none of `never`, and the graph's own kernel nodes, `graph_witness`,
    equal to that replay's launches), held against one eager frame (0
    differing pixels, an equal diag); then GRAPH_REPEATS repeats of GRAPH_FRAMES graph frames
    and GRAPH_FRAMES eager frames, each timed on the host (a step ends on the
    host: synchronised); then the profiler over 3 frames of each; no
    capture after the first frame.  Each step returns (u8 frame, diag) as
    numpy."""
    from forma_tpu_torch.ops import _build

    graph_step()
    captures, replays = r.graphs.captures, r.graphs.replays
    cap = r.graphs.last_capture
    _build.reset_launches()
    got = graph_step()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    replayed = r.graphs.replays - replays
    want = eager_step()
    row = {"config": label, "launches": launches, "capture": cap,
           "differing_pixels": int((got[0] != want[0]).any(axis=-1).sum()),
           "diag_equal": bool(np.array_equal(got[1], want[1])),
           "times": {"graph": [], "eager": []}, "extra": {}}
    for _ in range(GRAPH_REPEATS):
        for mode, step in (("graph", graph_step), ("eager", eager_step)):
            row["times"][mode].append([timed(step) for _ in range(GRAPH_FRAMES)])
    row["profile"] = {mode: host_profile(step) for mode, step in
                      (("graph", graph_step), ("eager", eager_step))}
    row["extra"]["captures_after_first"] = r.graphs.captures - captures
    say_graphs(label, row)
    GRAPH_ROWS.append(row)
    missing = [k for k in kernels if launches.get(k, 0) < 1]
    graph_witness(f"graphs {label}", cap, kernels)
    if (row["differing_pixels"] or not row["diag_equal"] or missing or replayed != 1
            or any(launches.get(k) for k in never) or r.graphs.captures != captures):
        raise AssertionError(
            f"graphs {label}: {row['differing_pixels']} pixels differ, diag equal "
            f"{row['diag_equal']}, kernels {missing} not in the replay ({launches}), "
            f"{replayed} replays for one frame, or {r.graphs.captures - captures} captures "
            "after the first frame")
    return row


def frame_steps(r, comp, w, h, **kw) -> tuple:
    """(graph step, eager step) of one `render_device` frame of `comp` on
    `r` (eager: with `taps`), each returning (u8 frame, diag) as numpy."""
    from forma_tpu_torch import Color

    clear = Color(1.0, 1.0, 1.0, 1.0)

    def step(**extra):
        frame, d = r.render_device(comp, w, h, clear, **kw, **extra)
        return frame.cpu().numpy(), np.asarray(d)

    return step, lambda: step(taps={})


def graph_frame(label: str, r, comp, size, kernels, never=(), **kw) -> dict:
    """Phase 21 on one `render_device` frame configuration (`graph_row`)."""
    g, e = frame_steps(r, comp, *size, **kw)
    return graph_row(label, r, g, e, kernels, never)


def graph_crops(label: str, device, comp, kernels) -> None:
    """Phase 21 on phase 15's crop (tile rows CROP_ROWS x columns
    CROP_COLS) and the two rectangles of CROP_MORE, all 30 tile rows: the
    renderer first renders the whole frame (its buckets then hold every
    crop), and the three rectangles, each a `graph_row`, share one graph:
    one capture in all."""
    from forma_tpu_torch import Color, Renderer

    r = Renderer(device)
    r.render(comp, PARIS_W, PARIS_H, Color(1.0, 1.0, 1.0, 1.0))
    captures = r.graphs.captures
    for rows, cols in ((CROP_ROWS, CROP_COLS), *CROP_MORE):
        graph_frame(f"{label} crop rows[{rows[0]},{rows[1]}) cols[{cols[0]},{cols[1]})",
                    r, comp, (PARIS_W, PARIS_H), kernels, row_span=rows, crop_x=cols)
    n = r.graphs.captures - captures
    say("graphs", config=f"{label} crops", rectangles=1 + len(CROP_MORE), graphs_captured=n,
        graphs_live=len(r.graphs))
    if n != 1:
        raise AssertionError(f"graphs {label}: {n} graphs captured for the crop rectangles")


def graph_anim(size: str, comp, orders, w: int, h: int, device) -> dict:
    """Phase 21 on phase 17's animation at one size: a graph renderer and
    an eager one (`eager`) warm up as phase 17's does; then ANIM_FRAMES
    states, each rendered by both with `check_caps=False` under
    `torch.cuda.set_sync_debug_mode("error")` (a synchronising call
    raises), frames and diagnostics compared after the loop (0 differing
    pixels, equal diag), K4, K2 and K3 launched by the graph frames; then
    GRAPH_REPEATS repeats, each way, of ANIM_FRAMES frames each fenced and
    timed on the host (the host's work and the device's in turn), and of
    ANIM_FRAMES frames back to back fenced once at the end, as phase 17
    times them (the host's work overlapping the device's); the profiler
    over 3 back-to-back frames of each."""
    from forma_tpu_torch import Color, Renderer
    from forma_tpu_torch.ops import _build

    clear = Color(1.0, 1.0, 1.0, 1.0)
    n = len(orders)
    rg, re_ = Renderer(device), eager(Renderer(device))
    for r in (rg, re_):
        comp.set_transforms(orders, rotation(n, ANIM_FRAMES - 1))
        r.render_device(comp, w, h, clear)
        comp.set_transforms(orders, rotation(n, 0))
        r.render_device(comp, w, h, clear)
        r.render_device(comp, w, h, clear)
    captures = rg.graphs.captures
    cap = rg.graphs.last_capture
    got, want, launches = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(ANIM_FRAMES):
            comp.set_transforms(orders, rotation(n, i))
            got.append(count_launches(
                launches, lambda: rg.render_device(comp, w, h, clear, check_caps=False)))
            want.append(re_.render_device(comp, w, h, clear, check_caps=False))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    differing = sum(int((a[0] != b[0]).any(dim=-1).sum()) for a, b in zip(got, want))
    diag_equal = all(bool(torch.equal(a[1], b[1])) for a, b in zip(got, want))
    del got, want

    def frame(r, i, fence=True):
        comp.set_transforms(orders, rotation(n, i % ANIM_FRAMES))
        r.render_device(comp, w, h, clear, check_caps=False)
        if fence:
            torch.cuda.synchronize()

    def loop(r):
        for i in range(ANIM_FRAMES):
            frame(r, i, fence=False)
        torch.cuda.synchronize()

    row = {"config": f"animated paris-30k {size} check_caps=False", "launches": launches,
           "capture": cap, "differing_pixels": differing, "diag_equal": diag_equal,
           "times": {"graph": [], "eager": []},
           "extra": {"frames_under_sync_error_mode": ANIM_FRAMES}}
    for rep in range(GRAPH_REPEATS):
        for mode, r in (("graph", rg), ("eager", re_)):
            row["times"][mode].append([timed(lambda: frame(r, i)) for i in range(ANIM_FRAMES)])
            row["extra"][f"{mode}_back_to_back_ms_rep{rep}"] = (
                f"{timed(lambda: loop(r)) / ANIM_FRAMES:.3f}")
    it = iter(range(3 * ANIM_FRAMES))
    row["profile"] = {mode: host_profile(lambda: frame(r, next(it), fence=False)) for mode, r
                      in (("graph", rg), ("eager", re_))}
    row["extra"]["captures_after_warmup"] = rg.graphs.captures - captures
    say_graphs(row["config"], row)
    GRAPH_ROWS.append(row)
    missing = [k for k in PATHS["fused"] if launches.get(k, 0) < 1]
    graph_witness(f"graphs anim {size}", cap, PATHS["fused"])
    if differing or not diag_equal or missing or rg.graphs.captures != captures:
        raise AssertionError(f"graphs anim {size}: {differing} pixels differ, diag equal "
                             f"{diag_equal}, kernels {missing} never launched, or "
                             f"{rg.graphs.captures - captures} captures after the warm-up")
    return row


def graph_ship(device) -> None:
    """Phase 21 on phase 16's spaceship: for the synchronous and then the
    pipelined damage cache, GRAPH_REPEATS sequences of SHIP_FRAMES frames,
    each from fresh ships and renderers (SHIP_WARM warm-up frames), a
    graph renderer and an eager one (`eager`) stepping the same ship in
    lockstep: the host buffers byte-equal after every frame (and after
    `flush_pending`), each frame timed on the host, K4, K2 and K3 launched
    by the graph frames, no capture after the warm-up; the profiler over
    10 frames of each."""
    from forma_tpu_torch import Buffer, Color, Composition, LinearLayout, Renderer
    from forma_tpu_torch.demos.spaceship import Spaceship

    w, h = PARIS_W, PARIS_H
    clear = Color(*SHIP_CLEAR)

    def setup(graph: bool):
        comp = Composition()
        ship = Spaceship(width=w, height=h)
        ship.build(comp)
        r = Renderer(device) if graph else eager(Renderer(device))
        backing = np.zeros((h, w * 4), np.uint8)
        buf = Buffer(buffer=backing, layout=LinearLayout(w, w * 4, h),
                     layer_cache=r.create_buffer_layer_cache())
        for _ in range(SHIP_WARM):
            ship.step()
            r.render_into(comp, buf, clear)
        return comp, ship, r, backing, buf

    for pipelined in (False, True):
        label = f"spaceship {'pipelined' if pipelined else 'sync'} damage cache"
        times = {"graph": [], "eager": []}
        launches, bad, recaptured, cap = {}, [], 0, None
        for _ in range(GRAPH_REPEATS):
            g, e = setup(True), setup(False)
            captures = g[2].graphs.captures
            cap = g[2].graphs.last_capture
            tg, te = [], []
            for i in range(SHIP_FRAMES):
                for (comp, ship, r, _, buf), ts, count in ((g, tg, True), (e, te, False)):
                    ship.step()

                    def frame():
                        r.render_into(comp, buf, clear, pipelined=pipelined)
                    ts.append(timed(lambda: count_launches(launches, frame) if count
                                    else frame()))
                if not np.array_equal(g[3], e[3]):
                    bad.append(i)
            if pipelined:
                g[2].flush_pending()
                e[2].flush_pending()
                if not np.array_equal(g[3], e[3]):
                    bad.append(SHIP_FRAMES)
            recaptured += g[2].graphs.captures - captures
            times["graph"].append(tg)
            times["eager"].append(te)
        prof = {}
        for mode, (comp, ship, r, _, buf) in (("graph", g), ("eager", e)):
            prof[mode] = host_profile(lambda: (ship.step(), r.render_into(
                comp, buf, clear, pipelined=pipelined)), 10)
            r.flush_pending()
        row = {"config": label, "launches": launches, "capture": cap,
               "differing_pixels": len(bad), "diag_equal": True, "times": times,
               "profile": prof, "extra": {"frames": SHIP_FRAMES, "frames_differing": bad,
                                          "captures_after_warmup": recaptured}}
        say_graphs(label, row)
        GRAPH_ROWS.append(row)
        missing = [k for k in PATHS["spaceship"] if launches.get(k, 0) < 1]
        graph_witness(f"graphs {label}", cap, PATHS["spaceship"])
        if bad or missing or recaptured:
            raise AssertionError(f"graphs {label}: frames {bad} differ from the eager "
                                 f"sequence, kernels {missing} never launched, or "
                                 f"{recaptured} captures after the warm-up")


def graph_summary() -> None:
    """Phase 21's summary: one line a configuration (median ms of each
    mode's first repeat, host calls a frame, busy share)."""
    for row in GRAPH_ROWS:
        prof = row["profile"]
        say("graphs", summary=row["config"], card=repr(CARD),
            graph_ms=f"{statistics.median(row['times']['graph'][0]):.3f}",
            eager_ms=f"{statistics.median(row['times']['eager'][0]):.3f}",
            host_calls_graph=prof["graph"]["host_calls_total"],
            host_calls_eager=prof["eager"]["host_calls_total"],
            busy_graph=prof["graph"]["busy"] and f"{prof['graph']['busy']:.3f}",
            busy_eager=prof["eager"]["busy"] and f"{prof['eager']['busy']:.3f}",
            capture_s=f"{row['capture'].warmup_s + row['capture'].capture_s:.3f}",
            pool_bytes=row["capture"].pool_bytes,
            **{k: v for k, v in row["extra"].items() if "back_to_back" in k})


def graph_check(card: str) -> int:
    """`--graph-check`: phase 21's quick subset (paris-30k at 1920x1080 on
    both expand paths and its crops, the mixes, the styled mix forced
    two-key, the spaceship and the 1080p animation, graph against eager),
    then its summary and the card's line."""
    from forma_tpu_torch import Composition, Renderer
    from forma_tpu_torch.demos import scenes
    from forma_tpu_torch.ops import _build, pipeline

    t = time.perf_counter()
    _build.lib()
    say("build", seconds=f"{time.perf_counter() - t:.1f}")
    device = torch.device("cuda", 0)
    paris = Composition()
    scenes.paris30k(paris, PARIS_W, PARIS_H)
    for path in ("fused", "split"):
        graph_frame(f"paris-30k 1920x1080 {path}", Renderer(device, expand=path), paris,
                    (PARIS_W, PARIS_H), PATHS[path])
    graph_crops("paris-30k", device, paris, PATHS["fused"])
    mixes = {"mix": lambda c: scenes.styled_mix(c, 400, MIX_W, MIX_H),
             "texmix": lambda c: scenes.textured_mix(c, 300, MIX_W, MIX_H)}
    for label, build in mixes.items():
        comp = Composition()
        build(comp)
        graph_frame(f"{label} 512x512", Renderer(device), comp, (MIX_W, MIX_H), PATHS[label])
    real = pipeline.slot_bits_for
    pipeline.slot_bits_for = lambda *_: 0
    try:
        comp = Composition()
        mixes["mix"](comp)
        graph_frame("mix 512x512 (two-key forced)", Renderer(device), comp, (MIX_W, MIX_H),
                    ("expand", "grid", "fold_clip"), never=("rasterize",))
    finally:
        pipeline.slot_bits_for = real
    graph_ship(device)
    graph_anim(f"{PARIS_W}x{PARIS_H}", paris, paris_orders(paris), PARIS_W, PARIS_H, device)
    graph_summary()
    print(card)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fold-timing", metavar="DIR", nargs="+",
                    help="time K3 alone with the port of the checkout in each DIR")
    ap.add_argument("--raster-timing", metavar="DIR", nargs="+",
                    help="time K4 and the segment sort alone with the port of the "
                         "checkout in each DIR")
    ap.add_argument("--probe-timing", metavar="DIR", nargs="+",
                    help="time K8 and K9 alone with the port of the checkout in each DIR")
    ap.add_argument("--multi-card", action="store_true",
                    help="run only phase 19 (e), the sharded frames with one shard on "
                         "each card (needs two cards or more)")
    ap.add_argument("--graph-check", action="store_true",
                    help="run only phase 21's quick subset: paris-30k at 1920x1080 on "
                         "both paths, its crops, the mixes, the spaceship and the "
                         "1080p animation, graph against eager")
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
    if opts.probe_timing:
        return probe_timing(opts.probe_timing)
    from forma_tpu_torch import Color, Composition, Renderer
    from forma_tpu_torch.demos import scenes
    from forma_tpu_torch.ops import _build

    # 1. device record
    global CARD
    card = CARD = gpu_record()
    if opts.multi_card:
        if torch.cuda.device_count() < 2:
            print("chip_smoke: --multi-card needs two cards or more", file=sys.stderr)
            return 2
        paris = Composition()
        scenes.paris30k(paris, PARIS_W, PARIS_H)
        distinct_cards(paris, card)
        print(card)
        return 0
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

    # Every graph capture counts its kernel nodes (`graph_witness`).
    from forma_tpu_torch.graphs import FrameGraphs

    FrameGraphs.witness = True
    if opts.graph_check:
        return graph_check(card)

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
    for path, rr in renderers.items():  # 21. the compiled frame, each path
        graph_frame(f"paris-30k 1920x1080 {path}", rr, paris, (PARIS_W, PARIS_H), PATHS[path])
    direct = r.render(paris, PARIS_W, PARIS_H, clear)  # phase 18's reference
    del renderers, ref

    # 19. the multi-device frames, run here while paris is as phase 5 composed
    # it (phases 15 and 17 move its layers)
    sharded, sharded_launches = sharded_phase(device, card, paris)
    launches.update(sharded_launches)
    kres.update(sharded)
    distinct_cards(paris, card)

    # 6. paris-30k-styled; 7. the styled mix
    comps = {}
    kres["fold_styled"], launches["styled"], comps["styled"] = paris_variant(
        device, "styled", "fold_styled")
    kres["fold_clip"], launches["mix"] = mix_vs_cpu(
        device, "mix", lambda comp: scenes.styled_mix(comp, 400, MIX_W, MIX_H))

    # 8. paris-30k-textured; 9. the textured mix
    kres["fold_tex"], launches["textured"], comps["textured"] = paris_variant(
        device, "textured", "fold_tex")
    _, launches["texmix"] = mix_vs_cpu(
        device, "texmix", lambda comp: scenes.textured_mix(comp, 300, MIX_W, MIX_H))

    # 10. the two-key route
    wide, launches["wide"] = wide_key(device)
    kres.update(wide)
    say("wide", question="the two-key route's stages at 7680x4320", card=repr(card),
        **{k: f"{v:.4f}" for k, v in wide["stages_wide"].items()},
        k1_ms=f"{wide['expand_wide']['ms']:.4f}", k2_ms=f"{wide['grid_wide']['ms']:.4f}",
        k3_ms=f"{wide['fold_wide']['ms']:.4f}")

    # 11. K5
    kres["texture_probe"], launches["probe"] = texture_probe(device)
    say("k5", question="marginal cost of sampling textures in the fold",
        fold_tex_minus_fold_ms=f"{kres['fold_tex']['ms'] - kres['fold']['ms']:.4f}",
        fold_tex_ms=f"{kres['fold_tex']['ms']:.4f}", fold_ms=f"{kres['fold']['ms']:.4f}")

    # 12. K8; 13. K6 and K7; 14. K9
    kres["fold_ablate"], launches["ablate"] = fold_ablation(device, kres["fold"])
    micro, launches["micro"] = microbenchmarks(device)
    kres.update(micro)
    kres["grid_scatter"], launches["scatter"] = scatter_probe(
        device, k2_slots, k2_live, kres["grid"])

    # 15. crop; 16. the spaceship through the damage cache; 17. animation
    crop, launches["crop"] = crop_phase(device, comps, paris)
    kres.update(crop)
    del comps
    kres["fold_spaceship"], launches["spaceship"], ship = spaceship_phase(device)
    graph_ship(device)  # 21. the spaceship, graph against eager
    anim = animation_phase(device, paris)
    del paris

    # 18. the SVG front end
    svg, svg_launches = svg_phase(device, card, direct)
    launches.update(svg_launches)
    tm = svg.pop("timings")
    say("svg", question="what the parsed paris frame costs on the card", card=repr(card),
        frame_ms_median=f"{svg.pop('frame_ms'):.3f}", fused_frame_ms=f"{tm.fused_frame:.3f}",
        k_active=tm.k_active)
    kres.update(svg)
    del direct
    say("incremental", question="what the incremental paths cost on the card", card=repr(card),
        spaceship_sync_ms=f"{ship['sync_ms']:.3f}",
        spaceship_pipelined_ms=f"{ship['pipelined_ms']:.3f}",
        spaceship_damaged_tiles=ship["damaged_tiles"],
        spaceship_readback_bytes=ship["readback_bytes"],
        **{f"anim_{size}_{k}": (f"{v:.3f}" if isinstance(v, float) else v)
           for size, res in anim.items() for k, v in res.items() if k != "syncs"})

    # 20. the render-target envelope
    envelope_phase(device, card)

    # 21. the compiled frame: the rows taken beside phases 5-17
    graph_summary()

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[path][name], "frame": frame, **kres[key]}
        for name, src, rep, path, key, frame in KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
