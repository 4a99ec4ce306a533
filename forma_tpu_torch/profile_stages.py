"""Where the time of a paris-30k frame goes on the card, stage by stage.

    python -m forma_tpu_torch.profile_stages [--scene paris|styled|textured] [--frames 3]
        [--width 1920] [--height 1080]

Renders paris-30k at `--width` x `--height`, 1920x1080 by default
(`--scene paris`, `demos.scenes.paris30k`, solid fills; `--scene styled`,
`demos.scenes.paris30k_styled`, gradient fills and Screen-blended roads;
or `--scene textured`, `demos.scenes.paris30k_textured`, buildings filled
from a texture atlas) through `Renderer.render` on each expand path
("fused" and "split") and prints, per path:

1. the unfenced frame time (host clock around `render`, which returns the
   frame on the host), median / min / max over `--frames` frames after
   one warm-up;
2. the fenced stage table: every pipeline stage wrapped in
   `torch.cuda.synchronize()` before and after, median ms over the frames;
   nested rows ("  of which") are inside the row above them;
3. `torch.profiler` over 2 frames: the device time of all device-side
   events, the device's busy share of the frames' wall time, and the
   events and host ops that take the most device time.

Where the frame's [row | slot | tx] key passes 31 bits (7680x4320, for
example), both expand paths take the two-key route (K1, the emit in
PyTorch, the int64 two-key sort), so it is profiled once.

Needs a CUDA card; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import statistics
import time
from collections import defaultdict

import torch

from . import Color, Composition, Renderer
from .demos import scenes
from .ops import fold_kernel, pipeline, rasterize, runs

SCENES = {"paris": scenes.paris30k, "styled": scenes.paris30k_styled,
          "textured": scenes.paris30k_textured}
# (module, attribute, row label, nesting depth) in frame order.
STAGES = (
    (pipeline._ls, "line_setup", "line_setup", 0),
    (pipeline._raster, "rasterize_sort", "rasterize_sort (expand, emit, sort, unpack)", 0),
    (rasterize, "rasterize_blocks", "K4 rasterize_blocks (fused expand + emit)", 1),
    (rasterize, "expand_params", "K1 expand_params", 1),
    (rasterize, "_emit_packed", "ff64 emit in PyTorch", 1),
    (rasterize, "_emit_two_key", "ff64 two-key emit in PyTorch", 1),
    (rasterize, "sort_two_key", "two-key int64 sort", 1),
    (pipeline._runs, "extract_runs", "extract_runs", 0),
    (pipeline._runs, "run_data", "run_data", 0),
    (runs, "grid_build", "K2 grid_build", 1),
    (pipeline._runs, "build_units", "build_units", 0),
    (pipeline._paint, "cull_units_keep", "cull_units_keep", 0),
    (pipeline._paint, "_renumber_units", "_renumber_units", 0),
    (pipeline._paint, "paint", "paint", 0),
    (fold_kernel, "paint_fold", "K3 paint_fold", 1),
    (pipeline._srgb, "pack_srgb", "pack_srgb", 0),
)


def _fenced(fn, times):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return out

    return wrapper


def _frames(r, comp, n, size):
    clear = Color(1.0, 1.0, 1.0, 1.0)
    times = []
    for _ in range(n):
        t = time.perf_counter()
        r.render(comp, *size, clear)
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _stage_table(r, comp, n, size):
    acc = defaultdict(list)
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in STAGES]
    try:
        for (mod, attr, fn), (_, _, label, _) in zip(saved, STAGES):
            setattr(mod, attr, _fenced(fn, acc[label]))
        frames = _frames(r, comp, n, size)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    total = statistics.median(frames)
    print(f"  fenced frame: {total:.2f} ms (median of {n})")
    top = 0.0
    for _, _, label, depth in STAGES:
        if acc[label]:
            ms = statistics.median(acc[label])
            top += ms if depth == 0 else 0.0
            print(f"  {'  of which ' if depth else ''}{label}: {ms:.2f} ms")
    print(f"  renderer host work, diag sync and frame readback: {total - top:.2f} ms")


def _device_profile(r, comp, size):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _frames(r, comp, 2, size)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Device-side events (kernels, copies, memsets) only: a host op's self
    # device time repeats the time of the kernels it launched.
    busy = sum(dev_us(e) for e in avgs if str(e.device_type).endswith("CUDA")) / 1e3
    print(f"  profiler, 2 frames: self device time {busy:.2f} ms of {wall:.2f} ms wall "
          f"(device busy {100 * busy / wall:.1f}%)")
    for e in sorted(avgs, key=dev_us, reverse=True)[:10]:
        print(f"    {dev_us(e) / 1e3:8.3f} ms  {e.count:5d} calls  {e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="paris")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)
    size = (args.width, args.height)
    comp = Composition()
    SCENES[args.scene](comp, *size)
    slot_bits = pipeline.slot_bits_for(
        len(comp.layers), -(-args.height // 16), -(-args.width // 16))
    print(f"card: {torch.cuda.get_device_name(0)}; scene: {args.scene} at "
          f"{args.width}x{args.height}; slot_bits {slot_bits}"
          + (" (the two-key route on every expand path)" if slot_bits == 0 else ""))
    paths = rasterize.EXPAND_PATHS if slot_bits else rasterize.EXPAND_PATHS[:1]
    for expand in paths:
        r = Renderer(expand=expand)
        _frames(r, comp, 1, size)  # warm-up: grows the capacity buckets
        frames = _frames(r, comp, args.frames, size)
        print(f"expand={expand}: unfenced frame median {statistics.median(frames):.2f} ms "
              f"(min {min(frames):.2f}, max {max(frames):.2f}, {args.frames} frames), "
              f"diag {r.last_diag.tolist()}, peak memory "
              f"{torch.cuda.max_memory_allocated()} bytes")
        _stage_table(r, comp, args.frames, size)
        _device_profile(r, comp, size)


if __name__ == "__main__":
    main()
