"""Where the time of a paris-30k frame goes on the card, stage by stage.

    python -m forma_tpu_torch.profile_stages [--scene paris|styled|textured|svg] [--frames 3]
        [--width 1920] [--height 1080]

Renders paris-30k at `--width` x `--height`, 1920x1080 by default
(`--scene paris`, `demos.scenes.paris30k`, solid fills; `--scene styled`,
`demos.scenes.paris30k_styled`, gradient fills and Screen-blended roads;
`--scene textured`, `demos.scenes.paris30k_textured`, buildings filled
from a texture atlas; or `--scene svg`, paris-30k written as SVG text by
`demos.scenes.paris30k_svg_text` and parsed by `demos.svg.Svg`) through
`Renderer.render` on each expand path ("fused" and "split") and prints,
per path:

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

import torch

from . import Color, Composition, Renderer
from .demos import scenes
from .demos.svg import Svg
from .ops import pipeline, rasterize
from .profiling import STAGES, fenced_stages, timings_line


def _parsed_paris(comp, width, height):
    Svg(scenes.paris30k_svg_text(width, height)).compose(comp)


CLEAR = Color(1.0, 1.0, 1.0, 1.0)
SCENES = {"paris": scenes.paris30k, "styled": scenes.paris30k_styled,
          "textured": scenes.paris30k_textured, "svg": _parsed_paris}


def _frames(r, comp, n, size):
    times = []
    for _ in range(n):
        t = time.perf_counter()
        r.render(comp, *size, CLEAR)
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _stage_table(r, comp, n, size):
    with fenced_stages(r.device) as (acc, _):
        frames = _frames(r, comp, n, size)
    total = statistics.median(frames)
    print(f"  fenced frame: {total:.2f} ms (median of {n})")
    top = 0.0
    for _, _, label, depth, _ in STAGES:
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
        print(f"  Renderer.profile_frame: {timings_line(r.profile_frame(comp, *size, CLEAR))}")
        _device_profile(r, comp, size)


if __name__ == "__main__":
    main()
