"""Where the time of a paris-30k frame goes on the card, stage by stage.

    python -m forma_tpu_torch.profile_stages [--scene paris|styled|textured|svg] [--frames 3]
        [--width 1920] [--height 1080]

Renders paris-30k at `--width` x `--height`, 1920x1080 by default
(`--scene paris`, `demos.scenes.paris30k`, solid fills; `--scene styled`,
`demos.scenes.paris30k_styled`, gradient fills and Screen-blended roads;
`--scene textured`, `demos.scenes.paris30k_textured`, buildings filled
from a texture atlas; or `--scene svg`, paris-30k written as SVG text by
`demos.scenes.paris30k_svg_text` and parsed by `demos.svg.Svg`) through
`Renderer.render` and prints:

1. the unfenced frame time (host clock around `render`, which returns the
   frame on the host), median / min / max over `--frames` frames after
   one warm-up, for the graph frame (`render`: one replay of the frame's
   CUDA graph, `graphs.py`) and the eager frame (`render_device` with
   `taps`, op by op, then the same readback);
2. the graph frame's stage table, from the stage stamps the frame
   carries (`tracing.stage_ms`): mean device ms a stage over `--frames`
   graph frames, and their sum;
3. beside it, the fenced stage table, eager (a graph cannot be fenced
   inside): every pipeline stage wrapped in `torch.cuda.synchronize()`
   before and after, median ms over the frames; nested rows ("  of
   which") are inside the row above them;
4. `Renderer.profile_frame`'s `Timings`.

Where the frame's [row | slot | tx] key passes 31 bits (7680x4320, for
example), the frame takes the two-key route (K1, the two-key emit kernel,
the int64 two-key sort) in place of K4.

Needs a CUDA card; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from . import Color, Composition, Renderer, tracing
from .demos import scenes
from .demos.svg import Svg
from .ops import pipeline
from .profiling import STAGES, fenced_stages, timings_line


def _parsed_paris(comp, width, height):
    Svg(scenes.paris30k_svg_text(width, height)).compose(comp)


CLEAR = Color(1.0, 1.0, 1.0, 1.0)
SCENES = {"paris": scenes.paris30k, "styled": scenes.paris30k_styled,
          "textured": scenes.paris30k_textured, "svg": _parsed_paris}


def _render_eager(r, comp, size):
    """`render`'s frame, eagerly: `taps` keep it out of its graph."""
    w, h = size
    frame, _ = r.render_device(comp, w, h, CLEAR, taps={})
    return frame[:h, :w].cpu().numpy()


def _frames(r, comp, n, size, eager=False):
    times = []
    for _ in range(n):
        t = time.perf_counter()
        if eager:
            _render_eager(r, comp, size)
        else:
            r.render(comp, *size, CLEAR)
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _stage_table(r, comp, n, size):
    with fenced_stages(r.device) as (acc, _):
        frames = _frames(r, comp, n, size, eager=True)
    total = statistics.median(frames)
    print(f"  fenced frame: {total:.2f} ms (median of {n})")
    top = 0.0
    for _, _, label, depth, _ in STAGES:
        if acc[label]:
            ms = statistics.median(acc[label])
            top += ms if depth == 0 else 0.0
            print(f"  {'  of which ' if depth else ''}{label}: {ms:.2f} ms")
    print(f"  renderer host work, diag sync and frame readback: {total - top:.2f} ms")


def _graph_stage_table(r, comp, n, size):
    """The graph frames' stages, from their stage stamps."""
    tracing.reset(r.device)
    frames = _frames(r, comp, n, size)
    ms = tracing.stage_ms(r.device)
    print(f"  graph frame, stage stamps: {tracing.frames(r.device)} frames, unfenced "
          f"median {statistics.median(frames):.2f} ms")
    for stage, v in ms.items():
        print(f"  {stage}: {v:.3f} ms")
    print(f"  the stages' sum: {sum(ms.values()):.3f} ms")


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
          + (" (the two-key route)" if slot_bits == 0 else ""))
    r = Renderer()
    _frames(r, comp, 1, size)  # warm-up: grows the buckets, captures the graph
    for eager in (False, True):
        frames = _frames(r, comp, args.frames, size, eager)
        print(f"{'eager' if eager else 'graph'} frames: unfenced "
              f"median {statistics.median(frames):.2f} ms (min {min(frames):.2f}, "
              f"max {max(frames):.2f}, {args.frames} frames), diag "
              f"{r.last_diag.tolist()}, peak memory "
              f"{torch.cuda.max_memory_allocated()} bytes")
    cap = r.graphs.last_capture
    print(f"  graph: capture {cap.warmup_s:.3f} s warm-up + {cap.capture_s:.3f} s "
          f"recording, pool {cap.pool_bytes} bytes")
    _graph_stage_table(r, comp, args.frames, size)
    _stage_table(r, comp, args.frames, size)
    print(f"  Renderer.profile_frame: {timings_line(r.profile_frame(comp, *size, CLEAR))}")


if __name__ == "__main__":
    main()
