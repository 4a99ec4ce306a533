"""The port's own tracing: host spans over the renderer's phases, and stage
stamps inside the frame.

Host spans.  `span(name)` opens a profiler range named `forma.<name>`
while a `torch.profiler` session records in this process, and otherwise
returns one shared no-op context, so that with no profiler a span costs
one check.  The ranges are on the profiler's clock, the one its device
activities use, so an idle gap on the device can be put down to the span
the host was in.  They are recorded as host operations
(`torch._C._profiler._RecordFunctionFast`), not as the user annotations of
`torch.profiler.record_function`: the profiler mirrors an annotation on the
device over the kernels launched inside it, and that mirror reads as device
activity where a trace does not drop it by kind.  The spans (`SPANS`),
which together cover a `render` or `render_into` call:

- `inputs`: a frame's host work before its replay: the pending pipelined
  frame completed, the composition compacted, the geometry, the capacity
  estimate, the style and geometry tables and their uploads, and a
  damage-cached frame's no-dispatch test and registry bookkeeping;
- `replay`: the frame graph's replay (`FrameGraphs.run`: the key, the
  inputs' copies, the launch, the outputs' clones), or the eager frame;
- `capture`: a graph's capture, inside `replay`;
- `wait`: the host blocked until the frame's diagnostics arrive;
- `readback`: pixels to the host (the damage-cached frame's pinned
  copies are issued here, and its damaged tiles past their prefix read);
- `write_back`: pixels into the caller's `Buffer`;
- `transforms`: `Layer.set_transform`, `Composition.set_transforms`.

Stage stamps.  A frame on a card is one CUDA graph replay, which the host
cannot fence inside, so `pipeline.render_frame` and
`render_frame_cached` stamp their own stage boundaries (`mark`): a
one-thread kernel (`csrc/stamp.cu`) reads the device's global timer and
adds the time since the previous stamp to the stage that just ended.
The stamps are launched while the frame is captured, so they are nodes of
every frame graph whether or not anyone reads them: no recapture, no host
call and no readback a frame.  Eager frames on a card (a capture's
warm-up, `taps`) are not stamped.  The time accumulates in one int64 tensor a
device (`accumulator`), allocated once, outside every graph pool, so that
the graphs keep its address; `stage_ms` reads it, `reset` zeroes it in
place.  The stages (`STAGES`) are `profiling.Timings`' and, on a
damage-cached frame, `damage`, the changed tiles' compaction after the
pack.  On the CPU every op has finished when it returns, so a stamp takes
the host's clock into the CPU's accumulator, eager or not.  The sharded
frames and the `plain` frames stamp nothing.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from .ops import _build

SPANS = ("inputs", "replay", "capture", "wait", "readback", "write_back", "transforms")
STAGES = ("line_setup", "rasterize_sort", "runs", "units", "cull", "paint", "srgb",
          "damage")
_N = len(STAGES)
# An accumulator: ns per stage [_N], stamps per stage [_N], frames, and the
# previous stamp's time.
_FRAMES, _PREV = 2 * _N, 2 * _N + 1

_OFF = contextlib.nullcontext()
_ACC = {}  # torch.device -> int64 [2 * _N + 2]


def span(name: str):
    """A `forma.<name>` profiler range while a profiler records, else a
    shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(f"forma.{name}")
    return _OFF


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def accumulator(device) -> torch.Tensor:
    """`device`'s stage accumulator, allocated (zeroed) at its first use.
    A frame graph holds its address, so it must not be first allocated
    inside a capture: `graphs.FrameGraphs` asks for it before recording."""
    d = _device(device)
    acc = _ACC.get(d)
    if acc is None:
        if d.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tracing.accumulator: first allocated inside a graph capture")
        acc = _ACC[d] = torch.zeros(2 * _N + 2, dtype=torch.int64, device=d)
    return acc


def mark(device, stage=None, last: bool = False) -> None:
    """A stage boundary of a frame on `device`, stamped in stream order:
    the time since the previous stamp is added to `stage` (a name of
    `STAGES`; None at the frame's first stamp, which only records);
    `last` also counts the frame."""
    acc = accumulator(device)
    i = -1 if stage is None else STAGES.index(stage)
    if acc.is_cuda:
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = _build.lib().forma_stage_stamp(acc.data_ptr(), i, _N, int(last), stream)
        if rc != 0:
            raise RuntimeError(f"forma_stage_stamp: CUDA error {rc}")
        return
    now = time.perf_counter_ns()
    if i >= 0:
        acc[i] += now - acc[_PREV]
        acc[_N + i] += 1
    acc[_PREV] = now
    if last:
        acc[_FRAMES] += 1


def no_mark(stage=None, last: bool = False) -> None:
    """A stamp that does nothing."""


def marker(device, on: bool = True):
    """`mark` bound to `device` where `on`, and on a card only while a
    graph is being captured; else a stamp that does nothing.  An eager
    frame on a card is not stamped: its stages last as long as the host
    takes to launch them, and its first run loads every kernel."""
    d = torch.device(device)
    if on and (d.type != "cuda" or torch.cuda.is_current_stream_capturing()):
        return functools.partial(mark, device)
    return no_mark


def frames(device) -> int:
    """Frames stamped on `device` since its last `reset`."""
    acc = _ACC.get(_device(device))
    return 0 if acc is None else int(acc[_FRAMES])


def stage_ms(device) -> dict:
    """{stage: mean ms a frame} on `device` over the frames stamped since
    its last `reset`, for each stage those frames ran (device time on a
    card, host time on the CPU); empty before any."""
    acc = _ACC.get(_device(device))
    if acc is None:
        return {}
    v = acc.tolist()
    return {s: v[i] / v[_N + i] / 1e6 for i, s in enumerate(STAGES) if v[_N + i]}


def reset(device) -> None:
    """Zeroes `device`'s accumulator in place (graphs keep its address)."""
    acc = _ACC.get(_device(device))
    if acc is not None:
        acc.zero_()
