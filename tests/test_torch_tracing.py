"""The port's own tracing (`forma_tpu_torch/tracing.py`) on the CPU, and the
benchmark's readers of it (`frame_bench/program.py`):

- with a `torch.profiler` session recording, `render`, a damage-cached
  `render_into` and a pipelined one emit the renderer's `forma.*` spans
  by name and in order, `forma.capture` only inside `forma.replay`
  (frames through the frame graphs, `torch_fixtures.cpu_graphs`), each a
  host operation (no user annotation, which the profiler would mirror on
  the device); with none recording no range is entered;
- the stage stamps: after N frames `stage_ms` has the seven stages of
  `profiling.Timings` (and `damage` on cached frames), each >= 0, and N
  frames; a no-dispatch cached frame, a `plain` frame and a sharded frame
  add none; `reset` zeroes the accumulator;
- a frame forced onto the two-key route stamps `expand`, `emit`,
  `key_sort` and `carry_sort` once and nothing under `rasterize_sort`, a
  packed frame none of the four, and on both routes the stages' ms sum to
  the frame's stamped span;
- `Renderer.readback_bytes` counts every pixel readback;
- the span and stage readers on a synthetic trace: self time, clipping
  to the traced window, and None where the program records nothing;
- the rotate cell's update: periodic, never scaling up.
"""

import json
import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import forma_tpu_torch as pt
from forma_tpu_torch import Renderer, Timings, tracing
from forma_tpu_torch.demos import scenes
from forma_tpu_torch.ops import pipeline
from frame_bench import program, run
from frame_bench.scenes import Scene
from frame_bench.trace import Trace
from frame_bench.updates import rotate
from torch_fixtures import cpu_graphs, no_reads, one_torch_thread  # noqa: F401 (fixtures)

W = H = 64
CLEAR = pt.Color(1.0, 1.0, 1.0, 1.0)
UNCACHED = list(Timings._fields[:7])
CACHED = UNCACHED + ["damage"]
TWO_KEY = ["expand", "emit", "key_sort", "carry_sort"]


SHIFT = [1.0, 0.0, 0.0, 1.0, 1.0, 0.0]


def _scene():
    comp = pt.Composition()
    scenes.circles(comp, 12, W, H)
    next(iter(comp.layers.values())).set_transform(SHIFT)
    return comp


def _move(comp, i):
    """Frame i's update: one layer's transform set again as it was (which
    changes nothing), another layer's colour changed (which damages its
    tiles without moving geometry, so the buckets hold)."""
    first, second = list(comp.layers.values())[:2]
    first.set_transform(SHIFT)
    second.set_props(pt.Props(func=pt.Func.Draw(pt.Style(
        fill=pt.Fill.Solid(pt.Color(0.1 * (i % 8), 0.2, 0.3, 1.0))))))


def _buffer(r, cache=True):
    backing = np.zeros((H, W * 4), np.uint8)
    b = pt.BufferBuilder(backing, pt.LinearLayout(W, W * 4, H))
    if cache:
        b = b.layer_cache(r.create_buffer_layer_cache())
    return b.build()


def _settled(comp):
    """A CPU renderer whose buckets already hold the scene: its first
    frame renders once (no regrow)."""
    r0 = Renderer("cpu")
    r0.render(comp, W, H, CLEAR)
    return Renderer("cpu", caps=r0._caps)


def _spans(prof):
    """The `forma.*` ranges of a profile, (name, start, end) by start."""
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("forma.")]
    assert all(not e.is_user_annotation() for e in events)
    return sorted(((e.name()[len("forma."):], e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events), key=lambda s: s[1])


def _frames(kind, r, comp):
    """Two frames of `kind` (the first captures its graph), then the
    completion of a pipelined stream."""
    if kind == "render":
        for _ in range(2):
            r.render(comp, W, H, CLEAR)
        return
    buf = _buffer(r)
    for i in range(2):
        _move(comp, i)
        r.render_into(comp, buf, CLEAR, pipelined=kind == "pipelined")
    r.flush_pending()


ORDER = {
    "render": ["inputs", "replay", "capture", "wait", "readback"]
    + ["inputs", "replay", "wait", "readback"],
    "cached": ["transforms", "inputs", "replay", "capture", "readback", "wait", "write_back"]
    + ["transforms", "inputs", "replay", "readback", "wait", "write_back"],
    "pipelined": ["transforms", "inputs", "replay", "capture", "readback"]
    + ["transforms", "inputs", "replay", "readback", "wait", "write_back"]
    + ["wait", "write_back"],
}


@pytest.mark.parametrize("kind", sorted(ORDER))
def test_spans_in_order(kind, cpu_graphs):  # noqa: F811 (the fixture)
    comp = _scene()
    r = cpu_graphs(_settled(comp))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(kind, r, comp)
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == ORDER[kind]
    assert set(n for n, _, _ in spans) <= set(tracing.SPANS)
    replays = [(s, e) for n, s, e in spans if n == "replay"]
    for n, s, e in spans:
        if n == "capture":
            assert any(rs <= s and e <= re for rs, re in replays)
    assert r.graphs.captures == 1 and r.regrow_count == 0


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    comp = _scene()
    r = Renderer("cpu")
    _frames("render", r, comp)
    _frames("cached", r, comp)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        r.render(comp, W, H, CLEAR)
    assert entered[:2] == ["forma.inputs", "forma.replay"]


def test_stage_stamps_count_frames():
    comp = _scene()
    r = Renderer("cpu")
    r.render(comp, W, H, CLEAR)  # settles the buckets
    tracing.reset("cpu")
    n = 3
    for _ in range(n):
        r.render(comp, W, H, CLEAR)
    ms = tracing.stage_ms("cpu")
    assert list(ms) == UNCACHED and tracing.STAGES[:7] == Timings._fields[:7]
    assert all(v >= 0.0 and math.isfinite(v) for v in ms.values())
    assert tracing.frames("cpu") == n
    # Frames that stamp nothing: the plain kernels, and the sharded frames.
    r.render_device(comp, W, H, CLEAR, plain=True)
    r.render_device_sharded(comp, W, H, CLEAR, n_shards=2, devices=["cpu"] * 2)
    assert tracing.frames("cpu") == n

    tracing.reset("cpu")
    assert tracing.frames("cpu") == 0 and tracing.stage_ms("cpu") == {}
    buf = _buffer(r)
    for i in range(n):
        _move(comp, i)
        r.render_into(comp, buf, CLEAR)
    ms = tracing.stage_ms("cpu")
    assert list(ms) == CACHED == list(tracing.STAGES[:8]) and min(ms.values()) >= 0.0
    assert tracing.frames("cpu") == n
    r.render_into(comp, buf, CLEAR)  # unchanged: no dispatch
    assert tracing.frames("cpu") == n


@pytest.mark.parametrize("route", ["packed", "two_key"])
def test_two_key_route_stamps_its_stages(route, monkeypatch):
    """On a host clock that advances by a different step at each read: a
    two-key frame (`slot_bits_for` giving 0, as `test_torch_widekey.py`
    forces it) stamps the route's four stages once, `rasterize_sort`
    never, and ends `runs` twice, around `carry_sort`, which `stage_ms`
    counts as one frame; a packed frame stamps none of the four.  The
    stages' mean ms sum to the frames' span from first stamp to last."""
    if route == "two_key":
        monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    comp = _scene()
    r = Renderer("cpu")
    r.render(comp, W, H, CLEAR)  # settles the buckets
    reads = []

    def clock():
        reads.append(1000 * len(reads) ** 2)
        return reads[-1]

    monkeypatch.setattr(tracing, "time", SimpleNamespace(perf_counter_ns=clock))
    tracing.reset("cpu")
    n = 3
    for _ in range(n):
        r.render(comp, W, H, CLEAR)
    assert tracing.frames("cpu") == n and len(reads) % n == 0
    acc = tracing.accumulator("cpu")
    stamps = dict(zip(tracing.STAGES, acc[len(tracing.STAGES):2 * len(tracing.STAGES)].tolist()))
    ms = tracing.stage_ms("cpu")
    if route == "two_key":
        assert [stamps[s] for s in TWO_KEY] == [n] * 4
        assert stamps["rasterize_sort"] == 0 and stamps["runs"] == 2 * n
        assert list(ms) == [s for s in UNCACHED if s != "rasterize_sort"] + TWO_KEY
    else:
        assert [stamps[s] for s in TWO_KEY] == [0] * 4 and stamps["runs"] == n
        assert list(ms) == UNCACHED
    per = len(reads) // n  # stamps a frame
    span = sum(reads[f * per + per - 1] - reads[f * per] for f in range(n))
    assert sum(ms.values()) * 1e6 * n == pytest.approx(span, rel=1e-12)
    for stage in TWO_KEY:  # the benchmark's readers of the route's stages
        assert run.load_metric(f"stage_{stage}_ms").read(None) == ms.get(stage, 0.0)


def test_stamps_read_nothing_back(no_reads):  # noqa: F811 (the fixture)
    """The stamps on the CPU, like the frame they mark, read no tensor on
    the host: they are captured into the graph on a card."""
    comp = _scene()
    r = Renderer("cpu")
    r.render(comp, W, H, CLEAR)
    before = tracing.frames("cpu")
    with no_reads():
        r.render_device(comp, W, H, CLEAR, check_caps=False)
    assert tracing.frames("cpu") == before + 1


@pytest.mark.parametrize("entry", ["render", "render_into", "render_into_crop"])
def test_readback_bytes_count_every_frame(entry):
    comp = _scene()
    r = Renderer("cpu")
    if entry == "render":
        r.render(comp, W, H, CLEAR)
        want = W * H * 4
    elif entry == "render_into":
        r.render_into(comp, _buffer(r, cache=False), CLEAR)
        want = W * H * 4
    else:
        crop = pt.Rect.new(range(16, 48), range(0, 32))
        r.render_into(comp, _buffer(r, cache=False), CLEAR, crop=crop)
        want = 32 * 32 * 4
    assert r.readback_bytes == want


def _ctx(host_ops, t0=100, t1=1100, frames=2):
    t = Trace(frames, t0=t0, t1=t1, host_ops=host_ops)
    return SimpleNamespace(trace=t)


NESTED = [
    ("forma.inputs", 50, 400),  # clipped to [100, 400)
    ("forma.replay", 200, 300),
    ("forma.capture", 220, 260),
    ("aten::add", 210, 215),  # not the program's span
    ("forma.wait", 400, 500),
    ("forma.readback", 1000, 1200),  # clipped to [1000, 1100)
    ("forma.transforms", 2000, 2100),  # outside the window
]


@pytest.mark.parametrize("metric,ns", [
    ("inputs_ms", 300 - 100), ("launch_ms", 100 - 40), ("wait_ms", 100),
    ("readback_ms", 100), ("write_back_ms", 0), ("transforms_ms", 0),
])
def test_span_readers(metric, ns):
    ctx = _ctx(NESTED)
    assert run.load_metric(metric).read(ctx) == pytest.approx(ns / 1e6 / 2)
    assert run.load_metric(metric).read(_ctx([("aten::add", 200, 300)])) is None
    assert run.load_metric(metric).read(SimpleNamespace(trace=None)) is None


def test_span_self_time_of_repeated_and_deep_spans():
    ops = [("forma.inputs", 100, 200), ("forma.replay", 120, 180), ("forma.capture", 130, 170),
           ("forma.inputs", 300, 400), ("forma.readback", 350, 360)]
    ctx = _ctx(ops, t0=0, t1=1000, frames=1)
    assert program.span_ms(ctx, "inputs") == pytest.approx((40 + 90) / 1e6)
    assert program.span_ms(ctx, "replay") == pytest.approx(20 / 1e6)
    assert program.span_ms(ctx, "capture") == pytest.approx(40 / 1e6)


def test_stage_readers(monkeypatch):
    comp = _scene()
    Renderer("cpu").render(comp, W, H, CLEAR)
    ms = tracing.stage_ms("cpu")
    for stage in UNCACHED:
        assert run.load_metric(f"stage_{stage}_ms").read(None) == ms[stage]
    monkeypatch.setitem(sys.modules, "forma_tpu_torch.tracing", None)
    for stage in tracing.STAGES:
        assert run.load_metric(f"stage_{stage}_ms").read(None) is None


def test_rotate_update_is_periodic_and_never_scales_up():
    mix = json.loads(open(run.HERE / "mixes" / "rotate.json").read())
    scene = Scene(1920, 1080, [("MLL", [0, 0, 4, 0, 0, 4])] * 3,
                  np.ones((3, 4), np.float32), np.zeros(3, bool), (1, 1, 1, 1))
    up = rotate.Update(mix, scene, {}, 7)
    period = mix["period_frames"]
    rows = [up.transforms(i) for i in range(2 * period)]
    for i in range(period):
        np.testing.assert_array_equal(rows[i], rows[i + period])
        assert rows[i].shape == (3, 6)
        t = pt.AffineTransform.from_array(rows[i][0].tolist())
        assert pt.GeomPresTransform.try_new(t) is not None
        assert t.ux * t.ux + t.uy * t.uy <= 1.0 and t.vx * t.vx + t.vy * t.vy <= 1.0
    # The centre stays put; the frames turn both ways.
    centre = rows[period // 4][0]
    assert centre[0] * 960 + centre[2] * 540 + centre[4] == pytest.approx(960, abs=1e-3)
    assert centre[1] * 960 + centre[3] * 540 + centre[5] == pytest.approx(540, abs=1e-3)
    angles = [math.atan2(r[0, 1], r[0, 0]) for r in rows[:period]]
    assert max(angles) == pytest.approx(mix["angle"], rel=1e-3)
    assert min(angles) == pytest.approx(-mix["angle"], rel=1e-3)
    comp = _scene()
    comp.set_transforms(np.arange(len(comp.layers)), np.tile(rows[period // 4][0], (12, 1)))
