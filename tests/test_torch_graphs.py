"""The compiled frame (`forma_tpu_torch.graphs`) on the CPU: what a CUDA
graph of a frame needs, held without a card.

- The frame reads nothing back: with `Tensor.item`, `tolist`, `numpy`,
  `cpu`, `__bool__`, `__int__`, `__float__` and `__index__` made to
  raise, `pipeline.render_frame` and `render_frame_cached` (`cache_ok`
  true and false) run on circles-64, the styled mix (clips), the textured
  mix, a forced two-key frame and a cropped frame: the precondition of a
  capture, since a graph cannot hand a value to the host mid-frame.  The
  one read allowed is the plain fold's depth (`paint_fold_torch`, which a
  CPU frame runs and no graph does: graph frames launch K3).
- `row_lo` and the crop bounds as int32 0-d tensors (as a graph's static
  scalars pass them) give frames and diagnostics bit-equal to the int
  form, and JAX's cropped frames within 1/255 (`test_torch_crop.py`'s
  cases, through the renderer with its scalars made tensors).
- The key: equal across crop values, row spans and `cache_ok`; different
  across caps, features, channels, expand, input shapes and a crop given
  or not; the bound, and the eviction of superseded caps.
- The shared pool: one pool for a renderer's graphs, a warm-up only for a
  capture into an empty set; a frame out of memory beside other graphs
  drops them all and runs alone, alone it raises, and a failed first
  capture leaves no pool behind.
- The witness: kernel nodes counted in a graph's DOT print.
- A graph's static inputs: a changed input is copied in, the same tensor
  unmodified is not, an in-place change is; scalars fill.
- Launch counts through a capture (taken back) and replays (added).
- A CPU renderer builds no graph.
"""

import numpy as np
import pytest
import torch

import forma_tpu
import forma_tpu_torch
from forma_tpu_torch import Color, Composition, Renderer
from forma_tpu_torch.buffer import RGBA, Buffer, LinearLayout
from forma_tpu_torch.demos import scenes
from forma_tpu_torch.graphs import BOUND, FrameGraphs, _Graph, kernel_nodes
from forma_tpu_torch.ops import _build, fold_kernel, pipeline
from test_torch_crop import SCENES, _max_diff, _renderer

CLEAR = Color(1.0, 1.0, 1.0, 1.0)
READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
         "__index__")


def _circles(comp):
    scenes.circles(comp, 64, 64, 64)


def _styled_mix(comp):
    scenes.styled_mix(comp, 24, 64, 64)


def _textured_mix(comp):
    scenes.textured_mix(comp, 24, 64, 64)


FRAME_SCENES = {"circles64": _circles, "styled_mix": _styled_mix,
                "textured_mix": _textured_mix}


def _inputs(build, w=64, h=64):
    """(renderer, pipeline inputs, host style tables, channels) of a scene
    after one render has settled the buckets."""
    comp = Composition()
    build(comp)
    r = Renderer("cpu")
    r.render(comp, w, h, CLEAR)
    inputs, st_host, chans = r._whole_frame_inputs(comp, w, h, CLEAR, RGBA)
    return r, inputs, st_host, chans


class ReadBack(AssertionError):
    pass


@pytest.fixture
def no_reads(monkeypatch):
    """While the returned context is open, every way of reading a tensor's
    value on the host raises `ReadBack`, except one read in each call of
    the plain fold (`paint_fold_torch`: its depth)."""
    import contextlib

    allowed = [0]
    real_fold = fold_kernel.paint_fold_torch

    def plain_fold(*a, **k):
        allowed[0] = 1
        try:
            return real_fold(*a, **k)
        finally:
            allowed[0] = 0

    @contextlib.contextmanager
    def armed():
        with monkeypatch.context() as m:
            for name in READS:
                real = getattr(torch.Tensor, name)

                def read(self, *a, _name=name, _real=real, **k):
                    if allowed[0]:
                        allowed[0] -= 1
                        return _real(self, *a, **k)
                    raise ReadBack(f"Tensor.{_name} inside the frame")
                m.setattr(torch.Tensor, name, read)
            m.setattr(fold_kernel, "paint_fold_torch", plain_fold)
            yield

    return armed


def _run_both(r, inputs, st_host, chans, w, h, **crop):
    """render_frame, then render_frame_cached with cache_ok false and true
    (the second on the first's frame and counts)."""
    rows, tiles_x = -(-h // 16), -(-w // 16)
    statics = (w, h, rows, tiles_x, r._caps, st_host.features, chans)
    row_lo = crop.get("row_lo", 0)
    rows_f = crop.get("rows", rows)
    frame, diag = pipeline.render_frame(
        *inputs, w, h, rows_f, tiles_x, *statics[4:], row_lo=row_lo,
        crop_x=crop.get("crop_x"))
    unch = torch.ones(st_host.orders.shape[0], dtype=torch.bool)
    prev = torch.zeros((rows * 16, tiles_x * 16, len(chans)), dtype=torch.uint8)
    counts = torch.full((rows * tiles_x,), -1, dtype=torch.int32)
    out = []
    for ok in (False, True):
        f, d, counts, dmg = pipeline.render_frame_cached(
            *inputs, prev, counts, unch, ok, *statics,
            crop_x=crop.get("crop_x"), crop_y=crop.get("crop_y"))
        prev = f
        out.append((f, d, counts, dmg))
    return (frame, diag), out


@pytest.mark.parametrize("name", sorted(FRAME_SCENES))
def test_frame_reads_nothing_back(name, no_reads):
    r, inputs, st_host, chans = _inputs(FRAME_SCENES[name])
    with no_reads():
        (frame, diag), cached = _run_both(r, inputs, st_host, chans, 64, 64)
    assert frame.shape == (64, 64, 4) and diag.shape == (6,)
    assert all(c[0].shape == (64, 64, 4) for c in cached)


def test_two_key_frame_reads_nothing_back(no_reads, monkeypatch):
    monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    r, inputs, st_host, chans = _inputs(_styled_mix)
    with no_reads():
        (frame, _), cached = _run_both(r, inputs, st_host, chans, 64, 64)
    want = Renderer("cpu")
    monkeypatch.undo()
    comp = Composition()
    _styled_mix(comp)
    np.testing.assert_array_equal(frame.numpy(), want.render(comp, 64, 64, CLEAR))


def _scalar(v):
    return torch.tensor(v, dtype=torch.int32)


def test_cropped_frame_reads_nothing_back(no_reads):
    r, inputs, st_host, chans = _inputs(_textured_mix)
    crop = dict(row_lo=_scalar(1), rows=2, crop_x=(_scalar(1), _scalar(3)),
                crop_y=(_scalar(1), _scalar(3)))
    with no_reads():
        (frame, _), cached = _run_both(r, inputs, st_host, chans, 64, 64, **crop)
    assert frame.shape == (32, 64, 4)


@pytest.mark.parametrize("name", ["gradient", "texture"])
def test_device_scalars_equal_int_form(name):
    """Tile rows [2, 5), tile columns [1, 3) as ints and as int32 0-d
    tensors: frames and diagnostics bit-equal, on render_frame and on both
    cached frames (crop_x and crop_y)."""
    build, w, h = SCENES[name]
    r = Renderer("cpu")
    comp = build(forma_tpu_torch)
    r.render(comp, w, h, CLEAR)
    inputs, st_host, chans = r._whole_frame_inputs(comp, w, h, CLEAR, RGBA)
    ints = dict(row_lo=2, rows=3, crop_x=(1, 3), crop_y=(2, 5))
    tens = dict(row_lo=_scalar(2), rows=3, crop_x=(_scalar(1), _scalar(3)),
                crop_y=(_scalar(2), _scalar(5)))
    a, ac = _run_both(r, inputs, st_host, chans, w, h, **ints)
    b, bc = _run_both(r, inputs, st_host, chans, w, h, **tens)
    for x, y in zip([*a, *[t for c in ac for t in c[:3]], *[c[3][1] for c in ac]],
                    [*b, *[t for c in bc for t in c[:3]], *[c[3][1] for c in bc]]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _tensor_scalars(r, monkeypatch):
    """Makes `r`'s frames pass their row span and crop bounds as int32 0-d
    tensors, as a graph's static scalars do."""
    real = r._frame

    def frame(entry, args, kwargs, scalars):
        def conv(v):
            if v is None:
                return None
            return tuple(map(_scalar, v)) if isinstance(v, tuple) else _scalar(v)
        return real(entry, args, kwargs, {k: conv(v) for k, v in scalars.items()})

    monkeypatch.setattr(r, "_frame", frame)


@pytest.mark.parametrize("name", ["gradient", "texture"])
def test_tensor_scalar_crops_match_jax(name, monkeypatch):
    """`test_torch_crop.py`'s crop away from row 0 (tile rows [2, 5), tile
    columns [1, 3)) with the scalars as tensors: JAX's cropped frame within
    1/255, the int form bit for bit; and the damage-cached crop the same."""
    build, w, h = SCENES[name]
    crop = (range(16, 48), range(32, 80))
    jax_got = _renderer(forma_tpu).render(
        build(forma_tpu), w, h, forma_tpu.Color(1.0, 1.0, 1.0, 1.0),
        crop=forma_tpu.Rect.new(*crop))
    comp = build(forma_tpu_torch)
    rect = forma_tpu_torch.Rect.new(*crop)
    want = Renderer("cpu").render(comp, w, h, CLEAR, crop=rect)
    r = Renderer("cpu")
    _tensor_scalars(r, monkeypatch)
    got = r.render(comp, w, h, CLEAR, crop=rect)
    np.testing.assert_array_equal(got, want)
    assert _max_diff(got, jax_got) <= 1

    bufs = []
    for rr in (Renderer("cpu"), r):
        buf = np.zeros((h, w * 4), np.uint8)
        b = Buffer(buffer=buf, layout=LinearLayout(w, w * 4, h))
        b.layer_cache = rr.create_buffer_layer_cache()
        rr.render_into(comp, b, CLEAR)
        rr.render_into(comp, b, CLEAR, crop=rect)
        bufs.append(buf)
    np.testing.assert_array_equal(bufs[0], bufs[1])


def _key_args(caps=pipeline.Caps(), features=None, chans=(0, 1, 2, 3), expand="fused",
              n_lines=10, crop_x=None, row_lo=0):
    features = features or pipeline.Features()
    px = torch.zeros(n_lines + 1)
    st = {"orders": torch.zeros(4, dtype=torch.int64), "color": torch.zeros(4, 4)}
    args = (px, px, torch.zeros(n_lines, dtype=torch.int32), st, torch.zeros(4),
            64, 64, 4, 4, caps, features, chans)
    return args, dict(expand=expand, plain=False, taps=None), dict(row_lo=row_lo,
                                                                    crop_x=crop_x)


def _key(**kw):
    return FrameGraphs("cuda").key(pipeline.render_frame, *_key_args(**kw))[0]


def test_key_ignores_scalar_values():
    assert _key(row_lo=0) == _key(row_lo=7)
    assert _key(crop_x=(0, 2)) == _key(crop_x=(1, 4))
    fg = FrameGraphs("cuda")
    args, kw, sc = _key_args()
    keys = {fg.key(pipeline.render_frame_cached, args, kw, dict(sc, cache_ok=ok))[0]
            for ok in (False, True)}
    assert len(keys) == 1


@pytest.mark.parametrize("change", [
    dict(caps=pipeline.Caps(vline=1024)),
    dict(features=pipeline.Features(has_gradient=True)),
    dict(features=pipeline.Features(blend_modes=(0, 3))),
    dict(chans=(2, 1, 0, 3)),
    dict(expand="split"),
    dict(n_lines=11),
    dict(crop_x=(0, 2)),
])
def test_key_changes_with_statics_and_shapes(change):
    assert _key(**change) != _key()


def test_key_changes_with_entry_point_and_dtype():
    fg = FrameGraphs("cuda")
    args, kw, sc = _key_args()
    base = fg.key(pipeline.render_frame, args, kw, sc)[0]
    assert fg.key(pipeline.render_frame_cached, args, kw, sc)[0] != base
    st = dict(args[3], orders=args[3]["orders"].int())
    assert fg.key(pipeline.render_frame, (*args[:3], st, *args[4:]), kw, sc)[0] != base


class _Fake:
    def __init__(self, caps):
        self.caps = caps


def test_bound_and_caps_eviction():
    fg = FrameGraphs("cuda")
    small, big = pipeline.Caps(), pipeline.Caps(run=1024)
    for i in range(BOUND + 3):
        fg._make_room(small)
        fg._graphs[i] = _Fake(small)
        assert len(fg) <= BOUND
    assert list(fg._graphs) == list(range(3, BOUND + 3))  # least recently used out
    fg._make_room(big)  # a capture at grown caps drops every graph of the old ones
    assert len(fg) == 0


def test_static_inputs_copy_only_what_changed():
    a, b = torch.arange(4.0), torch.zeros(3, dtype=torch.int32)
    g = _Graph(pipeline.Caps(), [a, 5, b], {"row_lo": 0, "crop_x": (0, 1)}, "cpu")
    assert g.leaves[0] is not a and torch.equal(g.leaves[0], a)
    g.load([a, 5, b], {"row_lo": 3, "crop_x": (2, 4)})
    assert int(g.scalars["row_lo"]) == 3
    assert [int(t) for t in g.scalars["crop_x"]] == [2, 4]
    static = g.leaves[0]
    static.fill_(-1)  # a stale buffer shows whether a copy happened
    g.load([a, 5, b], {"row_lo": 3, "crop_x": (2, 4)})
    assert (static == -1).all()  # the same tensor, unmodified: no copy
    a.add_(1)  # in place: its version moves
    g.load([a, 5, b], {"row_lo": 3, "crop_x": (2, 4)})
    assert torch.equal(static, a)
    c = a.clone()
    static.fill_(-1)
    g.load([c, 5, b], {"row_lo": 3, "crop_x": (2, 4)})
    assert torch.equal(static, c)  # another tensor: copied


def test_launch_counts_through_capture_and_replays():
    _build.reset_launches()
    _build.LAUNCHES["grid"] += 1  # an eager launch before
    with _build.capturing() as grew:
        _build.LAUNCHES["rasterize"] += 1
        _build.LAUNCHES["fold_clip"] += 2
    assert grew == {"rasterize": 1, "fold_clip": 2}
    assert _build.LAUNCHES["rasterize"] == 0 and _build.LAUNCHES["grid"] == 1
    for _ in range(3):
        _build.replayed(grew)
    assert _build.LAUNCHES["rasterize"] == 3 and _build.LAUNCHES["fold_clip"] == 6
    _build.reset_launches()


def test_cpu_renderer_builds_no_graph(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU renderer reached the graph path")

    monkeypatch.setattr(FrameGraphs, "run", boom)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", boom)
    comp = Composition()
    _circles(comp)
    r = Renderer("cpu")
    img = r.render(comp, 64, 64, CLEAR)
    r.render_device(comp, 64, 64, CLEAR, check_caps=False)
    buf = np.zeros((64, 256), np.uint8)
    b = Buffer(buffer=buf, layout=LinearLayout(64, 256, 64))
    b.layer_cache = r.create_buffer_layer_cache()
    r.render_into(comp, b, CLEAR)
    np.testing.assert_array_equal(buf.reshape(64, 64, 4), img)
    assert len(r.graphs) == 0 and r.graphs.captures == 0


class _Replayer:
    """A stand-in for a captured graph on the CPU: a replay runs the frame
    again on the graph's static inputs and writes each result into the
    static output tensors in place, as a replay overwrites them."""

    def __init__(self, g, fn, spec):
        self.g, self.fn, self.spec = g, fn, spec

    def replay(self):
        fresh = self.g.call(self.fn, self.spec)
        for dst, src in zip(torch.utils._pytree.tree_leaves(self.g.out),
                            torch.utils._pytree.tree_leaves(fresh)):
            dst.copy_(src)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """`FrameGraphs` driven on the CPU: the CUDA calls of a capture become
    no-ops and each graph a `_Replayer`.  Returns a function that routes a
    CPU renderer's frames through its graphs; its `calls` counts the pools
    made (`graph_pool_handle`), the warm-ups (`stream`) and the
    recordings (`graph`, with the pool of each)."""
    import contextlib

    calls = {"pools": 0, "warmups": 0, "recorded_in": []}

    class _Null:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, *a):
            pass

    @contextlib.contextmanager
    def null_ctx(*a, **k):
        yield

    @contextlib.contextmanager
    def warmup(*a, **k):
        calls["warmups"] += 1
        yield

    @contextlib.contextmanager
    def graph(g, pool=None, **k):
        calls["recorded_in"].append(pool)
        yield

    def pool_handle():
        calls["pools"] += 1
        return ("pool", calls["pools"])

    for name, value in (("device", null_ctx), ("stream", warmup), ("graph", graph),
                        ("graph_pool_handle", pool_handle),
                        ("Stream", _Null), ("CUDAGraph", _Null),
                        ("current_stream", lambda *a: _Null()),
                        ("synchronize", lambda *a: None), ("empty_cache", lambda: None),
                        ("memory_reserved", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, value)
    real = FrameGraphs._record

    def record(self, fn, leaves, spec, *a):
        g = real(self, fn, leaves, spec, *a)
        g.graph = _Replayer(g, fn, spec)
        return g

    monkeypatch.setattr(FrameGraphs, "_record", record)

    def route(r):
        monkeypatch.setattr(r, "_frame", lambda entry, args, kwargs, scalars:
                            r.graphs.run(entry, args, kwargs, scalars, r._caps))
        return r

    route.calls = calls
    return route


def test_graph_frames_equal_eager_frames(cpu_graphs):
    """The graph machinery end to end on the CPU: whole frames, three crop
    rectangles of one key (one capture), and the damage cache synchronous
    and pipelined over a moving scene, each equal to an eager renderer's;
    outputs handed out are clones, so later replays leave them alone."""
    build, w, h = SCENES["gradient"]
    comp = build(forma_tpu_torch)
    want, r = Renderer("cpu"), cpu_graphs(Renderer("cpu"))
    first = r.render(comp, w, h, CLEAR)
    np.testing.assert_array_equal(first, want.render(comp, w, h, CLEAR))
    frame, _ = r.render_device(comp, w, h, CLEAR)
    kept = frame.clone()
    captures = r.graphs.captures
    for rows, cols in (((2, 5), (1, 3)), ((0, 3), (0, 4)), ((3, 6), (2, 4))):
        got, gd = r.render_device(comp, w, h, CLEAR, row_span=rows, crop_x=cols)
        ref, rd = want.render_device(comp, w, h, CLEAR, row_span=rows, crop_x=cols)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        np.testing.assert_array_equal(gd, rd)
    assert r.graphs.captures - captures == 1
    assert torch.equal(frame, kept)  # a returned frame is the caller's own

    orders = np.asarray([o.as_u32() for o in comp.layers], np.uint32)
    for pipelined in (False, True):
        bufs = []
        for rr in (want, r):
            buf = np.zeros((h, w * 4), np.uint8)
            b = Buffer(buffer=buf, layout=LinearLayout(w, w * 4, h),
                       layer_cache=rr.create_buffer_layer_cache())
            seq = []
            for i in range(4):
                comp.set_transforms(orders[2:], np.tile(np.asarray(
                    [1, 0, 0, 1, 3 * i, 2 * i], np.float32), (len(orders) - 2, 1)))
                rr.render_into(comp, b, CLEAR, pipelined=pipelined)
                seq.append(buf.copy())
            rr.flush_pending()
            seq.append(buf.copy())
            bufs.append(seq)
        for a, b in zip(*bufs):
            np.testing.assert_array_equal(a, b)
    assert r.graphs.replays > r.graphs.captures > 0


def test_graphs_share_one_pool(cpu_graphs):
    """A renderer's graphs record into one pool; only the capture into an
    empty set warms up; a capture at grown caps, which drops every graph,
    starts a new pool (the old one is freed with its last graph)."""
    build, w, h = SCENES["gradient"]
    comp = build(forma_tpu_torch)
    r = cpu_graphs(Renderer("cpu"))
    calls = cpu_graphs.calls
    r.render(comp, w, h, CLEAR)
    captures = r.graphs.captures
    r.render_device(comp, w, h, CLEAR, row_span=(2, 5), crop_x=(1, 3))
    r.render_device(comp, w, h, CLEAR, row_span=(0, 3))
    assert r.graphs.captures - captures == 2 and len(r.graphs) == 3
    assert len(set(calls["recorded_in"][-3:])) == 1 and None not in calls["recorded_in"]
    pools, warmups = calls["pools"], calls["warmups"]
    assert r.graphs.last_capture.warmup_s == 0
    r._caps = r._caps._replace(run=r._caps.run * 2)
    r.render(comp, w, h, CLEAR)
    assert len(r.graphs) == 1 and r.graphs.evictions == 0  # superseded, not evicted
    assert calls["pools"] == pools + 1 and calls["warmups"] == warmups + 1
    assert calls["recorded_in"][-1] != calls["recorded_in"][-2]


def test_out_of_memory_beside_other_graphs_runs_alone(cpu_graphs, monkeypatch):
    """A capture that runs out of memory beside another graph drops it and
    captures again alone (a new pool, a warm-up), and the frame equals
    the eager one; out of memory alone raises, leaves no graph and no
    pool, and the renderer renders on."""
    build, w, h = SCENES["gradient"]
    comp = build(forma_tpu_torch)
    r = cpu_graphs(Renderer("cpu"))
    calls = cpu_graphs.calls
    r.render(comp, w, h, CLEAR)
    real = FrameGraphs._record
    fail = {"beside": True, "alone": False}

    def record(self, fn, leaves, spec, scalars, caps, warm_up):
        if fail["alone" if warm_up else "beside"]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stand-in)")
        return real(self, fn, leaves, spec, scalars, caps, warm_up)

    monkeypatch.setattr(FrameGraphs, "_record", record)
    pools, warmups = calls["pools"], calls["warmups"]
    got, _ = r.render_device(comp, w, h, CLEAR, row_span=(2, 5))
    want, _ = Renderer("cpu").render_device(comp, w, h, CLEAR, row_span=(2, 5))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(r.graphs) == 1 and r.graphs.evictions == 1
    assert calls["pools"] == pools + 1 and calls["warmups"] == warmups + 1

    fail["alone"] = True  # a new key (4 rows), beside the 3-row graph
    with pytest.raises(torch.cuda.OutOfMemoryError):
        r.render_device(comp, w, h, CLEAR, row_span=(0, 4))
    assert len(r.graphs) == 0 and r.graphs._pool is None
    fail["alone"] = fail["beside"] = False
    np.testing.assert_array_equal(r.render(comp, w, h, CLEAR),
                                  Renderer("cpu").render(comp, w, h, CLEAR))
    assert len(r.graphs) == 1


DOT_SAMPLE = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 6) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_13AUnaryFunctorIfffNS0_15binary_internal10MulFunctorIfEEEESt5arrayIPcLm2EEEEviT0_T1_\<\<\<1,128,0\>\>\>}
| {{node handle | func handle} | {0x0000000009FB5F70 | 0x0000000009C96FC0}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_1_node_280"[style="bold" shape="record" label="{KERNEL
| {ID | 280 (topoId: 411) | _ZN45_GLOBAL__N__7121a0e2_12_rasterize_cu_6883330416rasterize_kernelEPKjPKlS3_lliiiPKiiiPjS6_\<\<\<100,256,0\>\>\>}
| {{node handle | func handle} | {0x000000001EAC1B90 | 0x0000000016E55100}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_1_node_281"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {2 (topoId: 4) | 0x0000000009FB6E40}}
| {kind | DtoD (DEVICE to DEVICE)}
}"];

"graph_1_node_359"[style="bold" shape="record" label="{KERNEL
| {ID | 359 (topoId: 332) | _ZN39_GLOBAL__N__dad47804_7_grid_cu_ce326b3211grid_kernelEPKiS1_S1_S1_PKlS3_llPiS4_Pl\<\<\<800,256,0\>\>\>}
| {{node handle | func handle} | {0x000000001EAE64A8 | 0x000000001C3132C0}}
}"];

"graph_1_node_360"[style="bold" shape="record" label="{KERNEL
| {ID | 360 (topoId: 331) | _ZN39_GLOBAL__N__0b0bed85_7_fold_cu_1f07c83111fold_kernelILb1ELb0ELb1EEEvPKiS2_S2_S2_S2_S2_S2_S2_S2_S2_S2_PKfNS_3LayElllPfNS_3TexES2_\<\<\<132,128,0\>\>\>}
}"];

"graph_1_node_361"[style="bold" shape="record" label="{KERNEL
| {ID | 361 (topoId: 330) | _ZN47_GLOBAL__N__df323718_14_fold_ablate_cu_6f30d79d18fold_ablate_kernelILb0ELb1ELb0ELb0ELb0EEEvPKiS2_PKfliPf\<\<\<8,256,0\>\>\>}
}"];

"graph_1_node_362"[style="bold" shape="record" label="{KERNEL
| {ID | 362 (topoId: 329) | _ZN2at6native18my_grid_kernelIiEEvPi\<\<\<8,256,0\>\>\>}
}"];

"graph_1_node_0" -> "graph_1_node_280" [style="solid"];
"graph_1_node_280" -> "graph_1_node_359" [style="solid"];
}
}
"""


def test_kernel_nodes_read_from_the_dot_print():
    """CUDA's DOT print, in the form CUDA 12.8 writes it on an H100 (nodes cut
    from a paris-30k frame's graph, a fold node in the same form): each
    node counts once, by the stem its mangled name holds after its length,
    not `fold_ablate_kernel` nor a kernel whose name ends alike; memcpy
    nodes and edges count nothing."""
    assert kernel_nodes(DOT_SAMPLE) == {"fold": 1, "rasterize": 1, "grid": 1}
    assert kernel_nodes("") == {}
