"""CUDA graphs of the frames: the counterpart of `jax.jit`'s executable
cache.

The JAX package compiles each frame entry point
(`forma_tpu/ops/pipeline.py:319-433`: `render_frame`,
`render_frame_cached`, `render_frame_sharded` and
`render_frame_sharded_lines`) once per static key, and a frame is one
dispatch of that program (`forma_tpu/profiling.py:3-4`).  On the card the
counterpart is a CUDA graph: `FrameGraphs.run` captures a frame once per
key and replays it once per frame, with every hand-written kernel of the
frame (K4, or K1 and the emit; K2; K3) and every PyTorch op inside the
replay.  A CUDA graph belongs to one card, so a renderer keeps one
`FrameGraphs` a card: a sharded frame whose shards all sit on the
renderer's card is one graph of the whole entry point (its collectives
are copies on that card), and one whose shards sit on several cards
replays each card's graph of its piece (`pipeline.row_shards`, or
`line_front` and `line_back` with the exchange run between the
replays).

The key is the entry point, the device, every argument that is not a
tensor (width, height, rows, tiles_x, caps, features, channels, expand:
JAX's statics; a sharded frame's mesh, by its devices, and `xcap`; a
card's piece, its shards), the arguments' structure (so a crop given and
one not given key apart, as JAX's pytree does) and every input tensor's
shape, dtype and device; the style-table dict's tensors are inputs like
the rest.  The row span, the crop bounds and the damage cache's
`cache_ok` are not in it: they are `scalars`, int32 0-d tensors on the
device that the frame reads (K4 and K3 read `row_lo` there, the crop
masks compare elementwise, `cache_ok` masks the unchanged tiles), filled
before each replay, so one graph serves every row span, crop rectangle
and cache state, as one JAX executable does.

A graph holds its static input buffers, which each frame fills with
`copy_` (an input that is the very tensor copied last time, unmodified
since, is not copied again), its static outputs, which each replay
overwrites, and what its capture grew `_build.LAUNCHES` by, which each
replay adds again (`_build.capturing`, `_build.replayed`).  The caller
gets clones of the outputs: a frame, its diagnostics, its tile counts and
its damaged tiles are its own, as JAX's results are, and stay valid while
later frames replay any graph.

Memory.  A renderer's graphs share one private memory pool
(`torch.cuda.graph_pool_handle()`): their replays run one at a time on
one stream and their outputs are cloned out at once, so a graph may
reuse what another's capture freed, and the pool holds about one frame's
peak plus each live graph's outputs (JAX's executables hold no buffers).
The pool keeps every block it has taken while any of its graphs lives, so
the cache is bounded: `BOUND` graphs, the least recently used dropped
first; a capture at new buckets first drops the graphs of the buckets
it supersedes (a renderer's buckets only grow; a bucket set is named, so
the line-sharded frame's per-shard buckets and `xcap` supersede only the
graphs that read them); and a frame that runs out of memory beside other
graphs drops them all, which frees the pool, and runs again alone: a
capture, not an eager frame.  Only a capture into an empty set runs a
warm-up, one eager frame on a side stream, as PyTorch's documentation
prescribes.  Cached blocks (a dropped pool's too) are released
(`torch.cuda.empty_cache()`) before the warm-up and again before
`torch.cuda.graph` records, so that a large frame's warm-up and its graph
do not both hold memory.  Each `FrameGraphs` records on a stream of its
own card.  The stage stamps' accumulator (`tracing.accumulator`), whose
address the graphs hold, is allocated before any recording, outside the
pool.
Alone, a failure in either raises: nothing falls back to the eager frame.

With `witness` set (`FrameGraphs.witness`, off by default), each capture
also counts the hand-written kernels' nodes in the recorded graph, from
CUDA's own print of it (`Capture.kernel_nodes`): what a replay runs, seen
in the graph rather than counted by the wrappers.
"""

from __future__ import annotations

import os
import re
import tempfile
import time
import warnings
import weakref
from collections import OrderedDict
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from . import tracing
from .ops import _build

BOUND = 8  # graphs a renderer keeps
# The hand-written kernels a frame launches, by the name stem of their
# `__global__` functions (`csrc/expand.cu` K1, `rasterize.cu` K4, `grid.cu`
# K2, `fold.cu` K3 in each specialisation).
KERNELS = ("expand", "rasterize", "grid", "fold")


class Capture(NamedTuple):
    """What one capture cost and recorded: the warm-up frame's seconds (0
    without one) and the recording's, the bytes the shared pool grew by,
    what the capture grew `_build.LAUNCHES` by (each replay adds it), and
    {kernel stem: nodes} of KERNELS in the recorded graph (None unless
    witnessed)."""

    warmup_s: float
    capture_s: float
    pool_bytes: int
    launches: dict
    kernel_nodes: dict | None


def kernel_nodes(dot: str) -> dict:
    """{kernel stem: nodes} of KERNELS in a graph's DOT print
    (cudaGraphDebugDotPrint): each node's text, from its definition to the
    next, names its function, mangled or not; a name counts where no
    letter or underscore comes before it."""
    nodes = re.split(r'(?m)^[ \t]*(?="[^"\n]*node[^"\n]*"[ \t]*\[)', dot)[1:]
    found = {}
    for node in nodes:
        for k in KERNELS:
            if re.search(rf"(?<![A-Za-z_]){k}_kernel", node):
                found[k] = found.get(k, 0) + 1
                break
    return found


def _witness(graph) -> dict:
    """`kernel_nodes` of a graph captured with `keep_graph=True`."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "frame.dot")
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*DEBUG")
            graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("the frame graph's DOT print was not written")
        with open(path) as f:
            return kernel_nodes(f.read())


def _scalar_shape(v):
    """A scalar argument's structure, which keys: None, an int (-1) or a
    tuple of ints (its length)."""
    return None if v is None else (len(v) if isinstance(v, tuple) else -1)


def _scalar_tensors(v, device):
    """The static int32 0-d device tensor(s) of scalar argument `v`."""
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(torch.zeros((), dtype=torch.int32, device=device) for _ in v)
    return torch.zeros((), dtype=torch.int32, device=device)


class _Graph:
    """One captured frame: static inputs (tensor leaves), static scalars,
    the graph, its static outputs and its `Capture`."""

    def __init__(self, buckets, leaves, scalars, device):
        self.buckets = buckets
        # On the graph's card, which may not be the inputs' (`load` copies
        # across cards).
        self.leaves = [x.to(device, copy=True) if isinstance(x, torch.Tensor) else x
                       for x in leaves]
        # (weakref, version) of the tensor each static input last copied
        self.seen = [(weakref.ref(x), x._version) if isinstance(x, torch.Tensor) else None
                     for x in leaves]
        self.scalars = {n: _scalar_tensors(v, device) for n, v in scalars.items()}
        self.values = {n: None for n in scalars}  # the scalars' filled values
        self.graph = None
        self.out = None
        self.capture = None

    def load(self, leaves, scalars) -> None:
        """Fills the static inputs with this frame's."""
        for i, src in enumerate(leaves):
            if not isinstance(src, torch.Tensor):
                continue
            seen = self.seen[i]
            if seen is not None and seen[0]() is src and seen[1] == src._version:
                continue
            self.leaves[i].copy_(src)
            self.seen[i] = (weakref.ref(src), src._version)
        for n, v in scalars.items():
            if v == self.values[n]:
                continue
            t = self.scalars[n]
            for tt, vv in (zip(t, v) if isinstance(v, tuple) else ((t, v),)):
                tt.fill_(vv)
            self.values[n] = v

    def call(self, fn, spec):
        args, kwargs = pytree.tree_unflatten(self.leaves, spec)
        return fn(*args, **kwargs, **self.scalars)


class FrameGraphs:
    """One renderer's frame graphs on a CUDA `device` (see the module's
    text).  `captures` and `replays` count the captures and replays made,
    `evictions` the graphs dropped to make room (the bound, or memory;
    not the graphs of superseded buckets), and
    `last_capture` is the `Capture` of the graph the latest frame
    replayed."""

    witness = False  # count each capture's kernel nodes (`Capture.kernel_nodes`)

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs = OrderedDict()
        self._pool = None  # the live graphs' shared memory pool
        # The stream captures record on: this card's own (`torch.cuda.graph`'s
        # default is one stream for the process, made on the first card that
        # captured, and a capture on another card then launches outside it).
        self._stream = None
        self._pool_bytes = 0  # what their captures grew it by
        self.captures = 0
        self.replays = 0
        self.evictions = 0
        self.last_capture = None

    def __len__(self) -> int:
        return len(self._graphs)

    def pool_bytes(self) -> int:
        """Bytes the shared pool reserved in the live graphs' captures."""
        return self._pool_bytes

    def key(self, fn, args, kwargs, scalars):
        """(key, leaves, spec) of a frame: see the module's text."""
        leaves, spec = pytree.tree_flatten((args, kwargs))
        sig = tuple(
            (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else x
            for x in leaves
        )
        shapes = tuple((n, _scalar_shape(v)) for n, v in sorted(scalars.items()))
        return (fn, self.device, spec, sig, shapes), leaves, spec

    def run(self, fn, args, kwargs, scalars, buckets):
        """One frame of `fn(*args, **kwargs, **scalars)` as a graph replay,
        captured first if its key is new; returns clones of its outputs.
        `scalars` maps argument names to None, an int or a tuple of ints,
        passed to `fn` as int32 0-d device tensors; `buckets` names the
        bucket set the frame reads and its values, `(name, *values)` (a
        capture drops the graphs of the same name at other values).  Out
        of memory beside other graphs, it drops them all and runs again
        alone."""
        key, leaves, spec = self.key(fn, args, kwargs, scalars)
        try:
            return self._replay(key, fn, leaves, spec, scalars, buckets)
        except torch.cuda.OutOfMemoryError:
            if all(k == key for k in self._graphs):
                raise
        # Outside the handler, so that its traceback holds no graph.
        self._drop(list(self._graphs))
        return self._replay(key, fn, leaves, spec, scalars, buckets)

    def _replay(self, key, fn, leaves, spec, scalars, buckets):
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(key, fn, leaves, spec, scalars, buckets)
        else:
            self._graphs.move_to_end(key)
        with torch.cuda.device(self.device):
            g.load(leaves, scalars)
            g.graph.replay()
        self.replays += 1
        self.last_capture = g.capture
        _build.replayed(g.capture.launches)
        return pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, g.out)

    def _drop(self, keys, evicted: bool = True) -> None:
        """Drops the graphs of `keys` (`evicted`: to make room); the last
        one out frees the pool."""
        for k in keys:
            del self._graphs[k]
        self.evictions += len(keys) if evicted else 0
        if not self._graphs:
            self._pool, self._pool_bytes = None, 0

    def _make_room(self, buckets) -> None:
        """Before a capture at `buckets`: drops the graphs of the same
        bucket set at other values (the ones these supersede), then the
        least recently used past `BOUND - 1`."""
        self._drop([k for k, g in self._graphs.items()
                    if g.buckets[0] == buckets[0] and g.buckets != buckets], evicted=False)
        self._drop(list(self._graphs)[:max(0, len(self._graphs) - BOUND + 1)])

    def _capture(self, key, fn, leaves, spec, scalars, buckets) -> _Graph:
        with tracing.span("capture"):
            self._make_room(buckets)
            alone = self._pool is None
            if alone:
                self._pool = torch.cuda.graph_pool_handle()
            try:
                g = self._record(fn, leaves, spec, scalars, buckets, alone)
            except BaseException:
                if not self._graphs:  # a failed first capture leaves no pool
                    self._pool = None
                raise
            self._graphs[key] = g
            self._pool_bytes += g.capture.pool_bytes
            self.captures += 1
            return g

    def _record(self, fn, leaves, spec, scalars, buckets, warm_up: bool) -> _Graph:
        dev = self.device
        tracing.accumulator(dev)  # the stage stamps' address, outside the pool
        with torch.cuda.device(dev):
            g = _Graph(buckets, leaves, scalars, dev)
            g.load(leaves, scalars)
            t0 = t1 = time.perf_counter()
            if warm_up:
                torch.cuda.empty_cache()  # a dropped pool's blocks, too
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    g.call(fn, spec)
                torch.cuda.current_stream(dev).wait_stream(side)
                torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            # A witnessed graph keeps its recorded form for the DOT print.
            graph = torch.cuda.CUDAGraph(keep_graph=self.witness)
            self._stream = self._stream or torch.cuda.Stream(dev)
            with _build.capturing() as grew, torch.cuda.graph(graph, pool=self._pool,
                                                              stream=self._stream):
                out = g.call(fn, spec)
            if self.witness:
                graph.instantiate()
            t2 = time.perf_counter()
            grown = torch.cuda.memory_reserved(dev) - reserved
        g.graph, g.out = graph, out
        g.capture = Capture(t1 - t0, t2 - t1, grown, grew,
                            _witness(graph) if self.witness else None)
        return g
