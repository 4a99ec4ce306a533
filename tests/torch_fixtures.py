"""Fixtures of the port's tests (`tests/test_torch_*.py`):

- `one_torch_thread`, which every port test module imports (it is
  autouse): its tests run PyTorch on one CPU thread.  The suite runs in
  several worker processes that share the machine's cores, and PyTorch's
  intra-op threads then only contend with the other workers: the port's
  CPU frames are thousands of small ops, each a parallel region whose
  threads wait for one another, and ran 5-20x slower so (the whole suite
  on 6 workers: 958 s against 362 s on one thread a worker, every test
  passing both ways).  The results do not depend on it.
- `no_reads`: a context in which every way of reading a tensor's value
  on the host raises, the precondition of a CUDA graph's capture
  (`test_torch_graphs.py`, `test_torch_sharded.py`);
- `cpu_graphs`: `FrameGraphs` driven on the CPU with a stand-in graph
  that runs the frame again at each replay (the same two files).
"""

import contextlib

import pytest
import torch

from forma_tpu_torch.graphs import FrameGraphs
from forma_tpu_torch.ops import fold_kernel

READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
         "__index__")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one CPU thread for the module's tests, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ReadBack(AssertionError):
    pass


@pytest.fixture
def no_reads(monkeypatch):
    """While the returned context is open, every way of reading a tensor's
    value on the host raises `ReadBack`, except one read in each call of
    the plain fold (`paint_fold_torch`: its depth)."""
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
    CPU renderer's frames through its graphs (`Renderer._compiled` made
    true wherever the frame asks for neither the plain kernels nor taps);
    its `calls` counts the pools made (`graph_pool_handle`), the warm-ups
    (`stream`) and the recordings (`graph`, with the pool of each and the
    stream it records on, a `_Null` that keeps the arguments it was made
    with)."""
    calls = {"pools": 0, "warmups": 0, "recorded_in": [], "recorded_on": []}

    class _Null:
        def __init__(self, *a, **k):
            self.args = a

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
    def graph(g, pool=None, stream=None, **k):
        calls["recorded_in"].append(pool)
        calls["recorded_on"].append(stream)
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
        monkeypatch.setattr(r, "_compiled", lambda kwargs: (
            not kwargs.get("plain") and kwargs.get("taps") is None))
        return r

    route.calls = calls
    return route
