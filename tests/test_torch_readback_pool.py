"""The renderer's recycled host buffers for whole-frame reads
(`renderer._HostFrames`): on the CPU the pool is driven directly, where
it pins nothing (its recycling is the same); on a card (marked `card`: it skips
without one) a CUDA `Renderer` hands out frames from it while the caller
keeps some of them.

On a machine with a card (this file imports no JAX):
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_readback_pool.py -m card`.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from forma_tpu_torch import Color, Composition, Renderer
from forma_tpu_torch.demos import scenes
from forma_tpu_torch.renderer import _HostFrames, _Lease
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

SMALL, LARGE = (6, 8, 4), (10, 8, 4)

# Scripts of reads and drops: ("read", name, shape) reads a frame of its
# own contents and holds the array as `name`; ("view", name, of) holds a
# slice of `of` as `name`; ("drop", name) lets go of it.  Each ends with
# the counters (recycled, made, fallbacks) the pool of two must read.
SCRIPTS = {
    # Frame i - 1 held while frame i reads, as a closed loop does.
    "alternate": ([("read", "a", SMALL), ("read", "b", SMALL), ("drop", "a"),
                   ("read", "c", SMALL), ("drop", "b"), ("read", "d", SMALL)], (2, 2, 0)),
    # A slice outlives its array: the buffer stays held until it goes.
    "slice_holds": ([("read", "a", SMALL), ("view", "s", "a"), ("drop", "a"),
                     ("read", "b", SMALL), ("drop", "b"), ("read", "c", SMALL),
                     ("drop", "c"), ("drop", "s"), ("read", "d", SMALL),
                     ("read", "e", SMALL)], (3, 2, 0)),
    # Both buffers held: the third read falls back, and so does the next.
    "both_held": ([("read", "a", SMALL), ("read", "b", SMALL), ("read", "c", SMALL),
                   ("read", "d", SMALL), ("drop", "a"), ("read", "e", SMALL)], (1, 2, 2)),
    # A larger frame replaces a free buffer it does not fit; a smaller one
    # fits the larger buffer.
    "shape_change": ([("read", "a", SMALL), ("read", "b", SMALL), ("drop", "a"),
                      ("drop", "b"), ("read", "c", LARGE), ("read", "d", SMALL),
                      ("drop", "c"), ("read", "e", SMALL)], (2, 3, 0)),
    # Nothing held: one buffer serves every read.
    "dropped": ([("read", "a", LARGE), ("drop", "a"), ("read", "b", LARGE),
                 ("drop", "b"), ("read", "c", SMALL)], (2, 1, 0)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_pool_script(name):
    steps, (recycled, made, fallbacks) = SCRIPTS[name]
    pool = _HostFrames()
    held, want = {}, {}
    reads = 0
    for step in steps:
        if step[0] == "read":
            reads += 1
            _, key, shape = step
            frame = torch.full(shape, reads, dtype=torch.uint8)
            held[key] = pool.read(frame)
            want[key] = frame.numpy().copy()
            assert held[key].shape == shape and held[key].dtype == np.uint8
            assert held[key].flags.writeable
        elif step[0] == "view":
            _, key, of = step
            held[key] = held[of][1:]
            want[key] = want[of][1:]
        else:
            del held[step[1]]
        # A held array keeps its own bytes whatever was read after it.
        for key in held:
            np.testing.assert_array_equal(held[key], want[key])
        assert len(pool._bufs) <= pool.n
    assert (pool.recycled, pool.made, pool.fallbacks) == (recycled, made, fallbacks)
    assert pool.recycled + pool.made + pool.fallbacks == reads


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_pool_hands_out_no_shared_memory(name):
    """Every two arrays alive at once are disjoint, and a fallback array
    lies in no pool buffer."""
    steps, _ = SCRIPTS[name]
    pool = _HostFrames()
    held = {}
    views = {s[1] for s in steps if s[0] == "view"}
    for step in steps:
        if step[0] == "read":
            before = pool.fallbacks
            held[step[1]] = pool.read(torch.zeros(step[2], dtype=torch.uint8))
            if pool.fallbacks > before:
                assert not any(np.shares_memory(held[step[1]], s[0].numpy())
                               for s in pool._bufs)
        elif step[0] == "view":
            held[step[1]] = held[step[2]][1:]
        else:
            del held[step[1]]
        keys = sorted(k for k in held if k not in views)
        assert not any(np.shares_memory(held[k], held[j])
                       for i, k in enumerate(keys) for j in keys[i + 1:])


def test_array_outlives_its_pool():
    """An array handed out keeps its buffer's memory alive after the pool
    (its renderer) is gone: memory allocated afterwards does not land on it."""
    pool = _HostFrames()
    frame = torch.arange(np.prod(SMALL), dtype=torch.uint8).reshape(SMALL)
    arr = pool.read(frame)
    del pool
    gc.collect()
    filler = [torch.full(SMALL, 255, dtype=torch.uint8) for _ in range(64)]
    np.testing.assert_array_equal(arr, frame.numpy())
    assert len(filler) == 64


# Ways a caller can keep a frame's memory: each must keep the lease alive.
VIEWS = {
    "array": lambda a: a,
    "slice": lambda a: a[1:, ::2],
    "reshape": lambda a: a.reshape(-1),
    "transpose": lambda a: a.transpose(1, 0, 2),
    "asarray": lambda a: np.asarray(a),
    "memoryview": lambda a: memoryview(a),
    "torch": lambda a: torch.from_numpy(a),
}


@pytest.mark.parametrize("how", sorted(VIEWS))
def test_lease_lives_exactly_as_long_as_a_view(how):
    """What the pool's weak reference rests on: the array handed out has
    the lease as its base, and any view keeps it alive.  A weak reference
    to the tensor `Tensor.numpy()` comes from would not do: the array
    holds another `Tensor` object, so that reference dies at once."""
    buf = torch.zeros(SMALL, dtype=torch.uint8)
    view = buf[:]
    plain = view.numpy()
    tensor_ref = weakref.ref(view)
    del view
    gc.collect()
    assert tensor_ref() is None and plain.base is not None
    lease = _Lease(buf.numpy())
    arr = np.asarray(lease)
    ref = weakref.ref(lease)
    assert arr.base is lease
    del lease
    kept = VIEWS[how](arr)
    del arr
    gc.collect()
    assert ref() is not None
    del kept
    assert ref() is None


def test_cpu_renderer_reads_no_pool():
    """A CPU renderer hands out the frame tensor's own memory: the pool is
    for a CUDA device's reads, and its counters stay at 0."""
    comp = Composition()
    scenes.circles(comp, 8, 64, 32)
    r = Renderer("cpu")
    for _ in range(3):
        img = r.render(comp, 64, 32)
    assert img.shape == (32, 64, 4)
    assert (r.readback_recycled, r.readback_fallbacks) == (0, 0)
    assert r._host_frames.made == 0 and r.readback_bytes == 3 * 64 * 32 * 4


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pool pins host memory for a card's copies")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_kept_frames_stay_their_own_on_a_card(card):
    """Six frames, every other one kept: each kept array equals a plain
    render of its own frame after the later frames have run (the clear
    colour changes each frame, so an array written again would show), and
    the counters read the holding pattern: buffers made for frames 0 and
    1, frame 2 into frame 1's buffer, frames 3-5 fall back."""
    W, H = 320, 192
    comp = Composition()
    scenes.paris30k(comp, W, H, paths=2000)
    r = Renderer(card)
    clears = [Color(0.1 * i, 1.0 - 0.15 * i, 0.5, 1.0) for i in range(6)]
    kept = {}
    for i, clear in enumerate(clears):
        img = r.render(comp, W, H, clear)
        if i % 2 == 0:
            kept[i] = img
        del img
    assert (r.readback_recycled, r._host_frames.made, r.readback_fallbacks) == (1, 2, 3)
    assert r.readback_bytes == 6 * W * H * 4
    assert all(s[0].is_pinned() for s in r._host_frames._bufs)
    for i, img in kept.items():
        frame, _ = r.render_device(comp, W, H, clears[i], plain=True)
        np.testing.assert_array_equal(img, frame[:H, :W].cpu().numpy())
    # Frame 6 reads into a pinned buffer again once frame 2's array goes.
    del kept[2]
    r.render(comp, W, H, clears[0])
    assert r.readback_recycled == 2 and r.readback_fallbacks == 3
