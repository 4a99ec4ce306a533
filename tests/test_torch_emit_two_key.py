"""The two-key emit (`rasterize_kernel.emit_two_key`): each pixel segment of
K1's virtual lines as the two-key sort's combined int64 key and its u32
payload word, on the frames whose [row | slot | tx] key passes 31 bits.

- The plain version (`emit_two_key_torch`) against `_emit_core`'s fields
  in the old two-key form (key_hi, key_lo, payload), element by element,
  on seeded edge lines that reach every case the kernel must get right:
  the largest slot 2^21 - 1, the last tile row and column at the format's
  limits, `row_lo` != 0, padding virtual lines past v_total, segments left
  of the viewport (tile -1), above and below the rows and right of the
  viewport, and lines with `a` or `b` infinite and a NaN guess;
- the CUDA kernel (`csrc/rasterize.cu`) bit-equal to the plain version on
  the same lines and on K1's output for the tiny `paris30k-7680x4320`
  frame (`frame_bench`'s scene) forced onto the two-key route (marked
  `card`: they skip without one).

On a machine with a card (this file imports no JAX):
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_emit_two_key.py -m card`.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from forma_tpu_torch.ops import _build, rasterize
from forma_tpu_torch.ops import rasterize_kernel as rk
from forma_tpu_torch.ops.expand_kernel import expand_params, expand_params_torch
from forma_tpu_torch.ops.line_setup import (
    PA, PAOH, PAOL, PB, PBOH, PBOL, PC, PCDH, PCDL, PD, PDX, PDY, PX0, PY0,
    line_setup,
)
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

K_SEG = 8
MAX_SLOT = (1 << 21) - 1
PADDING = 300  # virtual lines past v_total
# name: (width, height, rows, tiles_x, row_lo) of an edge frame.
FRAMES = {
    # The format's limits (65536x32768): the last tile row and column.
    "format_limit": (1 << 16, 1 << 15, 2048, 4096, 0),
    # Tile rows [5, 65) of a 1920x1080 frame: lines above and below them.
    "row_span": (1920, 1080, 60, 120, 5),
}
REPO = Path(__file__).resolve().parents[1]


def edge_lines(frame: str, seed: int = 5) -> tuple:
    """The emit's inputs (pt, j, v_total, k_seg, rows, tiles_x, row_lo) on
    the CPU for lines built with numpy from `seed` through `line_setup`
    and K1's plain version: vertical lines (`a` infinite, every `a` guess
    NaN), short random lines over the frame and past its edges, lines
    left and right of the viewport and into it from the left, lines above
    the frame's first row and below its last, lines in its last tile and
    long ones; slots up to 2^21 - 1; `PADDING` padding vlines.  A quarter
    of the vertical lines' vlines then swap their x and y columns, which
    makes `b` infinite there."""
    w, h, rows, tiles_x, row_lo = FRAMES[frame]
    rng = np.random.default_rng(seed)
    y_lo, y_hi = row_lo * 16.0, (row_lo + rows) * 16.0
    x_hi = tiles_x * 16.0

    def pts(n, x0, x1, y0, y1):
        return np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], 1)

    def near(a, r):
        return a + rng.uniform(-r, r, a.shape)

    def to_x(a, x0, x1):  # an end in [x0, x1) at a nearby height
        return np.stack([rng.uniform(x0, x1, a.shape[0]), near(a[:, 1], 60)], 1)

    segs = []  # (start, end) pairs; the lines between them are dead
    a = pts(150, -40, x_hi + 40, y_lo - 40, y_hi + 40)
    segs.append((a, a + np.stack([np.zeros(150), rng.uniform(-90, 90, 150)], 1)))  # vertical
    a = pts(300, -40, x_hi + 40, y_lo - 40, y_hi + 40)
    segs.append((a, near(a, 60)))  # over the frame and past its edges
    a = pts(80, -300, -1, y_lo, y_hi)
    segs.append((a, to_x(a, -300, -1)))  # left of the viewport
    a = pts(80, -200, -1, y_lo, y_hi)
    segs.append((a, to_x(a, 1, 400)))  # into it from the left
    a = pts(80, x_hi + 1, x_hi + 300, y_lo, y_hi)
    segs.append((a, to_x(a, x_hi + 1, x_hi + 300)))  # right of the viewport
    a = pts(80, 0, x_hi, y_lo - 30, y_lo)
    segs.append((a, near(a, 30)))  # above the first row
    a = pts(80, 0, x_hi, y_hi, y_hi + 60)
    segs.append((a, near(a, 30)))  # below the last row
    a = pts(120, x_hi - 16, x_hi - 0.5, y_hi - 16, y_hi - 0.5)
    segs.append((a, np.minimum(near(a, 8), [x_hi - 0.5, y_hi - 0.5])))  # the last tile
    a = pts(10, 0, x_hi, y_lo, y_hi)
    segs.append((a, near(a, 400)))  # long
    start = np.concatenate([s for s, _ in segs])
    end = np.concatenate([e for _, e in segs])
    order = rng.permutation(start.shape[0])
    start, end = start[order], end[order]
    n = start.shape[0]
    p = np.empty((2 * n, 2))
    p[0::2], p[1::2] = start, end
    g_slot = np.asarray([MAX_SLOT, 0, 1 << 20, 4321], np.int32)
    line_slot = np.full(2 * n - 1, -1, np.int32)
    line_slot[0::2] = rng.integers(0, 4, n)
    g = (g_slot, np.ones(4, bool), np.tile(np.asarray([1, 0, 0, 1, 0, 0], np.float32), (4, 1)),
         np.zeros(4, bool))
    px, py = p[:, 0].astype(np.float32), p[:, 1].astype(np.float32)
    params, _, _, ends = line_setup(
        *map(torch.from_numpy, (px, py, line_slot, *g)), w, h, k_seg=K_SEG)
    v_total = int(ends[-1])
    pt, j = expand_params_torch(params, ends, v_total + PADDING)
    swap = torch.isinf(pt[PA]) & (torch.arange(pt.shape[1]) % 4 == 0)
    for x, y in ((PX0, PY0), (PDX, PDY), (PA, PB), (PC, PD), (PAOH, PBOH), (PAOL, PBOL)):
        pt[x, swap], pt[y, swap] = pt[y, swap], pt[x, swap].clone()
    pt[PCDH, swap], pt[PCDL, swap] = -pt[PCDH, swap], -pt[PCDL, swap]
    return pt, j, torch.tensor(v_total), K_SEG, rows, tiles_x, row_lo


def _old_form(pt, j, v_total, k_seg, rows, tiles_x, row_lo):
    """The emit's fields in the two-key form the route had before the
    combined key: (key_hi, key_lo, payload) int64 [k_seg, V] of u32 values,
    `SENTINEL` and 0 where invalid, and the validity mask."""
    v_live = torch.arange(pt.shape[1]) < v_total
    tile_x, tile_y, slot, payload, valid = rk._emit_core(
        lambda i: pt[i], j, v_live, k_seg, rows, tiles_x, row_lo)
    key_hi = ((tile_y.long() + 1) << rk.TX_BITS) | (tile_x.long() + 1)
    key_hi = torch.where(valid, key_hi, torch.full_like(key_hi, 0xFFFFFFFF))
    return key_hi, torch.where(valid, slot, 0), payload, valid


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_plain_emit_is_the_old_two_key_form(frame):
    """The combined key splits into the old (key_hi, key_lo) and the word
    is the old payload, slot by slot; the sentinel and the zero payload
    exactly where the old form was invalid, the padding vlines included;
    and the lines reach every case the kernel tests rely on."""
    args = edge_lines(frame)
    pt, _, v_total, _, rows, tiles_x, row_lo = args
    key, payload = rk.emit_two_key_torch(*args)
    assert key.dtype == torch.int64 and payload.dtype == torch.int32
    assert key.shape == payload.shape == (K_SEG, pt.shape[1])
    key_hi, key_lo, want_pay, valid = _old_form(*args)
    invalid = key == rk.TWO_KEY_SENTINEL
    assert torch.equal(invalid, ~valid)
    assert torch.equal(torch.where(valid, key >> rk.SLOT_FIELD_BITS, 0xFFFFFFFF), key_hi)
    assert torch.equal(torch.where(valid, key & MAX_SLOT, 0), key_lo)
    assert torch.equal(payload.long() & 0xFFFFFFFF, want_pay)
    assert (payload[invalid] == rk.ZERO_PAYLOAD).all()
    assert invalid[:, int(v_total):].all()

    tx = key_hi[valid] & ((1 << rk.TX_BITS) - 1)
    row = key_hi[valid] >> rk.TX_BITS
    assert (tx == 0).any(), "no segment left of the viewport (tile -1)"
    assert (tx == tiles_x).any() and (row == rows).any(), "no segment in the last tile"
    assert (key_lo[valid] == MAX_SLOT).any()
    assert int(valid.sum()) > 2000 and int((~valid[:, :int(v_total)]).sum()) > 500
    assert torch.isinf(pt[PA]).any() and torch.isinf(pt[PB]).any()
    if frame == "format_limit":
        assert int(key[valid].max()) == (((rows << 13) | tiles_x) << 21) | MAX_SLOT
    else:
        assert row_lo > 0


def test_emit_two_key_on_the_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing; the
    key sort splits the sorted combined keys into (key_hi, key_lo), the
    sentinel into `SENTINEL` and 0, and widens the payload words."""
    args = edge_lines("row_span")
    before = dict(_build.LAUNCHES)
    key, payload = rk.emit_two_key(*args)
    want = rk.emit_two_key_torch(*args)
    assert torch.equal(key, want[0]) and torch.equal(payload, want[1])
    assert _build.LAUNCHES == before

    sorted_key = torch.sort(key.reshape(-1)).values
    got = rasterize.sort_two_key(key.reshape(-1), payload.reshape(-1))
    assert torch.equal(got[0] << rasterize.SLOT_FIELD_BITS | got[1],
                       torch.where(sorted_key == rk.TWO_KEY_SENTINEL,
                                   0xFFFFFFFF << rasterize.SLOT_FIELD_BITS, sorted_key))
    assert torch.equal(torch.sort(got[2]).values,
                       torch.sort(payload.reshape(-1).long() & 0xFFFFFFFF).values)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the two-key emit kernel has no CPU version")
    return torch.device("cuda", 0)


def _on(args, device):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


def _bit_equal(args):
    """The kernel on `args` (on the card) against the plain version there:
    one launch, equal keys and payload words."""
    before = _build.LAUNCHES["emit_two_key"]
    got = rk.emit_two_key(*args)
    assert _build.LAUNCHES["emit_two_key"] == before + 1
    want = rk.emit_two_key_torch(*args)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.card
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_kernel_bit_equal_on_edge_lines(frame, card):
    args = _on(edge_lines(frame), card)
    _bit_equal(args)
    # row_lo as the int32 device scalar a frame graph passes.
    row_lo = torch.full((), args[6], dtype=torch.int32, device=card)
    _bit_equal((*args[:6], row_lo))


@pytest.mark.card
def test_kernel_bit_equal_on_the_tiny_8k_frame(card, monkeypatch):
    """K1's output for the tiny `paris30k-7680x4320` configuration
    (`frame_bench/tests/small/`), the route forced two-key (its tiny size
    packs): the kernel on the inputs the frame recorded, and K1 run again
    on them."""
    from frame_bench.compose import compose
    from frame_bench.scenes import paris30k_scaled
    from forma_tpu_torch import Color, Renderer
    from forma_tpu_torch.ops import pipeline

    config = json.loads((REPO / "frame_bench/configs/paris30k-7680x4320.json").read_text())
    config.update(json.loads(
        (REPO / "frame_bench/tests/small/paris30k-7680x4320.json").read_text()))
    scene = paris30k_scaled.build(config, 2**31 + 11)
    monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    taps = {}
    Renderer(card).render_device(compose(scene), scene.width, scene.height,
                                 Color(1.0, 1.0, 1.0, 1.0), taps=taps)
    args = taps["emit_two_key"]
    assert args[0].is_cuda and int(args[2]) > 1000
    pt, j = expand_params(*taps["expand"])
    assert torch.equal(pt.view(torch.int32), args[0].view(torch.int32))
    assert torch.equal(j, args[1])
    key, _ = _bit_equal(args)
    assert int((key != rk.TWO_KEY_SENTINEL).sum()) > 1000
