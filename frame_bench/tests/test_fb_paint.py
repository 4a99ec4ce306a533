"""The reference's painter, vectorised across the tiles of a row, against
the oracle's tile-by-tile loop it was copied from: equal bits, in f32 and
in the bfloat16 control, on seeded scenes with and without transforms."""

import numpy as np
import pytest

from frame_bench.reference import Reference, paint
from frame_bench.reference.paint import round_bf16
from frame_bench.scenes import Scene, paris30k, spaceship


def cover_empty(cover, even_odd: bool) -> bool:
    if not even_odd:
        return bool(np.all(cover == 0))
    return bool(np.all((np.abs(cover) & 31) == 0))


def loop_paint_row(segs, lo, hi, tiles_x, colors, even_odd, clear, keep, out):
    txs = segs.tile_x[lo:hi]
    layers = segs.layer[lo:hi]
    lxs = segs.local_x[lo:hi].astype(np.int64)
    lys = segs.local_y[lo:hi].astype(np.int64)
    das = segs.double_area[lo:hi]
    cvs = segs.cover[lo:hi]

    # Covers carried in from the left of the viewport (tile -1).
    queue = {}
    left = txs < 0
    for layer in np.unique(layers[left]):
        m = left & (layers == layer)
        cov = np.zeros(paint.TILE, np.int32)
        np.add.at(cov, lys[m], cvs[m])
        queue[int(layer)] = cov

    starts = np.searchsorted(txs, np.arange(tiles_x + 1), side="left")
    cells = lxs * paint.TILE + lys  # [x, y] cell of each segment
    for tx in range(tiles_x):
        a, b = starts[tx], starts[tx + 1]
        # Within a tile the segments are sorted by layer.
        ids, first = np.unique(layers[a:b], return_index=True)
        span = {int(v): (a + f, a + e) for v, f, e in
                zip(ids, first, list(first[1:]) + [b - a])}
        present = sorted(set(span) | set(queue))
        dst = [np.full((paint.TILE, paint.TILE), clear[ch], np.float32) for ch in range(4)]  # [x, y]
        next_queue = {}
        for layer in present:
            lo, hi = span.get(layer, (a, a))
            c = cells[lo:hi]
            areas = np.bincount(c, das[lo:hi], paint.TILE * paint.TILE).astype(np.int32)
            areas = areas.reshape(paint.TILE, paint.TILE)
            covers = np.zeros((paint.TILE + 1, paint.TILE), np.int32)
            covers[1:] = np.bincount(c, cvs[lo:hi], paint.TILE * paint.TILE).astype(np.int32
                                                                      ).reshape(paint.TILE, paint.TILE)
            carry = queue.get(layer)
            if carry is not None:
                covers[0] += carry
            acc = np.cumsum(covers[:-1], axis=0)
            eo = bool(even_odd[layer])
            coverage = keep(paint._coverage(paint.PIXEL_DOUBLE_WIDTH * acc + areas, eo))
            fill = [keep(np.float32(colors[layer, ch])) for ch in range(4)]
            src_a = keep(fill[3] * coverage)
            dst = [keep(v) for v in paint._composite(dst, fill, src_a)]
            total = covers.sum(axis=0, dtype=np.int32)
            if not cover_empty(total, eo):
                next_queue[layer] = total
        queue = next_queue
        for ch in range(4):
            out[:, tx * paint.TILE:(tx + 1) * paint.TILE, ch] = dst[ch].T


def star_scene(seed):
    """Self-overlapping stars and rings: winding numbers past 1, even-odd
    layers, paths off every side of the frame."""
    rng = np.random.default_rng(seed)
    paths, colors, eo = [], [], []
    for _ in range(60):
        cx, cy = rng.uniform(-40, 200), rng.uniform(-40, 140)
        r = rng.uniform(5, 70)
        pts = []
        for k in range(7):
            a = 2 * np.pi * (3 * k) / 7
            pts += [float(cx + r * np.cos(a)), float(cy + r * np.sin(a))]
        paths.append(("M" + "L" * 6, pts))
        colors.append(rng.uniform(0, 1, 4).astype(np.float32))
        eo.append(bool(rng.integers(2)))
    return Scene(160, 96, paths, np.asarray(colors, np.float32), np.asarray(eo), (0.2, 0.3, 0.4, 1.0))


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
@pytest.mark.parametrize("kind", ["paris", "spaceship", "stars"])
@pytest.mark.parametrize("lowp", [None, round_bf16])
def test_vectorised_rows_equal_the_loop(monkeypatch, kind, seed, lowp):
    cfg = dict(width=160, height=96, paths=400, buildings=0.7, roads=0.2, asteroids=8,
               bullets=3, clear=[1, 1, 1, 0.5])
    transforms = None
    if kind == "paris":
        scene = paris30k.build(cfg, seed)
        th = 0.03
        c, s = 0.999 * np.cos(th), 0.999 * np.sin(th)
        transforms = np.tile(np.asarray([c, s, -s, c, 5.0, -3.0], np.float32), (scene.layers, 1))
    elif kind == "spaceship":
        scene = spaceship.build(cfg, seed)
        anim = spaceship.animator(scene, cfg, seed)
        for _ in range(4):
            transforms = anim.step(1 / 60)
    else:
        scene = star_scene(seed)
    ref = Reference(scene)
    rows = range(-(-scene.height // 16))
    got = ref.rows(transforms, rows, lowp)
    monkeypatch.setattr(paint, "_paint_row", loop_paint_row)
    want = ref.rows(transforms, rows, lowp)
    for r in rows:
        assert np.array_equal(got[r], want[r]), r
