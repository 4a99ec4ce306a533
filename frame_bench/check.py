"""Whether the frames the timed loop produced are right.

During the window a `Keeper` holds a seeded sample of the frames, each
with the layers' transforms it was rendered with: a reservoir of `count`
frames drawn uniformly from the whole window, and the window's last
frame (in a damage-cached loop the one that carries the longest history).
After the window each kept frame is compared with the plain reference on
a seeded sample of its tile rows, as many as the cell's check file gives
under `rows` for the sampled frames and under `last_rows` for the last
(null: all of them).

The number compared is `mismatch_pct`: the share of the compared u8
channel values that differ from the reference at all, in percent; the
frame with the largest share is the one reported.  A frame passes while
that share stays within the cell's limit.
"""

from __future__ import annotations

import numpy as np

TILE = 16


def _rng(seed: int, *more: int):
    return np.random.default_rng([seed % (1 << 63), *more])


class Keeper:
    """A seeded sample of a stream of frames: `count` drawn uniformly
    (reservoir sampling), and the last, which the caller hands over when
    the stream ends.  A kept frame is copied into a slot allocated up
    front, so keeping one neither holds on to the program's arrays nor
    allocates while the stream runs (either would change the heap the
    program's own per-frame arrays come from)."""

    def __init__(self, count: int, seed: int, shape, rows=None, last_rows=None):
        self.rng = _rng(seed, 1)
        self.rows, self.last_rows = rows, last_rows
        self.seen = 0
        self.images = [np.empty(shape, np.uint8) for _ in range(count)]
        self.transforms = [None] * count
        self.index = [None] * count
        self.last = None

    def offer(self, index: int, image, transforms):
        """Frame `index`, its pixels (u8 [H, W, 4]) and the transforms it
        was rendered with; copied only where kept."""
        self.seen += 1
        j = self.seen - 1 if self.seen <= len(self.images) else int(self.rng.integers(self.seen))
        if j >= len(self.images):
            return
        np.copyto(self.images[j], image)
        if transforms is not None:
            if self.transforms[j] is None:
                self.transforms[j] = np.empty_like(transforms)
            np.copyto(self.transforms[j], transforms)
        self.index[j] = index

    def finish(self, index: int, image, transforms):
        self.last = (index, image, transforms)

    def frames(self):
        """The kept frames and the last, each once, by index: (index,
        pixels, transforms, tile rows to compare)."""
        out = {i: (i, img, t, self.rows)
               for i, img, t in zip(self.index, self.images, self.transforms) if i is not None}
        if self.last is not None:
            out[self.last[0]] = (*self.last, self.last_rows)
        return [out[k] for k in sorted(out)]


def rows_of(height: int, count, seed: int, index: int):
    n = -(-height // TILE)
    if count is None or count >= n:
        return list(range(n))
    return sorted(_rng(seed, 2, index).choice(n, size=count, replace=False).tolist())


def compare(reference, frames, seed: int, lowp=None):
    """[(frame index, mismatch_pct)] of each frame (index, u8 image
    [H, W, 4], transforms, rows) against `reference`
    (`reference.Reference`) on `rows` sampled tile rows (None: all)."""
    out = []
    for index, image, transforms, rows in frames:
        image = np.asarray(image).reshape(reference.scene.height, reference.scene.width, 4)
        want = reference.rows(transforms, rows_of(reference.scene.height, rows, seed, index),
                              lowp)
        off = total = 0
        for r, ref in want.items():
            got = image[r * TILE:r * TILE + ref.shape[0]]
            off += int(np.count_nonzero(got != ref))
            total += ref.size
        out.append((index, 100.0 * off / total))
    return out
