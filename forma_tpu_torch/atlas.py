"""Texture-atlas shelf allocator with reuse and GC.

A copy of `forma_tpu/atlas.py` (the JAX package's host scene model,
plain numpy): the port imports nothing of the JAX package.

The counterpart of the reference's etagere-backed `ImageAllocator`
(`forma/src/gpu/style_map.rs:29,72-137`): images pack into one bounded
4096x4096 atlas, allocations are reused across frames while the image stays
referenced, unreferenced entries are garbage-collected when space runs out,
and overflow raises a typed error (the reference panics,
`style_map.rs:105-107`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

MAX_ATLAS_SIZE = 4096


class AtlasError(ValueError):
    """The image set does not fit the atlas (`style_map.rs:105-107`)."""


class _Shelf:
    __slots__ = ("y", "height", "x_used")

    def __init__(self, y: int, height: int):
        self.y = y
        self.height = height
        self.x_used = 0


class AtlasAllocator:
    """Shelf packer over a `size` x `size` virtual texture."""

    def __init__(self, size: int = MAX_ATLAS_SIZE):
        self.size = size
        self._shelves: list[_Shelf] = []
        self._y_used = 0
        # image id -> (x, y, w, h)
        self._allocs: Dict[int, Tuple[int, int, int, int]] = {}
        self._live: set[int] = set()

    def begin_frame(self):
        """Starts a new frame: nothing is marked live yet."""
        self._live = set()

    def end_frame(self) -> bool:
        """Drops allocations not referenced this frame (the reference
        deallocates eagerly in `end_populate`, `style_map.rs:94-98`);
        returns True when entries moved (callers must re-blit)."""
        if any(iid not in self._live for iid in self._allocs):
            self.compact()
            return True
        return False

    def allocate(self, image_id: int, w: int, h: int) -> Tuple[int, int]:
        """Returns (x, y) for the image, reusing a prior allocation when the
        id is already resident; GCs dead entries and repacks on pressure."""
        if w > self.size or h > self.size:
            raise AtlasError(
                f"image {w}x{h} exceeds the {self.size}x{self.size} atlas"
            )
        self._live.add(image_id)
        got = self._allocs.get(image_id)
        if got is not None:
            return got[0], got[1]
        pos = self._try_place(w, h)
        if pos is None:
            self.compact()
            pos = self._try_place(w, h)
        if pos is None:
            raise AtlasError(
                f"atlas overflow: cannot place {w}x{h} "
                f"({len(self._allocs)} resident allocations)"
            )
        self._allocs[image_id] = (pos[0], pos[1], w, h)
        return pos

    def _try_place(self, w: int, h: int) -> Optional[Tuple[int, int]]:
        # Best shelf: smallest height >= h with room (bounded waste).
        best = None
        for s in self._shelves:
            if s.height >= h and s.height <= h * 2 and s.x_used + w <= self.size:
                if best is None or s.height < best.height:
                    best = s
        if best is not None:
            x = best.x_used
            best.x_used += w
            return x, best.y
        if self._y_used + h <= self.size:
            shelf = _Shelf(self._y_used, h)
            self._y_used += h
            self._shelves.append(shelf)
            x = shelf.x_used
            shelf.x_used += w
            return x, shelf.y
        return None

    def compact(self):
        """Drops allocations not referenced this frame and repacks the rest
        (the GC the reference runs via etagere's dealloc + rebind)."""
        live = {
            iid: rect for iid, rect in self._allocs.items() if iid in self._live
        }
        self._shelves = []
        self._y_used = 0
        self._allocs = {}
        moved = {}
        # Repack tallest-first for tighter shelves.
        for iid, (_, _, w, h) in sorted(
            live.items(), key=lambda kv: -kv[1][3]
        ):
            pos = self._try_place(w, h)
            if pos is None:  # cannot happen: repacking a subset of what fit
                raise AtlasError("atlas repack failed")
            self._allocs[iid] = (pos[0], pos[1], w, h)
            moved[iid] = (pos[0], pos[1])
        return moved

    @property
    def used_height(self) -> int:
        return self._y_used

    def rects(self) -> Dict[int, Tuple[int, int, int, int]]:
        return dict(self._allocs)

    def __len__(self):
        return len(self._allocs)
