"""The plain reference renderer: a scene description and its layers'
transforms to the u8 pixels of chosen tile rows.

It reads the benchmark's plain scene (`frame_bench.scenes.Scene`: paths as
verbs and points, a colour and fill rule a layer, layer i at order i) and
imports nothing of the program under test.  `rows(...)` renders tile
rows of one frame: only the paths that reach those rows are flattened
(once) and rasterized, and only those rows painted, so a sample of a
large frame costs a fraction of the whole.
"""

from __future__ import annotations

import numpy as np

from . import flatten, paint, raster

TILE = 16
IDENTITY = np.asarray([1, 0, 0, 1, 0, 0], np.float32)


class Reference:
    def __init__(self, scene):
        self.scene = scene
        self.colors = np.asarray(scene.colors, np.float32)
        self.even_odd = np.asarray(scene.even_odd, bool)
        # Each path's control points: a flattened path stays inside their
        # hull, so their extent bounds its lines' under any affine map.
        ys = [np.asarray(pts[1::2], np.float32) for _, pts in scene.paths]
        xs = [np.asarray(pts[0::2], np.float32) for _, pts in scene.paths]
        self.cx, self.cy = np.concatenate(xs), np.concatenate(ys)
        self.starts = np.cumsum([0] + [len(v) for v in ys[:-1]])
        self.owner = np.repeat(np.arange(len(ys)), [len(v) for v in ys])
        self.flat = {}  # path -> (x0, y0, x1, y1) of its lines, untransformed

    def _lines(self, layer):
        if layer not in self.flat:
            x, y, end = flatten.flatten(*self.scene.paths[layer])
            live = ~end[:-1]
            self.flat[layer] = (x[:-1][live], y[:-1][live], x[1:][live], y[1:][live])
        return self.flat[layer]

    def rows(self, transforms, rows, lowp=None):
        """{tile row: u8 [rows' pixel rows, width, 4] RGBA} of the frame
        whose layer i has transform `transforms[i]` (f32 [L, 6] rows of
        ux, uy, vx, vy, tx, ty; None, or an identity row, for none).  Only
        the paths whose control points reach the rows are flattened (once)
        and rasterized."""
        s = self.scene
        rows = sorted(set(int(r) for r in rows))
        t = None if transforms is None else np.asarray(transforms, np.float32)
        cy = self.cy
        if t is not None:
            tp = t[self.owner]
            moved = (tp != IDENTITY).any(axis=1)
            _, ty, _, _ = raster.transform_lines(self.cx, self.cy, self.cx, self.cy, tp)
            cy = np.where(moved, ty, cy)
        lo = np.minimum.reduceat(cy, self.starts)
        hi = np.maximum.reduceat(cy, self.starts)
        near = np.zeros(s.layers, bool)
        for r in rows:  # a pixel of margin: rounding to the sub-pixel grid
            near |= (hi >= r * TILE - 1) & (lo <= (r + 1) * TILE + 1)
        layers = np.flatnonzero(near)
        parts = [self._lines(int(k)) for k in layers]
        n = [len(p[0]) for p in parts]
        x0, y0, x1, y1 = (np.concatenate([p[j] for p in parts]) if parts
                          else np.zeros(0, np.float32) for j in range(4))
        layer = np.repeat(layers, n).astype(np.int64)
        if t is not None:
            tl = t[layer]
            moved = (tl != IDENTITY).any(axis=1)
            tx0, ty0, tx1, ty1 = raster.transform_lines(x0, y0, x1, y1, tl)
            x0, y0 = np.where(moved, tx0, x0), np.where(moved, ty0, y0)
            x1, y1 = np.where(moved, tx1, x1), np.where(moved, ty1, y1)
        segs = raster.rasterize(x0, y0, x1, y1, layer.astype(np.uint32), s.width, s.height)
        linear = paint.paint_rows(segs, self.colors, self.even_odd, s.width, rows,
                                  s.clear, lowp)
        u8 = paint.pack_srgb(linear)
        out = {}
        for k, r in enumerate(rows):
            h = min(TILE, s.height - r * TILE)
            out[r] = u8[k * TILE:k * TILE + h, :s.width]
        return out
