"""`"update": "rotate"`: every layer turned about the frame's centre by
`angle` sin(2 pi i / `period_frames`) radians at frame i and scaled by
`scale`, the same transform for all of them (the mix's parameters).  The
frames repeat with the period; `scale` below 1 keeps the transform from
scaling up."""

from __future__ import annotations

import math

import numpy as np

from . import Update as Base


class Update(Base):
    def transforms(self, i: int):
        period = self.mix["period_frames"]
        a = self.mix["angle"] * math.sin(2.0 * math.pi * (i % period) / period)
        c = self.mix["scale"] * math.cos(a)
        s = self.mix["scale"] * math.sin(a)
        cx, cy = self.scene.width / 2.0, self.scene.height / 2.0
        row = np.asarray([c, s, -s, c, cx - c * cx + s * cy, cy - s * cx - c * cy],
                         np.float32)
        return np.tile(row, (self.scene.layers, 1))
