"""Scenes as plain data, generated from a seed.

A scene module (`frame_bench/scenes/<name>.py`, named by a configuration's
`scene` key) has `build(config, seed) -> Scene`, and, where its layers
move by a rule of their own, `animator(scene, config, seed)`: an object
whose `step(dt)` advances the animation and returns every layer's
transform, f32 [L, 6].
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class Scene:
    """A frame's content: layer i is drawn at order i.

    `paths[i]` is `(verbs, points)`: verbs a string of "M", "L" and "Q",
    points a flat list of floats (two per "M" and "L", four per "Q");
    every contour closes.  `colors` f32 [L, 4] linear RGBA solid fills,
    `even_odd` bool [L] (False: the nonzero rule), `clear` the clear
    colour (linear RGBA)."""

    width: int
    height: int
    paths: List[Tuple[str, list]]
    colors: np.ndarray
    even_odd: np.ndarray
    clear: Tuple[float, float, float, float]

    @property
    def layers(self) -> int:
        return len(self.paths)


def module(name: str):
    return importlib.import_module(f"{__name__}.{name}")
