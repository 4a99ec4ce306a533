"""Scenes as plain data, generated from a seed.

A scene module (`frame_bench/scenes/<name>.py`, named by a configuration's
`scene` key) has `build(config, seed) -> Scene`, and, where its layers
move by a rule of their own, `animator(scene, config, seed)`: an object
whose `step(dt)` advances the animation and returns every layer's
transform, f32 [L, 6].

A scene whose paint the benchmark's own `frame_bench.compose.compose` and
`frame_bench.reference.Reference` do not know (gradients, blend modes,
opacity...) brings its own, under the same names in its module;
`paint(name)` finds them, and the defaults for a module that defines
neither.  The contract:

- `compose(scene)` returns a `forma_tpu_torch.Composition`, built through
  the program's public API only, importing the program inside the call;
- `Reference(scene)` has `.scene`, whose `width` and `height` give the
  frame's size, and `rows(transforms, rows, lowp=None)`, which returns
  {tile row: u8 [h, width, 4]} of the frame whose layer i has transform
  `transforms[i]` (None: none), `h` the tile row's pixel rows (16, fewer
  in the last).  It honours `lowp`, a function rounding an f32 array to a
  lower precision, by holding its paint in it between operations: the
  comparison's control passes `round_bf16` through it;
- the reference imports nothing of the program (`forma_tpu_torch`), of
  the JAX package (`forma_tpu`) or of JAX;
- `build` may return a subclass of `Scene` with fields of its own, which
  only its own `compose` and `Reference` read: `check.Keeper` and
  `check.compare` read `width` and `height` alone, and the harness, its
  entries and its updates besides them `clear` and `layers`.
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


def paint(name: str):
    """(compose, Reference) of scene module `name`: its own where it
    defines them, the benchmark's solid-fill ones where it does not."""
    from ..compose import compose
    from ..reference import Reference

    mod = module(name)
    return getattr(mod, "compose", compose), getattr(mod, "Reference", Reference)
