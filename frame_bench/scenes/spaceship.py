"""The upstream incremental demo (google/forma `demo/src/demos/
spaceship.rs`), head-less: asteroids, bullets and a ship, each a layer
whose geometry is inserted once and whose transform changes every frame.

A frozen copy of the renderer's version (`forma_tpu_torch/demos/
spaceship.py`), seeded by the run's seed, as plain data: the paths and
colours, and an animator that steps every actor and returns the layers'
transforms.  Every seed gives the same actors and shapes of path;
sizes, shades, positions and speeds change.
"""

from __future__ import annotations

import math

import numpy as np

from . import Scene


def _asteroid(rng, radius: float):
    n = 9
    radii = radius * rng.uniform(0.7, 1.3, n)
    pts = [float(radii[0]), 0.0]
    for i in range(1, n + 1):
        a = 2.0 * math.pi * i / n
        r = float(radii[i % n])
        pts += [r * math.cos(a), r * math.sin(a)]
    return ("M" + "L" * n, pts)


_BULLET = ("MLLL", [-1.5, -5.0, -1.5, 5.0, 1.5, 5.0, 1.5, -5.0])
_SHIP = ("MLLL", [0.0, -18.0, 12.0, 14.0, 0.0, 6.0, -12.0, 14.0])


def _actors(config: dict, seed: int):
    """(paths, colours, actors): an actor is [x, y, vx, vy, rot, vrot]."""
    width, height = config["width"], config["height"]
    rng = np.random.default_rng(seed)
    paths, colors, actors = [], [], []
    for _ in range(config["asteroids"]):
        paths.append(_asteroid(rng, float(rng.uniform(10, 30))))
        shade = float(rng.uniform(0.3, 0.6))
        colors.append((shade, shade, shade, 1.0))
        actors.append([float(rng.uniform(0, width)), float(rng.uniform(0, height)),
                       float(rng.uniform(-40, 40)), float(rng.uniform(-40, 40)),
                       0.0, float(rng.uniform(-2, 2))])
    for _ in range(config["bullets"]):
        paths.append(_BULLET)
        colors.append((1.0, 0.9, 0.2, 1.0))
        actors.append([width / 2, height / 2, float(rng.uniform(-150, 150)),
                       float(rng.uniform(-150, 150)), 0.0, 0.0])
    paths.append(_SHIP)
    colors.append((0.9, 0.2, 0.2, 1.0))
    actors.append([width / 2, height / 2, 25.0, 12.0, 0.0, 1.2])
    return paths, colors, actors


def build(config: dict, seed: int) -> Scene:
    paths, colors, _ = _actors(config, seed)
    return Scene(config["width"], config["height"], paths,
                 np.asarray(colors, np.float32), np.zeros(len(paths), bool),
                 tuple(config["clear"]))


class Animator:
    """Steps every actor (wrapping at the frame's edges, spinning at its
    own rate) and gives the layers' transforms."""

    def __init__(self, config: dict, seed: int):
        self.width, self.height = config["width"], config["height"]
        self.actors = _actors(config, seed)[2]

    def step(self, dt: float) -> np.ndarray:
        out = np.empty((len(self.actors), 6), np.float32)
        for i, a in enumerate(self.actors):
            a[0] = (a[0] + a[2] * dt) % self.width
            a[1] = (a[1] + a[3] * dt) % self.height
            a[4] += a[5] * dt
            c, s = math.cos(a[4]), math.sin(a[4])
            out[i] = (c, s, -s, c, a[0], a[1])
        return out


def animator(scene: Scene, config: dict, seed: int) -> Animator:
    return Animator(config, seed)
