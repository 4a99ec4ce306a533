"""Spaceship demo: a head-less variant of `demo/src/demos/spaceship.rs`.

A copy of `forma_tpu/demos/spaceship.py` on the port's own classes, with
the same seed, so both packages build and step the same scene.

Exercises the incremental-update machinery: actors (ship, asteroids,
bullets) are layers whose geometry is inserted once; every frame mutates
only transforms and z-orders (remove + insert), the workload that the damage
caches and cached flattening exist for.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..composition import Composition, Order
from ..math import AffineTransform, Point
from ..path import Path, PathBuilder
from ..styling import Color, Fill, Func, Props, Style


def _ship_path() -> Path:
    return (
        PathBuilder()
        .move_to(Point(0.0, -18.0))
        .line_to(Point(12.0, 14.0))
        .line_to(Point(0.0, 6.0))
        .line_to(Point(-12.0, 14.0))
        .build()
    )


def _asteroid_path(rng, radius: float) -> Path:
    b = PathBuilder()
    n = 9
    radii = radius * rng.uniform(0.7, 1.3, n)
    b.move_to(Point(float(radii[0]), 0.0))
    for i in range(1, n + 1):
        a = 2.0 * math.pi * i / n
        r = float(radii[i % n])
        b.line_to(Point(r * math.cos(a), r * math.sin(a)))
    return b.build()


def _bullet_path() -> Path:
    return (
        PathBuilder()
        .move_to(Point(-1.5, -5.0))
        .line_to(Point(-1.5, 5.0))
        .line_to(Point(1.5, 5.0))
        .line_to(Point(1.5, -5.0))
        .build()
    )


@dataclass
class Actor:
    layer: object
    x: float
    y: float
    vx: float
    vy: float
    rot: float = 0.0
    vrot: float = 0.0


@dataclass
class Spaceship:
    """Deterministic asteroids-like animation over a Composition."""

    width: int = 640
    height: int = 360
    n_asteroids: int = 24
    n_bullets: int = 8
    seed: int = 7
    actors: List[Actor] = field(default_factory=list)

    def build(self, composition: Composition):
        rng = np.random.default_rng(self.seed)

        order = 0
        for i in range(self.n_asteroids):
            layer = composition.get_mut_or_insert_default(Order(order))
            layer.insert(_asteroid_path(rng, float(rng.uniform(10, 30))))
            shade = float(rng.uniform(0.3, 0.6))
            layer.set_props(
                Props(
                    func=Func.Draw(
                        Style(fill=Fill.Solid(Color(shade, shade, shade, 1.0)))
                    )
                )
            )
            self.actors.append(
                Actor(
                    layer,
                    float(rng.uniform(0, self.width)),
                    float(rng.uniform(0, self.height)),
                    float(rng.uniform(-40, 40)),
                    float(rng.uniform(-40, 40)),
                    0.0,
                    float(rng.uniform(-2, 2)),
                )
            )
            order += 1

        for i in range(self.n_bullets):
            layer = composition.get_mut_or_insert_default(Order(order))
            layer.insert(_bullet_path())
            layer.set_props(
                Props(
                    func=Func.Draw(Style(fill=Fill.Solid(Color(1.0, 0.9, 0.2, 1.0))))
                )
            )
            self.actors.append(
                Actor(
                    layer,
                    self.width / 2,
                    self.height / 2,
                    float(rng.uniform(-150, 150)),
                    float(rng.uniform(-150, 150)),
                )
            )
            order += 1

        ship = composition.get_mut_or_insert_default(Order(order))
        ship.insert(_ship_path())
        ship.set_props(
            Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.9, 0.2, 0.2, 1.0)))))
        )
        self.actors.append(Actor(ship, self.width / 2, self.height / 2, 25.0, 12.0, 0.0, 1.2))

    def step(self, dt: float = 1.0 / 60.0):
        """Advances the animation; mutates only layer transforms."""
        for actor in self.actors:
            actor.x = (actor.x + actor.vx * dt) % self.width
            actor.y = (actor.y + actor.vy * dt) % self.height
            actor.rot += actor.vrot * dt
            c, s = math.cos(actor.rot), math.sin(actor.rot)
            actor.layer.set_transform(
                AffineTransform(ux=c, uy=s, vx=-s, vy=c, tx=actor.x, ty=actor.y)
            )
