"""A synthesized paris-30k city map, the upstream svg demo's headline asset
(google/forma `README.md`, `demo/src/demos/svg.rs` on `paris-30k.svg`),
which is not distributed.

A frozen copy of the renderer's stand-in (`forma_tpu_torch/demos/
scenes.py`, `_paris30k_items`), seeded by the run's seed: one background
rectangle, then 70% building footprints (small rotated rectangles), 20%
roads (long thin quads, some off the viewport) and the rest park blobs of
five quadratic curves; solid fills, the nonzero rule, Over.  Every seed
gives the same counts of each kind; positions, sizes and shades change.
"""

from __future__ import annotations

import math

import numpy as np

from . import Scene


def build(config: dict, seed: int) -> Scene:
    width, height, n = config["width"], config["height"], config["paths"]
    rng = np.random.default_rng(seed)
    paths, colors = [], []

    def poly(xs, ys, color):
        pts = []
        for x, y in zip(xs, ys):
            pts += [float(x), float(y)]
        paths.append(("M" + "L" * (len(xs) - 1), pts))
        colors.append(color)

    poly([0, 0, width, width], [0, height, height, 0], (0.93, 0.91, 0.88, 1.0))
    n_buildings = int(n * config["buildings"])
    n_roads = int(n * config["roads"])
    n_parks = n - n_buildings - n_roads - 1

    cx = rng.uniform(0, width, n_buildings)
    cy = rng.uniform(0, height, n_buildings)
    w = rng.uniform(3, 14, n_buildings)
    h = rng.uniform(3, 14, n_buildings)
    ang = rng.uniform(0, math.pi, n_buildings)
    ca, sa = np.cos(ang), np.sin(ang)
    shade = rng.uniform(0.55, 0.8, n_buildings)
    for i in range(n_buildings):
        dx = [-w[i], -w[i], w[i], w[i]]
        dy = [-h[i], h[i], h[i], -h[i]]
        poly([cx[i] + ca[i] * a - sa[i] * b for a, b in zip(dx, dy)],
             [cy[i] + sa[i] * a + ca[i] * b for a, b in zip(dx, dy)],
             (shade[i], shade[i] * 0.95, shade[i] * 0.9, 1.0))

    x0 = rng.uniform(-100, width + 100, n_roads)
    y0 = rng.uniform(-100, height + 100, n_roads)
    ang = rng.uniform(0, math.pi, n_roads)
    ln = rng.uniform(100, 600, n_roads)
    wd = rng.uniform(1.0, 4.0, n_roads)
    for i in range(n_roads):
        dx, dy = math.cos(ang[i]), math.sin(ang[i])
        nx, ny = -dy * wd[i], dx * wd[i]
        poly([x0[i] + nx, x0[i] - nx, x0[i] + dx * ln[i] - nx, x0[i] + dx * ln[i] + nx],
             [y0[i] + ny, y0[i] - ny, y0[i] + dy * ln[i] - ny, y0[i] + dy * ln[i] + ny],
             (1.0, 1.0, 1.0, 0.9))

    cx = rng.uniform(0, width, n_parks)
    cy = rng.uniform(0, height, n_parks)
    r = rng.uniform(8, 40, n_parks)
    sides = 5
    for i in range(n_parks):
        pts = [float(cx[i] + r[i]), float(cy[i])]
        for s in range(1, sides + 1):
            a0 = 2 * math.pi * (s - 0.5) / sides
            a1 = 2 * math.pi * s / sides
            pts += [float(cx[i] + 1.4 * r[i] * math.cos(a0)),
                    float(cy[i] + 1.4 * r[i] * math.sin(a0)),
                    float(cx[i] + r[i] * math.cos(a1)), float(cy[i] + r[i] * math.sin(a1))]
        paths.append(("M" + "Q" * sides, pts))
        colors.append((0.55, 0.75, 0.5, 0.85))

    return Scene(width, height, paths, np.asarray(colors, np.float32),
                 np.zeros(len(paths), bool), tuple(config["clear"]))
