"""The paris30k city map zoomed: built at the base size (`width / scale` x
`height / scale`) and every point multiplied by `scale`, onto a `width` x
`height` frame, as upstream's svg demo draws a document with `svg FILE -s
SCALE` (google/forma `demo/src/main.rs:63-94`).

The same seed gives `paris30k`'s map at the base size, zoomed: the same
layers, colours and fill rules, each line crossing `scale` times the
pixels.  Solid fills and Over, so the benchmark's own `compose` and
`Reference` paint it.
"""

from __future__ import annotations

from dataclasses import replace

from . import Scene, paris30k


def build(config: dict, seed: int) -> Scene:
    width, height, scale = config["width"], config["height"], config["scale"]
    if width % scale or height % scale:
        raise ValueError(f"{width}x{height} is not a whole zoom by {scale}")
    base = paris30k.build(dict(config, width=width // scale, height=height // scale), seed)
    paths = [(verbs, [p * scale for p in points]) for verbs, points in base.paths]
    return replace(base, width=width, height=height, paths=paths)
