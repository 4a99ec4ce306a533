"""The program's entry points a frame goes through, one module each, found
by the name a mix gives under `entry` (`frame_bench/entries/<name>.py`).

A module defines `Entry`, a subclass of the `Entry` here, built as
`Entry(mix, scene, comp, renderer)`.  `render()` renders the next frame
and returns the pixels that are on the host when it returns, u8
[H, W, 4]: those of the frame `lag` frames before it (None while there is
none yet).  `finish()` completes any frame still in flight and returns its
pixels (None where none is).  Pixels in a buffer the entry reuses are a
view the next frame overwrites.
"""

from __future__ import annotations

import importlib


class Entry:
    lag = 0

    def __init__(self, mix: dict, scene, comp, renderer):
        from forma_tpu_torch import Color

        self.mix = mix
        self.scene = scene
        self.comp = comp
        self.renderer = renderer
        self.clear = Color(*scene.clear)

    def render(self):
        raise NotImplementedError

    def finish(self):
        return None


def load(name: str):
    """The `Entry` class of `entries/<name>.py`."""
    return importlib.import_module(f"{__name__}.{name}").Entry
