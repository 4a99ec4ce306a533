"""Per-frame scene updates, one module a kind, found by the name a mix
gives under `update` (`frame_bench/updates/<name>.py`).

A module defines `Update`, a subclass of the `Update` here, built as
`Update(mix, scene, config, seed)`.  `transforms(i)` gives every layer's
transform at frame i (f32 [L, 6]; None where nothing moves) as plain
data, which the control and the reference read too; `apply(comp, t)`
hands them to the program's composition.  Frames are asked for in order.
"""

from __future__ import annotations

import importlib

import numpy as np


class Update:
    """Nothing moves."""

    def __init__(self, mix: dict, scene, config: dict, seed: int):
        self.mix = mix
        self.scene = scene
        self._layers = None

    def transforms(self, i: int):
        return None

    def apply(self, comp, t) -> None:
        """`t` into the composition, as the mix's `apply` says: `"bulk"`
        (the default), one `Composition.set_transforms` of every layer, or
        `"per_layer"`, one `Layer.set_transform` a layer."""
        from forma_tpu_torch import Order

        if self._layers is None:
            self._orders = np.arange(self.scene.layers, dtype=np.uint32)
            self._layers = [comp.get_mut(Order(i)) for i in range(self.scene.layers)]
        if self.mix.get("apply", "bulk") == "bulk":
            comp.set_transforms(self._orders, t)
        else:
            for layer, row in zip(self._layers, t.tolist()):
                layer.set_transform(row)


def load(name: str):
    """The `Update` class of `updates/<name>.py`."""
    return importlib.import_module(f"{__name__}.{name}").Update
