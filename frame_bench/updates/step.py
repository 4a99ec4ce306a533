"""`"update": "step"`: the scene's own animation (its module's `animator`)
advanced by the mix's `dt` seconds a frame."""

from __future__ import annotations

from ..scenes import module
from . import Update as Base


class Update(Base):
    def __init__(self, mix: dict, scene, config: dict, seed: int):
        super().__init__(mix, scene, config, seed)
        self.animator = module(config["scene"]).animator(scene, config, seed)

    def transforms(self, i: int):
        return self.animator.step(self.mix["dt"])
