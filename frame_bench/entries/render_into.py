"""`"entry": "render_into"`: `Renderer.render_into`, synchronous, into one
`Buffer` reused every frame; with the mix's `layer_cache`, the buffer
carries a damage cache (`Renderer.create_buffer_layer_cache`)."""

from __future__ import annotations

import numpy as np

from . import Entry as Base


class Entry(Base):
    def __init__(self, mix: dict, scene, comp, renderer):
        from forma_tpu_torch import BufferBuilder, LinearLayout

        super().__init__(mix, scene, comp, renderer)
        w, h = scene.width, scene.height
        self.pixels = np.zeros((h, w * 4), np.uint8)
        b = BufferBuilder(self.pixels, LinearLayout(w, w * 4, h))
        if mix.get("layer_cache"):
            b = b.layer_cache(renderer.create_buffer_layer_cache())
        self.buffer = b.build()

    def render(self):
        self.renderer.render_into(self.comp, self.buffer, self.clear)
        return self.pixels.reshape(self.scene.height, self.scene.width, 4)
