"""`"entry": "render"`: `Renderer.render`, a new u8 array a frame."""

from __future__ import annotations

from . import Entry as Base


class Entry(Base):
    def render(self):
        return self.renderer.render(self.comp, self.scene.width, self.scene.height, self.clear)
