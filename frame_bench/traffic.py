"""The one generator of traffic: a mix file's parameters turned into the
frames a closed loop renders.

A mix (`frame_bench/mixes/<name>.json`) is data.  It names the frame's
`entry` into the program (`entries/<entry>.py`: `render`, or
`render_into` with or without a `layer_cache`) and its per-frame
`update` (`updates/<update>.py`: `none` or `step`, the scene's
own animation), with their parameters, and `warmup_frames`: frames
rendered before the window, in set-up (a periodic update warms a whole
period, so the window repeats only transforms already seen).  A new kind
of entry or update is a new module there, found by its name.
"""

from __future__ import annotations

from . import entries, updates


def motion(mix: dict, scene, config: dict, seed: int):
    """The mix's update: the layers' transforms frame by frame, as plain
    data apart from the program (`updates.Update`)."""
    return updates.load(mix.get("update", "none"))(mix, scene, config, seed)


class Traffic:
    """One frame after another: the update's transforms, applied to the
    composition, then the entry's render."""

    def __init__(self, mix: dict, scene, config: dict, seed: int, comp, renderer):
        self.scene = scene
        self.comp = comp
        self.motion = motion(mix, scene, config, seed)
        self.entry = entries.load(mix["entry"])(mix, scene, comp, renderer)
        self.lag = self.entry.lag

    def transforms(self, i: int):
        return self.motion.transforms(i)

    def apply(self, t) -> None:
        self.motion.apply(self.comp, t)

    def render(self):
        """Renders one frame; returns the pixels the entry has on the host
        (those of the frame `lag` frames back; None while there is none)."""
        return self.entry.render()

    def finish(self):
        """Completes a frame still in flight; returns its pixels or None."""
        return self.entry.finish()
