"""Carries the JAX package's scene and frame state across to the port.

`composition_from_jax` rebuilds a `forma_tpu.Composition` as a port
`Composition`; `from_jax_args` takes the argument tuple that
`__graft_entry__._prep` builds for `pipeline.render_frame`.  Both read the
JAX package's objects by attribute only, so the port still imports nothing
of `forma_tpu`: the tests use them to put one scene into both packages.
"""

from __future__ import annotations

import numpy as np

from .composition import Composition, Order
from .math import AffineTransform, Point
from .ops._u32 import from_numpy
from .styling import (
    BlendMode,
    Color,
    Fill,
    FillRule,
    Func,
    Gradient,
    GradientType,
    Image,
    Props,
    Style,
    Texture,
)


def from_jax_args(args, device):
    """(px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear) of
    numpy arrays (st a dict of them) -> the same state as tensors on
    `device` in the port's conventions: u32 leaves widen to int64
    (`ops/_u32.py`)."""
    px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear = args
    flat = [
        from_numpy(np.asarray(a), device)
        for a in (px, py, line_slot, g_slot, g_valid, g_t, g_has_t)
    ]
    st_t = {k: from_numpy(np.asarray(v), device) for k, v in st.items()}
    return (*flat, st_t, from_numpy(np.asarray(clear), device))


class _PropsFromJax:
    """Rebuilds JAX-package props as the port's, field by field; one JAX
    `Image` maps to one port `Image` (images intern by identity)."""

    def __init__(self):
        self._images = {}

    def color(self, c) -> Color:
        return Color(c.r, c.g, c.b, c.a)

    def transform(self, t) -> AffineTransform:
        return AffineTransform(t.ux, t.uy, t.vx, t.vy, t.tx, t.ty)

    def image(self, im) -> Image:
        if id(im) not in self._images:
            # The texels were quantised on the JAX side; the constructor
            # takes them as they are.  `im` stays referenced, so its id
            # stays unique while the map lives.
            self._images[id(im)] = (im, Image(im.data, im.width(), im.height()))
        return self._images[id(im)][1]

    def fill(self, f) -> Fill:
        if f.kind == Fill.SOLID:
            return Fill.Solid(self.color(f.color))
        if f.kind == Fill.GRADIENT:
            g = f.gradient
            return Fill.Gradient(Gradient(
                GradientType(g.type.value),
                Point(g.start.x, g.start.y),
                Point(g.end.x, g.end.y),
                tuple((self.color(c), s) for c, s in g.stops),
            ))
        t = f.texture
        return Fill.Texture(Texture(self.transform(t.transform), self.image(t.image)))

    def props(self, p) -> Props:
        if p.func.kind == Func.CLIP:
            func = Func.Clip(p.func.clip)
        else:
            s = p.func.style
            func = Func.Draw(Style(
                is_clipped=s.is_clipped,
                fill=self.fill(s.fill),
                blend_mode=BlendMode(s.blend_mode.value),
            ))
        return Props(fill_rule=FillRule(p.fill_rule.value), func=func)


def composition_from_jax(comp) -> Composition:
    """A port `Composition` holding `comp`'s layers (a `forma_tpu`
    Composition): each layer's order, props, transform and enabled flag,
    and the flattened segments of `comp`'s segment buffer point for point
    (ids renumbered to the port's geometry ids; points of geometry no
    layer of `comp` owns get fresh ids that no port layer owns)."""
    out = Composition()
    conv = _PropsFromJax()
    jshared = comp._shared
    remap = {}
    for order, layer in comp.layers_iter():
        new = out.get_mut_or_insert_default(Order(order.as_u32()))
        jgid = int(layer.geom_id())
        gid = new.geom_id()
        remap[jgid] = int(gid)
        new.set_props(conv.props(layer.props))
        t = layer.transform()
        if t is not None:
            new.set_transform(conv.transform(t.t))
        new.set_is_enabled(layer.is_enabled())
        new.lines_count = layer.lines_count
        if jgid in jshared.geom_id_to_slot:
            out._shared.geom_id_to_slot[gid] = new._slot
            out._shared.geom_id_to_order[gid] = new.order

    x, y, ids = comp.shared_segment_buffer().flat()
    if len(x):
        uniq = np.unique(ids[ids != 0])
        new_uniq = np.asarray(
            [remap[int(u)] if int(u) in remap else int(out._shared.new_geom_id())
             for u in uniq] + [0],
            np.int64,
        )
        pos = np.where(ids != 0, np.searchsorted(uniq, ids), len(uniq))
        new_ids = new_uniq[pos]
        buf = out.shared_segment_buffer()
        buf._x.append(np.array(x, np.float32))
        buf._y.append(np.array(y, np.float32))
        buf._ids.append(new_ids)
        buf._invalidate()
        out._shared.scene_version += 1
    return out
