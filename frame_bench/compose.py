"""A plain scene into the program's `Composition`, through its public API
(`PathBuilder`, `Layer.insert`, `set_props`): layer i at `Order(i)`."""

from __future__ import annotations


def compose(scene):
    from forma_tpu_torch import (Color, Composition, Fill, FillRule, Func, Order,
                                 PathBuilder, Point, Props, Style)

    comp = Composition()
    for i, (verbs, pts) in enumerate(scene.paths):
        b = PathBuilder()
        k = 0
        for verb in verbs:
            if verb == "M":
                b.move_to(Point(pts[k], pts[k + 1]))
                k += 2
            elif verb == "L":
                b.line_to(Point(pts[k], pts[k + 1]))
                k += 2
            else:
                b.quad_to(Point(pts[k], pts[k + 1]), Point(pts[k + 2], pts[k + 3]))
                k += 4
        rule = FillRule.EvenOdd if scene.even_odd[i] else FillRule.NonZero
        color = Color(*(float(v) for v in scene.colors[i]))
        comp.get_mut_or_insert_default(Order(i)).insert(b.build()).set_props(
            Props(fill_rule=rule, func=Func.Draw(Style(fill=Fill.Solid(color)))))
    return comp
