"""Procedural demo/benchmark scenes.

A copy of `forma_tpu/demos/scenes.py`: `circles`, `paris30k`,
`paris30k_styled`, `paris30k_textured` and `paris30k_svg_text`, with the
same seeds, so both packages build the same scenes (and the same SVG text,
byte for byte); and the port's own: the seeded mixes `styled_mix`, every
paint feature but textures, and `textured_mix`, texture fills among all
the others, and `SVG_SAMPLE`, a small SVG document that takes every part
of the parser's paint (groups, gradients, arcs, fill rules, a blend
mode).

`circles` mirrors the reference demo (`demo/src/demos/circles.rs`): N random
translucent circles built from rational quads.

`paris30k` synthesizes a paris-30k.svg-like city map — the reference's
headline benchmark asset (`README.md:97-106`) is not distributed, so the
benchmark scene is generated deterministically: ~30k paths of building
footprints, road polylines and park blobs with varied fills.
"""

from __future__ import annotations

import math

import numpy as np

from ..composition import Composition, Order
from ..math import AffineTransform, Point
from ..path import Path, PathBuilder
from ..styling import (
    BlendMode, Color, Fill, FillRule, Func, Gradient, GradientType, Image, Props,
    Style, Texture,
)

_WEIGHT = math.sqrt(2.0) / 2.0


def circle_path(x: float, y: float, radius: float) -> Path:
    return (
        PathBuilder()
        .move_to(Point(x + radius, y))
        .rat_quad_to(Point(x + radius, y - radius), Point(x, y - radius), _WEIGHT)
        .rat_quad_to(Point(x - radius, y - radius), Point(x - radius, y), _WEIGHT)
        .rat_quad_to(Point(x - radius, y + radius), Point(x, y + radius), _WEIGHT)
        .rat_quad_to(Point(x + radius, y + radius), Point(x + radius, y), _WEIGHT)
        .build()
    )


def circles(composition: Composition, count: int, width: int, height: int, seed=5555):
    """N random translucent circles (demo/src/demos/circles.rs:22-50)."""
    rng = np.random.default_rng(seed)
    for i in range(count):
        x = float(rng.uniform(0, width))
        y = float(rng.uniform(0, height))
        radius = float(rng.uniform(10.0, 50.0))
        color = Color(*[float(v) for v in rng.uniform(0, 1, 3)], 0.5)
        composition.get_mut_or_insert_default(Order(i)).insert(
            circle_path(x, y, radius)
        ).set_props(Props(func=Func.Draw(Style(fill=Fill.Solid(color)))))


def _polygon(xs, ys) -> Path:
    b = PathBuilder().move_to(Point(float(xs[0]), float(ys[0])))
    for x, y in zip(xs[1:], ys[1:]):
        b.line_to(Point(float(x), float(y)))
    return b.build()


def _paris30k_items(width, height, paths=30000, seed=30):
    """Geometry/color item stream shared by `paris30k` (direct composition)
    and `paris30k_svg_text` (SVG markup), so the two forms are the SAME
    scene and a parsed-SVG render can be differenced against the direct one.

    Yields ("poly", xs, ys, Color) and ("blob", (sx, sy), [(cp, end), ...],
    Color) in draw order.
    """
    rng = np.random.default_rng(seed)
    yield ("poly", [0, 0, width, width], [0, height, height, 0],
           Color(0.93, 0.91, 0.88, 1.0))

    n_buildings = int(paths * 0.7)
    n_roads = int(paths * 0.2)
    n_parks = paths - n_buildings - n_roads - 1

    # Buildings: rotated rectangles.
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
        xs = [cx[i] + ca[i] * a - sa[i] * b for a, b in zip(dx, dy)]
        ys = [cy[i] + sa[i] * a + ca[i] * b for a, b in zip(dx, dy)]
        yield ("poly", xs, ys,
               Color(shade[i], shade[i] * 0.95, shade[i] * 0.9, 1.0))

    # Roads: long thin quads.
    x0 = rng.uniform(-100, width + 100, n_roads)
    y0 = rng.uniform(-100, height + 100, n_roads)
    ang = rng.uniform(0, math.pi, n_roads)
    ln = rng.uniform(100, 600, n_roads)
    wd = rng.uniform(1.0, 4.0, n_roads)
    for i in range(n_roads):
        dx, dy = math.cos(ang[i]), math.sin(ang[i])
        nx, ny = -dy * wd[i], dx * wd[i]
        xs = [x0[i] + nx, x0[i] - nx, x0[i] + dx * ln[i] - nx, x0[i] + dx * ln[i] + nx]
        ys = [y0[i] + ny, y0[i] - ny, y0[i] + dy * ln[i] - ny, y0[i] + dy * ln[i] + ny]
        yield ("poly", xs, ys, Color(1.0, 1.0, 1.0, 0.9))

    # Parks: rounded blobs from quads.
    cx = rng.uniform(0, width, n_parks)
    cy = rng.uniform(0, height, n_parks)
    r = rng.uniform(8, 40, n_parks)
    sides = 5
    for i in range(n_parks):
        segs = []
        for s in range(1, sides + 1):
            a0 = 2 * math.pi * (s - 0.5) / sides
            a1 = 2 * math.pi * s / sides
            segs.append(
                (
                    (cx[i] + 1.4 * r[i] * math.cos(a0),
                     cy[i] + 1.4 * r[i] * math.sin(a0)),
                    (cx[i] + r[i] * math.cos(a1),
                     cy[i] + r[i] * math.sin(a1)),
                )
            )
        yield ("blob", (cx[i] + r[i], cy[i]), segs, Color(0.55, 0.75, 0.5, 0.85))


def paris30k(
    composition: Composition,
    width: int = 1920,
    height: int = 1080,
    paths: int = 30000,
    seed: int = 30,
):
    """Synthesized city-map stress scene with ~`paths` paths.

    Mix: 70% building footprints (quads, small), 20% road segments (long
    thin quads), 10% park blobs (quadratic-Bezier rounded polygons).
    """
    for order, it in enumerate(_paris30k_items(width, height, paths, seed)):
        color = it[3]
        if it[0] == "poly":
            path = _polygon(it[1], it[2])
        else:
            sx, sy = it[1]
            b = PathBuilder().move_to(Point(float(sx), float(sy)))
            for (cpx, cpy), (ex, ey) in it[2]:
                b.quad_to(Point(float(cpx), float(cpy)), Point(float(ex), float(ey)))
            path = b.build()
        composition.get_mut_or_insert_default(Order(order)).insert(path).set_props(
            Props(func=Func.Draw(Style(fill=Fill.Solid(color))))
        )


def _srgb8(v: float) -> int:
    """Linear [0,1] -> sRGB byte (inverse of svg.srgb_to_linear_color)."""
    v = min(max(float(v), 0.0), 1.0)
    s = 12.92 * v if v <= 0.0031308 else 1.055 * v ** (1.0 / 2.4) - 0.055
    return int(round(s * 255.0))


def paris30k_svg_text(
    width: int = 1920, height: int = 1080, paths: int = 30000, seed: int = 30
) -> str:
    """The paris30k scene as an SVG document string.

    Parsed back through `demos.svg.Svg`, this exercises the full SVG
    parser at benchmark scale end to end (reference analog: the svg demo
    loading paris-30k.svg, `demo/src/demos/svg.rs:870-878`; the asset
    itself is not distributed — see BASELINE.md).  Colors round-trip
    linear -> sRGB hex -> linear, so a parsed render differs from the
    direct scene only by 8-bit color quantization (~1/255)."""
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'width="{width}" height="{height}">'
    ]
    for it in _paris30k_items(width, height, paths, seed):
        c = it[3]
        fill = f"#{_srgb8(c.r):02x}{_srgb8(c.g):02x}{_srgb8(c.b):02x}"
        if it[0] == "poly":
            xs, ys = it[1], it[2]
            d = f"M{xs[0]:.6f},{ys[0]:.6f}" + "".join(
                f"L{x:.6f},{y:.6f}" for x, y in zip(xs[1:], ys[1:])
            )
        else:
            sx, sy = it[1]
            d = f"M{sx:.6f},{sy:.6f}" + "".join(
                f"Q{cpx:.6f},{cpy:.6f} {ex:.6f},{ey:.6f}"
                for (cpx, cpy), (ex, ey) in it[2]
            )
        op = f' fill-opacity="{c.a:.6f}"' if c.a != 1.0 else ""
        out.append(f'<path d="{d}" fill="{fill}"{op}/>')
    out.append("</svg>")
    return "\n".join(out)


# A 64x64 document that takes every part of the parser's paint: a rect, a
# group with a fill and an opacity, quads (q, t), an arc circle filled
# with a user-space linear gradient, and an even-odd cubic (C, S) under
# `mix-blend-mode: multiply`.
SVG_SAMPLE = """<svg xmlns="http://www.w3.org/2000/svg" width="64" height="64">
<rect x="4" y="4" width="56" height="56" fill="#e0e0ff"/>
<g fill="red" opacity="0.8">
  <path d="M 10 10 L 30 10 L 30 30 Z"/>
  <path d="M 35 35 q 10 -20 20 0 t -5 15 z" fill="#00aa44"/>
</g>
<linearGradient id="lg" gradientUnits="userSpaceOnUse" x1="0" y1="40" x2="64" y2="40">
  <stop offset="0%" stop-color="blue"/>
  <stop offset="100%" stop-color="yellow"/>
</linearGradient>
<path d="M 8 44 a 10 10 0 1 0 20 0 a 10 10 0 1 0 -20 0" fill="url(#lg)"/>
<path d="M 40 50 C 45 40 55 40 60 50 S 50 62 40 50" fill="purple"
      fill-rule="evenodd" style="mix-blend-mode: multiply"/>
</svg>"""

def paris30k_styled(
    composition: Composition,
    width: int = 1920,
    height: int = 1080,
    paths: int = 30000,
    seed: int = 30,
):
    """The gradient + blend-mode variant of `paris30k`
    (`forma_tpu/demos/scenes.py:51-167`).

    Same geometry mix and seed as `paris30k`, but: buildings fill with
    per-building linear gradients (facade shading), parks with radial
    gradients, and roads draw translucent white with BlendMode.Screen.
    """
    rng = np.random.default_rng(seed)

    composition.get_mut_or_insert_default(Order(0)).insert(
        _polygon([0, 0, width, width], [0, height, height, 0])
    ).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.93, 0.91, 0.88, 1.0)))))
    )

    order = 1
    n_buildings = int(paths * 0.7)
    n_roads = int(paths * 0.2)
    n_parks = paths - n_buildings - n_roads - 1

    # Buildings: rotated rectangles, linear-gradient facades.
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
        xs = [cx[i] + ca[i] * a - sa[i] * b for a, b in zip(dx, dy)]
        ys = [cy[i] + sa[i] * a + ca[i] * b for a, b in zip(dx, dy)]
        s = float(shade[i])
        g = Gradient(
            GradientType.Linear,
            Point(float(min(xs)), float(min(ys))),
            Point(float(max(xs)), float(max(ys))),
            (
                (Color(s, s * 0.95, s * 0.9, 1.0), 0.0),
                (Color(s * 0.75, s * 0.72, s * 0.7, 1.0), 1.0),
            ),
        )
        composition.get_mut_or_insert_default(Order(order)).insert(
            _polygon(xs, ys)
        ).set_props(Props(func=Func.Draw(Style(fill=Fill.Gradient(g)))))
        order += 1

    # Roads: long thin quads, Screen-blended.
    x0 = rng.uniform(-100, width + 100, n_roads)
    y0 = rng.uniform(-100, height + 100, n_roads)
    ang = rng.uniform(0, math.pi, n_roads)
    ln = rng.uniform(100, 600, n_roads)
    wd = rng.uniform(1.0, 4.0, n_roads)
    for i in range(n_roads):
        dx, dy = math.cos(ang[i]), math.sin(ang[i])
        nx, ny = -dy * wd[i], dx * wd[i]
        xs = [x0[i] + nx, x0[i] - nx, x0[i] + dx * ln[i] - nx, x0[i] + dx * ln[i] + nx]
        ys = [y0[i] + ny, y0[i] - ny, y0[i] + dy * ln[i] - ny, y0[i] + dy * ln[i] + ny]
        composition.get_mut_or_insert_default(Order(order)).insert(
            _polygon(xs, ys)
        ).set_props(
            Props(
                func=Func.Draw(
                    Style(
                        fill=Fill.Solid(Color(0.9, 0.9, 0.85, 0.9)),
                        blend_mode=BlendMode.Screen,
                    )
                )
            )
        )
        order += 1

    # Parks: rounded blobs, radial gradients.
    cx = rng.uniform(0, width, n_parks)
    cy = rng.uniform(0, height, n_parks)
    r = rng.uniform(8, 40, n_parks)
    for i in range(n_parks):
        b = PathBuilder().move_to(Point(float(cx[i] + r[i]), float(cy[i])))
        sides = 5
        for s in range(1, sides + 1):
            a0 = 2 * math.pi * (s - 0.5) / sides
            a1 = 2 * math.pi * s / sides
            b.quad_to(
                Point(
                    float(cx[i] + 1.4 * r[i] * math.cos(a0)),
                    float(cy[i] + 1.4 * r[i] * math.sin(a0)),
                ),
                Point(
                    float(cx[i] + r[i] * math.cos(a1)),
                    float(cy[i] + r[i] * math.sin(a1)),
                ),
            )
        g = Gradient(
            GradientType.Radial,
            Point(float(cx[i]), float(cy[i])),
            Point(float(cx[i] + r[i]), float(cy[i])),
            (
                (Color(0.65, 0.82, 0.58, 0.9), 0.0),
                (Color(0.45, 0.68, 0.42, 0.85), 1.0),
            ),
        )
        composition.get_mut_or_insert_default(Order(order)).insert(b.build()).set_props(
            Props(func=Func.Draw(Style(fill=Fill.Gradient(g))))
        )
        order += 1


def paris30k_textured(
    composition: Composition,
    width: int = 1920,
    height: int = 1080,
    paths: int = 30000,
    seed: int = 30,
):
    """The texture variant of `paris30k` (`forma_tpu/demos/scenes.py:
    177-281`): every building fills from a shared atlas of 8 distinct 32x32
    facade images, affine-mapped per building; roads and parks stay
    solid."""
    rng = np.random.default_rng(seed)

    composition.get_mut_or_insert_default(Order(0)).insert(
        _polygon([0, 0, width, width], [0, height, height, 0])
    ).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.93, 0.91, 0.88, 1.0)))))
    )

    # 8 shared facade textures (brick/plaster noise), interned once each.
    images = []
    for t in range(8):
        base = 0.45 + 0.05 * t
        px = rng.uniform(base * 200, base * 255, (32, 32, 3)).astype(np.uint8)
        rgba = np.concatenate(
            [px, np.full((32, 32, 1), 255, np.uint8)], axis=-1
        )
        images.append(Image.from_srgba(rgba.reshape(-1, 4), 32, 32))

    order = 1
    n_buildings = int(paths * 0.7)
    n_roads = int(paths * 0.2)
    n_parks = paths - n_buildings - n_roads - 1

    cx = rng.uniform(0, width, n_buildings)
    cy = rng.uniform(0, height, n_buildings)
    w = rng.uniform(3, 14, n_buildings)
    h = rng.uniform(3, 14, n_buildings)
    ang = rng.uniform(0, math.pi, n_buildings)
    ca, sa = np.cos(ang), np.sin(ang)
    for i in range(n_buildings):
        dx = [-w[i], -w[i], w[i], w[i]]
        dy = [-h[i], h[i], h[i], -h[i]]
        xs = [cx[i] + ca[i] * a - sa[i] * b for a, b in zip(dx, dy)]
        ys = [cy[i] + sa[i] * a + ca[i] * b for a, b in zip(dx, dy)]
        scale = 32.0 / max(2.0 * w[i], 2.0 * h[i])
        tex = Texture(
            transform=AffineTransform(
                ux=scale, vy=scale,
                tx=-float(min(xs)) * scale, ty=-float(min(ys)) * scale,
            ),
            image=images[i % len(images)],
        )
        composition.get_mut_or_insert_default(Order(order)).insert(
            _polygon(xs, ys)
        ).set_props(Props(func=Func.Draw(Style(fill=Fill.Texture(tex)))))
        order += 1

    x0 = rng.uniform(-100, width + 100, n_roads)
    y0 = rng.uniform(-100, height + 100, n_roads)
    ang = rng.uniform(0, math.pi, n_roads)
    ln = rng.uniform(100, 600, n_roads)
    wd = rng.uniform(1.0, 4.0, n_roads)
    for i in range(n_roads):
        dx, dy = math.cos(ang[i]), math.sin(ang[i])
        nx, ny = -dy * wd[i], dx * wd[i]
        xs = [x0[i] + nx, x0[i] - nx, x0[i] + dx * ln[i] - nx, x0[i] + dx * ln[i] + nx]
        ys = [y0[i] + ny, y0[i] - ny, y0[i] + dy * ln[i] - ny, y0[i] + dy * ln[i] + ny]
        composition.get_mut_or_insert_default(Order(order)).insert(
            _polygon(xs, ys)
        ).set_props(
            Props(func=Func.Draw(Style(fill=Fill.Solid(Color(1.0, 1.0, 1.0, 0.9)))))
        )
        order += 1

    cx = rng.uniform(0, width, n_parks)
    cy = rng.uniform(0, height, n_parks)
    r = rng.uniform(8, 40, n_parks)
    for i in range(n_parks):
        b = PathBuilder().move_to(Point(float(cx[i] + r[i]), float(cy[i])))
        sides = 5
        for s in range(1, sides + 1):
            a0 = 2 * math.pi * (s - 0.5) / sides
            a1 = 2 * math.pi * s / sides
            b.quad_to(
                Point(
                    float(cx[i] + 1.4 * r[i] * math.cos(a0)),
                    float(cy[i] + 1.4 * r[i] * math.sin(a0)),
                ),
                Point(
                    float(cx[i] + r[i] * math.cos(a1)),
                    float(cy[i] + r[i] * math.sin(a1)),
                ),
            )
        composition.get_mut_or_insert_default(Order(order)).insert(b.build()).set_props(
            Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.55, 0.75, 0.5, 0.85)))))
        )
        order += 1


def _star_or_blob(rng, cx, cy, rad) -> Path:
    """A star polygon (unsorted angles: self-intersecting) or a quad blob
    around (cx, cy)."""
    n = int(rng.integers(3, 8))
    ang = rng.uniform(0.0, 2.0 * math.pi, n)
    px = cx + rad * np.cos(ang)
    py = cy + rad * np.sin(ang)
    if rng.integers(0, 2):
        return _polygon(px, py)
    b = PathBuilder().move_to(Point(float(px[0]), float(py[0])))
    for j in range(1, n + 1):
        c = (cx + 1.3 * rad * math.cos(ang[j - 1] + 0.4),
             cy + 1.3 * rad * math.sin(ang[j - 1] + 0.4))
        b.quad_to(Point(*(float(v) for v in c)),
                  Point(float(px[j % n]), float(py[j % n])))
    return b.build()


def styled_mix(
    composition: Composition,
    layers: int = 400,
    width: int = 512,
    height: int = 512,
    seed: int = 7,
):
    """A seeded mix of every paint feature but textures: star polygons and
    quad blobs with both fill rules, solid and linear/radial gradient
    fills of 2-4 stops, all 16 blend modes (layer i draws with mode
    i % 16), about 20% clip layers governing the next 1-4 layers, and
    about a third of the draws clipped."""
    rng = np.random.default_rng(seed)
    modes = list(BlendMode)

    def color():
        return Color(*(float(v) for v in rng.uniform(0.0, 1.0, 3)),
                     float(rng.uniform(0.3, 1.0)))

    for i in range(layers):
        cx, cy = (float(v) for v in rng.uniform(0.0, [width, height]))
        rad = float(rng.uniform(12.0, 90.0))
        path = _star_or_blob(rng, cx, cy, rad)
        fill_rule = FillRule(int(rng.integers(0, 2)))
        if rng.random() < 0.2:
            props = Props(fill_rule=fill_rule, func=Func.Clip(int(rng.integers(1, 5))))
        else:
            if rng.integers(0, 2):
                stops = tuple(
                    (color(), float(s))
                    for s in np.sort(rng.uniform(0.0, 1.0, int(rng.integers(2, 5))))
                )
                kind = GradientType(int(rng.integers(0, 2)))
                end = (cx + float(rng.uniform(-rad, rad)), cy + float(rng.uniform(-rad, rad)))
                fill = Fill.Gradient(Gradient(kind, Point(cx, cy), Point(*end), stops))
            else:
                fill = Fill.Solid(color())
            props = Props(fill_rule=fill_rule, func=Func.Draw(Style(
                fill=fill, blend_mode=modes[i % len(modes)],
                is_clipped=bool(rng.random() < 0.35),
            )))
        composition.get_mut_or_insert_default(Order(i)).insert(path).set_props(props)


def textured_mix(
    composition: Composition,
    layers: int = 300,
    width: int = 512,
    height: int = 512,
    seed: int = 11,
):
    """A seeded mix with texture fills among every other paint feature:
    star polygons and quad blobs with both fill rules; about 60% of the
    layers fill from 6 images of odd, non-square sizes (1x7 to 13x5, some
    texels translucent) through rotated, scaled transforms whose texture
    coordinates run negative and past the image's last texel; about 10%
    linear/radial gradients, 10% solid fills and 20% clips governing the
    next 1-4 layers; every third draw blends with a non-Over mode and about
    a third of the draws are clipped."""
    rng = np.random.default_rng(seed)
    modes = list(BlendMode)
    images = []
    for w, h in ((5, 3), (7, 11), (13, 5), (1, 7), (9, 9), (3, 12)):
        px = rng.integers(0, 256, (h * w, 4)).astype(np.uint8)
        px[:, 3] = np.where(rng.random(h * w) < 0.7, 255, px[:, 3])
        images.append(Image.from_srgba(px, w, h))

    def color():
        return Color(*(float(v) for v in rng.uniform(0.0, 1.0, 3)),
                     float(rng.uniform(0.3, 1.0)))

    for i in range(layers):
        cx, cy = (float(v) for v in rng.uniform(0.0, [width, height]))
        rad = float(rng.uniform(0.03, 0.2) * max(width, height))
        path = _star_or_blob(rng, cx, cy, rad)
        fill_rule = FillRule(int(rng.integers(0, 2)))
        kind = rng.random()
        if kind < 0.2:
            props = Props(fill_rule=fill_rule, func=Func.Clip(int(rng.integers(1, 5))))
            composition.get_mut_or_insert_default(Order(i)).insert(path).set_props(props)
            continue
        if kind < 0.8:
            image = images[int(rng.integers(0, len(images)))]
            a = float(rng.uniform(0.0, 2.0 * math.pi))
            s = float(rng.uniform(0.02, 0.4))
            ux, uy = s * math.cos(a), s * math.sin(a)
            vx, vy = -s * math.sin(a), s * math.cos(a)
            # Centre the image on the shape, then shift it by up to its own
            # size either way: coordinates run below 0 and past max_x/max_y.
            w, h = image.width(), image.height()
            tx = -(cx * ux + cy * vx) + float(rng.uniform(-w, w))
            ty = -(cx * uy + cy * vy) + float(rng.uniform(-h, h))
            fill = Fill.Texture(Texture(
                transform=AffineTransform(ux=ux, uy=uy, vx=vx, vy=vy, tx=tx, ty=ty),
                image=image,
            ))
        elif kind < 0.9:
            stops = tuple(
                (color(), float(t))
                for t in np.sort(rng.uniform(0.0, 1.0, int(rng.integers(2, 5))))
            )
            gtype = GradientType(int(rng.integers(0, 2)))
            end = (cx + float(rng.uniform(-rad, rad)), cy + float(rng.uniform(-rad, rad)))
            fill = Fill.Gradient(Gradient(gtype, Point(cx, cy), Point(*end), stops))
        else:
            fill = Fill.Solid(color())
        mode = modes[int(rng.integers(1, len(modes)))] if i % 3 == 0 else BlendMode.Over
        props = Props(fill_rule=fill_rule, func=Func.Draw(Style(
            fill=fill, blend_mode=mode, is_clipped=bool(rng.random() < 0.35),
        )))
        composition.get_mut_or_insert_default(Order(i)).insert(path).set_props(props)
