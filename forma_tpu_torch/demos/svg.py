"""Non-compliant SVG renderer (the counterpart of `demo/src/demos/svg.rs`).

Parses <g>/<path>/<rect>/<linearGradient>/<radialGradient>/<stop> with full
path data — all of M/L/H/V/C/S/Q/T/A/Z in absolute and relative forms,
elliptical arcs converted to rational quads — fill/fill-rule/opacity/
mix-blend-mode attributes, group transform/fill/opacity stacks, and
user-space gradients.  Pure stdlib (xml.etree + re); no external SVG crates.

A copy of `forma_tpu/demos/svg.py` on the port's own scene model
(`composition`, `math`, `path`, `styling`): the same parse gives the same
paths, fills and blend modes, so both packages compose the same scene.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..composition import Composition, Order
from ..math import AffineTransform, GeomPresTransform, Point
from ..path import Path, PathBuilder
from ..styling import (
    BlendMode,
    Color,
    Fill,
    FillRule,
    Func,
    Gradient,
    GradientBuilder,
    GradientType,
    Props,
    Style,
)

# -- low-level parsing --------------------------------------------------------

_NUM = re.compile(
    r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
)

_NAMED_COLORS = {
    "black": (0, 0, 0),
    "white": (255, 255, 255),
    "red": (255, 0, 0),
    "green": (0, 128, 0),
    "blue": (0, 0, 255),
    "yellow": (255, 255, 0),
    "cyan": (0, 255, 255),
    "magenta": (255, 0, 255),
    "gray": (128, 128, 128),
    "grey": (128, 128, 128),
    "orange": (255, 165, 0),
    "purple": (128, 0, 128),
    "brown": (165, 42, 42),
    "pink": (255, 192, 203),
    "lime": (0, 255, 0),
    "navy": (0, 0, 128),
    "teal": (0, 128, 128),
    "silver": (192, 192, 192),
    "maroon": (128, 0, 0),
    "olive": (128, 128, 0),
}


def parse_color(value: str) -> Optional[Tuple[int, int, int]]:
    """Parses an sRGB color attribute; returns (r, g, b) bytes or None."""
    if not value:
        return None
    value = value.strip()
    if value == "none":
        return None
    if value.startswith("#"):
        h = value[1:]
        if len(h) == 3:
            return tuple(int(ch * 2, 16) for ch in h)
        if len(h) == 6:
            return tuple(int(h[i : i + 2], 16) for i in (0, 2, 4))
        return None
    if value.startswith("rgb"):
        nums = _NUM.findall(value)
        if len(nums) >= 3:
            vals = []
            for n in nums[:3]:
                v = float(n)
                if "%" in value:
                    v = v * 255.0 / 100.0
                vals.append(int(max(0, min(255, round(v)))))
            return tuple(vals)
        return None
    return _NAMED_COLORS.get(value.lower())


def srgb_to_linear_color(rgb: Tuple[int, int, int], alpha: float = 1.0) -> Color:
    """Byte sRGB -> linear Color (demo/src/main.rs:134-151)."""

    def lin(c: int) -> float:
        v = c / 255.0
        if v <= 0.04045:
            return v / 12.92
        return ((v + 0.055) / 1.055) ** 2.4

    return Color(lin(rgb[0]), lin(rgb[1]), lin(rgb[2]), alpha)


def parse_transform(value: str) -> Optional[AffineTransform]:
    """Parses an SVG transform list into one affine transform."""
    if not value:
        return None
    m = np.eye(3, dtype=np.float64)
    for name, argstr in re.findall(r"(\w+)\s*\(([^)]*)\)", value):
        args = [float(v) for v in _NUM.findall(argstr)]
        t = np.eye(3)
        if name == "matrix" and len(args) == 6:
            a, b, c, d, e, f = args
            t = np.array([[a, c, e], [b, d, f], [0, 0, 1]])
        elif name == "translate":
            tx = args[0]
            ty = args[1] if len(args) > 1 else 0.0
            t = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]])
        elif name == "scale":
            sx = args[0]
            sy = args[1] if len(args) > 1 else sx
            t = np.array([[sx, 0, 0], [0, sy, 0], [0, 0, 1]])
        elif name == "rotate":
            a = math.radians(args[0])
            ca, sa = math.cos(a), math.sin(a)
            t = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
            if len(args) == 3:
                cx, cy = args[1], args[2]
                pre = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]])
                post = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
                t = pre @ t @ post
        elif name == "skewX":
            t = np.array([[1, math.tan(math.radians(args[0])), 0], [0, 1, 0], [0, 0, 1]])
        elif name == "skewY":
            t = np.array([[1, 0, 0], [math.tan(math.radians(args[0])), 1, 0], [0, 0, 1]])
        m = m @ t
    return AffineTransform(
        ux=float(m[0, 0]), vx=float(m[0, 1]), tx=float(m[0, 2]),
        uy=float(m[1, 0]), vy=float(m[1, 1]), ty=float(m[1, 2]),
    )


_BLEND_MODES = {
    "normal": BlendMode.Over,
    "multiply": BlendMode.Multiply,
    "screen": BlendMode.Screen,
    "overlay": BlendMode.Overlay,
    "darken": BlendMode.Darken,
    "lighten": BlendMode.Lighten,
    "color-dodge": BlendMode.ColorDodge,
    "color-burn": BlendMode.ColorBurn,
    "hard-light": BlendMode.HardLight,
    "soft-light": BlendMode.SoftLight,
    "difference": BlendMode.Difference,
    "exclusion": BlendMode.Exclusion,
    "hue": BlendMode.Hue,
    "saturation": BlendMode.Saturation,
    "color": BlendMode.Color,
    "luminosity": BlendMode.Luminosity,
}


def parse_blend_mode(style_attr: str) -> BlendMode:
    for decl in (style_attr or "").split(";"):
        if ":" in decl:
            k, v = decl.split(":", 1)
            if k.strip() == "mix-blend-mode":
                return _BLEND_MODES.get(v.strip(), BlendMode.Over)
    return BlendMode.Over


# -- path data ---------------------------------------------------------------

_PATH_TOKEN = re.compile(r"([MmLlHhVvCcSsQqTtAaZz])|" + _NUM.pattern)

_ARG_COUNTS = dict(m=2, l=2, h=1, v=1, c=6, s=4, q=4, t=2, a=7)


def _tokenize_path(d: str):
    """Yields (command, args) with implicit command repetition."""
    tokens = _PATH_TOKEN.finditer(d)
    nums: List[float] = []
    cmd = None
    for tok in tokens:
        if tok.group(1):
            if cmd is not None and nums:
                yield cmd, nums
                nums = []
            cmd = tok.group(1)
            if cmd in "Zz":
                yield cmd, []
                cmd = None
        else:
            nums.append(float(tok.group(0)))
            need = _ARG_COUNTS.get(cmd.lower() if cmd else "", 0)
            if cmd is not None and len(nums) == need:
                yield cmd, nums
                nums = []
                # Implicit repetition; MoveTo repeats as LineTo.
                if cmd == "M":
                    cmd = "L"
                elif cmd == "m":
                    cmd = "l"
    if cmd is not None and nums:
        yield cmd, nums


def _reflect(point: Point, against: Point) -> Point:
    return Point(against.x * 2.0 - point.x, against.y * 2.0 - point.y)


@dataclass
class _Arc:
    cx: float
    cy: float
    rx: float
    ry: float
    x_axis_rotation: float
    angle: float
    angle_delta: float


def _convert_to_center(rx, ry, phi, large_arc, sweep, x0, y0, x1, y1) -> Optional[_Arc]:
    """Endpoint -> center arc parameterisation (svg.rs:42-116)."""
    if abs(x0 - x1) < 1.19e-7 and abs(y0 - y1) < 1.19e-7:
        return None
    rx, ry = abs(rx), abs(ry)
    if rx == 0.0 or ry == 0.0:
        return None

    cos_phi = math.cos(phi)
    sin_phi = math.sin(phi)

    # NOTE: mirrors the reference's sequential reuse of x0/x1 (svg.rs:67-71).
    x0 = (x0 * cos_phi + y0 * sin_phi) / rx
    y0 = (-x0 * sin_phi + y0 * cos_phi) / ry
    x1 = (x1 * cos_phi + y1 * sin_phi) / rx
    y1 = (-x1 * sin_phi + y1 * cos_phi) / ry

    lx = (x0 - x1) * 0.5
    ly = (y0 - y1) * 0.5
    cx = (x0 + x1) * 0.5
    cy = (y0 + y1) * 0.5

    len_squared = lx * lx + ly * ly
    if len_squared < 1.0:
        radicand = math.sqrt((1.0 - len_squared) / len_squared)
        if large_arc != sweep:
            radicand = -radicand
        cx += -ly * radicand
        cy += lx * radicand

    theta = math.atan2(y0 - cy, x0 - cx)
    delta_theta = math.atan2(y1 - cy, x1 - cx) - theta

    cxs = cx * rx
    cys = cy * ry
    cx = cxs * cos_phi - cys * sin_phi
    cy = cxs * sin_phi + cys * cos_phi

    if sweep:
        if delta_theta < 0.0:
            delta_theta += math.pi * 2.0
    elif delta_theta > 0.0:
        delta_theta -= math.pi * 2.0

    return _Arc(cx, cy, rx, ry, phi, theta, delta_theta)


class Svg:
    """Loads an SVG file into (path, fill_rule, fill, blend_mode) tuples and
    composes them as one layer per path; arrow-key pans reuse cached
    flattening via GeomPresTransform (svg.rs:879-923)."""

    def __init__(self, path_or_text, scale: float = 1.0):
        self.paths: List[Tuple[Path, FillRule, Fill, BlendMode]] = []
        self._groups: List[dict] = []
        self._gradients: Dict[str, Gradient] = {}
        self._gradient_builder: Optional[Tuple[str, GradientBuilder]] = None
        self.needs_composition = True
        self.x = 0.0
        self.y = 0.0
        self._parse(path_or_text)
        if scale != 1.0:
            transform = [scale, 0.0, 0.0, 0.0, scale, 0.0, 0.0, 0.0, 1.0]
            self.paths = [
                (p.transform(transform), fr, f, bm) for p, fr, f, bm in self.paths
            ]

    # -- group state ---------------------------------------------------------

    def _group_transform(self) -> Optional[AffineTransform]:
        for group in reversed(self._groups):
            if group.get("transform") is not None:
                return group["transform"]
        return None

    def _group_fill(self):
        for group in reversed(self._groups):
            if group.get("fill") is not None:
                return group["fill"]
        return None

    def _groups_opacity(self) -> float:
        out = 1.0
        for group in self._groups:
            if group.get("opacity") is not None:
                out *= group["opacity"]
        return out

    def _t(self, point: Point) -> Point:
        t = self._group_transform()
        if t is None:
            return point
        return t.transform(point)

    # -- attribute parsing -----------------------------------------------------

    def _parse_fill(self, attrs) -> Fill:
        fill_attr = attrs.get("fill", "")
        m = re.match(r"url\(#(.+)\)", fill_attr or "")
        if m and m.group(1) in self._gradients:
            return Fill.Gradient(self._gradients[m.group(1)])

        rgb = parse_color(fill_attr) if fill_attr else None
        if rgb is None:
            rgb = self._group_fill()
        opacity = attrs.get("opacity") or attrs.get("fill-opacity")
        opacity = float(opacity) if opacity is not None else self._groups_opacity()
        if rgb is None:
            return Fill.Solid(Color(0.0, 0.0, 0.0, 1.0))
        return Fill.Solid(srgb_to_linear_color(rgb, opacity))

    # -- parsing ----------------------------------------------------------------

    def _parse(self, path_or_text):
        if isinstance(path_or_text, str) and path_or_text.lstrip().startswith("<"):
            root_iter = ET.iterparse(
                __import__("io").StringIO(path_or_text), events=("start", "end")
            )
        else:
            root_iter = ET.iterparse(str(path_or_text), events=("start", "end"))

        def local(tag):
            return tag.rsplit("}", 1)[-1]

        for event, el in root_iter:
            tag = local(el.tag)
            if event == "start":
                if tag == "g":
                    self._groups.append(
                        dict(
                            transform=parse_transform(el.get("transform", "")),
                            fill=parse_color(el.get("fill", "")),
                            opacity=float(el.get("opacity"))
                            if el.get("opacity")
                            else None,
                        )
                    )
                elif tag == "linearGradient":
                    if el.get("gradientUnits") != "userSpaceOnUse":
                        continue
                    b = GradientBuilder(
                        Point(float(el.get("x1")), float(el.get("y1"))),
                        Point(float(el.get("x2")), float(el.get("y2"))),
                    )
                    b.type(GradientType.Linear)
                    self._gradient_builder = (el.get("id"), b)
                elif tag == "radialGradient":
                    if el.get("gradientUnits") != "userSpaceOnUse":
                        continue
                    cx = float(el.get("cx"))
                    cy = float(el.get("cy"))
                    r = float(el.get("r"))
                    b = GradientBuilder(Point(cx, cy), Point(cx + r, cy))
                    b.type(GradientType.Radial)
                    self._gradient_builder = (el.get("id"), b)
                elif tag == "stop" and self._gradient_builder is not None:
                    rgb = parse_color(el.get("stop-color", "")) or (0, 0, 0)
                    opacity = float(el.get("stop-opacity", 1.0))
                    offset = el.get("offset", "0%")
                    stop = (
                        float(offset[:-1]) / 100.0
                        if offset.endswith("%")
                        else float(offset)
                    )
                    self._gradient_builder[1].color_with_stop(
                        srgb_to_linear_color(rgb, opacity), stop
                    )
            else:  # end
                if tag == "g":
                    if self._groups:
                        self._groups.pop()
                elif tag in ("linearGradient", "radialGradient"):
                    if self._gradient_builder is not None:
                        gid, b = self._gradient_builder
                        self._gradient_builder = None
                        g = b.build()
                        if g is not None:
                            self._gradients[gid] = g
                elif tag == "path":
                    self._handle_path(el)
                elif tag == "rect":
                    self._handle_rect(el)
                el.clear()

    def _handle_rect(self, el):
        if (el.get("stroke") or "none") != "none":
            return
        x = float(el.get("x", 0.0))
        y = float(el.get("y", 0.0))
        width = float(el.get("width"))
        height = float(el.get("height"))
        b = PathBuilder()
        b.move_to(self._t(Point(x, y)))
        b.line_to(self._t(Point(x, y + height)))
        b.line_to(self._t(Point(x + width, y + height)))
        b.line_to(self._t(Point(x + width, y)))
        b.line_to(self._t(Point(x, y)))
        self.paths.append(
            (
                b.build(),
                self._fill_rule(el),
                self._parse_fill(el.attrib),
                parse_blend_mode(el.get("style", "")),
            )
        )

    @staticmethod
    def _fill_rule(el) -> FillRule:
        return (
            FillRule.EvenOdd if el.get("fill-rule") == "evenodd" else FillRule.NonZero
        )

    def _push_arc(self, builder: PathBuilder, arc: _Arc, end_point: Point) -> Point:
        """Splits a center arc into <=90-degree rational quads (svg.rs:276-335)."""
        angle = arc.angle
        angle_delta = arc.angle_delta
        cos_phi = math.cos(arc.x_axis_rotation)
        sin_phi = math.sin(arc.x_axis_rotation)
        angle_sweep = math.pi / 2.0
        angle_incr = angle_sweep if angle_delta > 0.0 else -angle_sweep

        while angle_delta != 0.0:
            theta = angle
            sweep = angle_delta if abs(angle_delta) <= angle_sweep else angle_incr
            angle += sweep
            angle_delta -= sweep

            half_sweep = sweep * 0.5
            w = math.cos(half_sweep)

            p1x = math.cos(theta + half_sweep) / w * arc.rx
            p1y = math.sin(theta + half_sweep) / w * arc.ry
            p2x = math.cos(theta + sweep) * arc.rx
            p2y = math.sin(theta + sweep) * arc.ry

            p1 = Point(
                arc.cx + p1x * cos_phi - p1y * sin_phi,
                arc.cy + p1x * sin_phi + p1y * cos_phi,
            )
            p2 = Point(
                arc.cx + p2x * cos_phi - p2y * sin_phi,
                arc.cy + p2x * sin_phi + p2y * cos_phi,
            )
            builder.rat_quad_to(self._t(p1), self._t(p2), w)
            end_point = p2
        return end_point

    def _handle_path(self, el):
        if (el.get("stroke") or "none") != "none":
            return
        d = el.get("d")
        if d is None:
            return

        builder = PathBuilder()
        start_point: Optional[Point] = None
        end_point = Point(0.0, 0.0)
        quad_cp: Optional[Point] = None
        cubic_cp: Optional[Point] = None

        for cmd, args in _tokenize_path(d):
            rel = cmd.islower()
            c = cmd.lower()

            def pt(i, j):
                if rel:
                    return Point(end_point.x + args[i], end_point.y + args[j])
                return Point(args[i], args[j])

            if c == "m":
                p = pt(0, 1)
                builder.move_to(self._t(p))
                start_point = None
                end_point = p
                quad_cp = cubic_cp = None
            elif c == "l":
                p = pt(0, 1)
                builder.line_to(self._t(p))
                start_point = start_point or end_point
                end_point = p
                quad_cp = cubic_cp = None
            elif c == "h":
                p = (
                    Point(end_point.x + args[0], end_point.y)
                    if rel
                    else Point(args[0], end_point.y)
                )
                builder.line_to(self._t(p))
                start_point = start_point or end_point
                end_point = p
                quad_cp = cubic_cp = None
            elif c == "v":
                p = (
                    Point(end_point.x, end_point.y + args[0])
                    if rel
                    else Point(end_point.x, args[0])
                )
                builder.line_to(self._t(p))
                start_point = start_point or end_point
                end_point = p
                quad_cp = cubic_cp = None
            elif c == "q":
                p0 = pt(0, 1)
                p1 = pt(2, 3)
                builder.quad_to(self._t(p0), self._t(p1))
                start_point = start_point or end_point
                end_point = p1
                quad_cp = p0
                cubic_cp = None
            elif c == "t":
                p1 = pt(0, 1)
                cp = _reflect(quad_cp or end_point, end_point)
                builder.quad_to(self._t(cp), self._t(p1))
                start_point = start_point or end_point
                end_point = p1
                quad_cp = cp
                cubic_cp = None
            elif c == "c":
                p0 = pt(0, 1)
                p1 = pt(2, 3)
                p2 = pt(4, 5)
                builder.cubic_to(self._t(p0), self._t(p1), self._t(p2))
                start_point = start_point or end_point
                end_point = p2
                quad_cp = None
                cubic_cp = p1
            elif c == "s":
                p1 = pt(0, 1)
                p2 = pt(2, 3)
                cp = _reflect(cubic_cp or end_point, end_point)
                builder.cubic_to(self._t(cp), self._t(p1), self._t(p2))
                start_point = start_point or end_point
                end_point = p2
                quad_cp = None
                cubic_cp = p1
            elif c == "a":
                rx, ry, rot, laf, sf, x, y = args
                p = (
                    Point(end_point.x + x, end_point.y + y)
                    if rel
                    else Point(x, y)
                )
                arc = _convert_to_center(
                    rx, ry, math.radians(rot), bool(laf), bool(sf),
                    end_point.x, end_point.y, p.x, p.y,
                )
                if arc is not None:
                    new_end = self._push_arc(builder, arc, end_point)
                    start_point = start_point or end_point
                    end_point = new_end
                quad_cp = cubic_cp = None
            elif c == "z":
                if start_point is not None:
                    end_point = start_point
                    start_point = None
                    quad_cp = cubic_cp = None

        self.paths.append(
            (
                builder.build(),
                self._fill_rule(el),
                self._parse_fill(el.attrib),
                parse_blend_mode(el.get("style", "")),
            )
        )

    # -- composition -------------------------------------------------------------

    def compose(self, composition: Composition, pan_x: float = None, pan_y: float = None):
        """(Re)builds layers; pans apply as geometry-preserving transforms
        without re-flattening."""
        if pan_x is not None:
            self.x = pan_x
        if pan_y is not None:
            self.y = pan_y
        transform = AffineTransform(tx=-self.x, ty=self.y)
        for order, (path, fill_rule, fill, blend_mode) in enumerate(self.paths):
            layer = composition.get_mut_or_insert_default(Order(order))
            if self.needs_composition:
                layer.insert(path)
                layer.set_props(
                    Props(
                        fill_rule=fill_rule,
                        func=Func.Draw(Style(fill=fill, blend_mode=blend_mode)),
                    )
                )
            layer.set_transform(transform)
        self.needs_composition = False
