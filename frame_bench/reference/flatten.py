"""Path flattening of the plain reference: lines and quadratic curves to
polylines.

A frozen copy of the renderer's flattening (forma's `path.rs`, the line
and quadratic parts): adjacent near-collinear primitives merge into
splines, and quads are flattened with Raph Levien's closed-form
curvature parameterisation, in f32 with `mul_add` emulated through exact
f64 products.  It reads the benchmark's plain path description, never a
path object of the program under test.

A path is `(verbs, points)`: `verbs` a sequence of "M", "L" and "Q",
`points` a flat sequence of floats, two per "M" or "L" and four per "Q"
(the control point, then the end point).  Every contour is closed.
"""

from __future__ import annotations

import math as _pymath
from typing import List, Optional, Tuple

import numpy as np

PIXEL_WIDTH = 16
MAX_ERROR = 1.0 / PIXEL_WIDTH
MAX_ANGLE_ERROR = 0.001

_F32 = np.float32
_PI = _pymath.pi
_FRAC_PI_2 = _pymath.pi / 2
_EPS = float(np.finfo(np.float32).eps)


def _f32(v) -> float:
    return float(np.float32(v))


def _fma(a, b, c):
    return _F32(np.float64(a) * np.float64(b) + np.float64(c))


def _fma_vec(a, b, c):
    return np.asarray(
        np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64),
        dtype=np.float32,
    )


def _lerp_vec(t, a, b):
    return _fma_vec(t, b, _fma_vec(-t, a, a))


def _bits(v: float) -> int:
    """Canonical f32 bits: every NaN one value, -0 as +0."""
    f = np.float32(v)
    if np.isnan(f):
        return 0x7FC00000
    if f == 0.0:
        return 0
    return int(f.view(np.uint32))


class _P:
    """A point with f32 coordinates."""

    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x = _f32(x)
        self.y = _f32(y)

    def __sub__(self, o):
        return _P(self.x - o.x, self.y - o.y)

    def same(self, o) -> bool:
        return _bits(self.x) == _bits(o.x) and _bits(self.y) == _bits(o.y)

    def len(self) -> float:
        return _f32(_pymath.sqrt(_f32(self.x * self.x + self.y * self.y)))

    def angle(self):
        if self.len() >= _EPS:
            return _atan2(self.y, self.x)
        return None


def _atan2(y: float, x: float) -> float:
    """forma's polynomial atan2 (`point.rs:53-78`)."""
    x_abs, y_abs = abs(x), abs(y)
    big = max(x_abs, y_abs)
    a = _f32(min(x_abs, y_abs) / big) if big != 0.0 else _pymath.nan
    s = _f32(a * a)
    r = _f32(s * -0.046_496_473 + 0.159_314_22)
    r = _f32(r * s + -0.327_622_77)
    r = _f32(r * (s * a) + a)
    if y_abs > x_abs:
        r = _f32(_pymath.pi / 2 - r)
    if x < 0.0:
        r = _f32(_pymath.pi - r)
    if y < 0.0:
        r = -r
    return r


def _curvature(x):
    c = _F32(0.67)
    inner = _fma(_F32(x) * _F32(x), _F32(0.25), c * c * c * c)
    return _F32(x) / _F32(_F32(1.0) - c + _F32(np.sqrt(_F32(np.sqrt(inner)))))


def _inv_curvature_vec(k):
    c = np.float32(0.39)
    inner = np.asarray(np.asarray(k, np.float64) ** 2 * 0.25 + np.float64(c * c),
                       dtype=np.float32)
    return (k * (np.float32(1.0) - c + np.sqrt(inner).astype(np.float32))).astype(np.float32)


def _angle_diff(a0: float, a1: float) -> float:
    diff = abs(a1 - a0)
    if diff > _PI:
        diff -= _PI
    if diff > _FRAC_PI_2:
        diff = _PI - diff
    return diff


class _Spline:
    __slots__ = ("curvature", "p0", "p2", "contour")

    def __init__(self, curvature, p0, p2):
        self.curvature = curvature
        self.p0 = p0
        self.p2 = p2
        self.contour = True

    def new_spline_needed(self, angle_changed: bool, point) -> bool:
        needed = angle_changed or (point - self.p2).len() >= MAX_ERROR
        if needed and self.contour:
            self.contour = False
            return True
        return False


class _Primitives:
    def __init__(self):
        self.last_angle: Optional[float] = None
        self.contour = True
        self.splines: List[_Spline] = []
        self.qx: List[float] = []
        self.qy: List[float] = []
        self.x0: List[float] = []
        self.dx_recip: List[float] = []
        self.k0: List[float] = []
        self.dk: List[float] = []
        self.curvatures_recip: List[float] = []
        self.partial: List[Tuple[int, float]] = []

    def _spline(self, angle, point, make) -> _Spline:
        take = False
        if self.contour:
            self.contour = False
            take = True
        else:
            changed = False
            if self.last_angle is not None and angle is not None:
                changed = _angle_diff(self.last_angle, angle) > MAX_ANGLE_ERROR
            if self.splines and self.splines[-1].new_spline_needed(changed, point):
                take = True
        if take:
            self.splines.append(make())
        return self.splines[-1]

    def line(self, p0, p1):
        angle = (p1 - p0).angle()
        spline = self._spline(angle, p0, lambda: _Spline(0.0, p0, p1))
        spline.p2 = p1
        self.last_angle = angle

    def quad(self, p0, p1, p2):
        a = p1 - p0
        b = p2 - p1
        in_angle, out_angle = a.angle(), b.angle()
        if in_angle is None and out_angle is None:
            return
        if in_angle is None or out_angle is None:
            self.line(p0, p2)
            return
        for p in (p0, p1, p2):
            self.qx.append(_F32(p.x))
            self.qy.append(_F32(p.y))
        spline = self._spline(in_angle, p0, lambda: _Spline(0.0, p0, p2))
        spline.p2 = p2
        h = a - b
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            cross = _fma(_F32(p2.x) - _F32(p0.x), h.y, -(_F32(p2.y) - _F32(p0.y)) * h.x)
            cross_recip = _F32(1.0) / cross
            x0 = _fma(a.x, h.x, a.y * h.y) * cross_recip
            x2 = _fma(b.x, h.x, b.y * h.y) * cross_recip
            dx_recip = _F32(1.0) / (x2 - x0)
            scale = abs(cross / (h.len() * (x2 - x0)))
            k0 = _curvature(x0)
            dk = _curvature(x2) - k0
            cur = _F32(_F32(0.5) * abs(dk)
                       * _F32(np.sqrt(_F32(scale * _F32(1.0 / MAX_ERROR)))))
        if not np.isfinite(cur) or cur <= 1.0:
            # Collinear control points: the points land at t = 0.5 and 1.
            x0, dx_recip, k0, dk, cur = (_F32(0.036_624_67), _F32(1.0), _F32(0.0),
                                         _F32(1.0), _F32(2.0))
        total = _F32(_F32(spline.curvature) + cur)
        spline.curvature = total
        self.last_angle = out_angle
        self.x0.append(_F32(x0))
        self.dx_recip.append(_F32(dx_recip))
        self.k0.append(_F32(k0))
        self.dk.append(_F32(dk))
        self.curvatures_recip.append(_F32(1.0) / cur)
        self.partial.append((len(self.splines) - 1, total))

    def points(self):
        """(x, y, contour_end) f32, f32, bool: the polyline's points."""
        kinds, idxs = [], []
        sx, sy = [], []
        pis, qis, incrs = [], [], []
        ends = []
        i = 0
        last = None
        for spline in self.splines:
            subdivisions = int(_pymath.ceil(spline.curvature))
            step = (_F32(_F32(spline.curvature) / _F32(subdivisions)) if subdivisions
                    else _F32(0.0))
            if last is None or last.contour or (last.p2 - spline.p0).len() > MAX_ERROR:
                kinds.append(0)
                idxs.append(len(sx))
                sx.append(spline.p0.x)
                sy.append(spline.p0.y)
            for pi in range(1, subdivisions):
                if _F32(pi) > self.partial[i][1]:
                    i += 1
                kinds.append(1)
                idxs.append(len(pis))
                pis.append(pi)
                qis.append(i)
                incrs.append(step)
            kinds.append(2)
            idxs.append(len(ends))
            ends.append((spline.p2.x, spline.p2.y, spline.contour))
            last = spline
            if subdivisions > 0:
                i += 1

        if pis:
            pi_a = np.asarray(pis, np.float32)
            qi_a = np.asarray(qis, np.int64)
            spline_of_q = np.asarray([p[0] for p in self.partial], np.int64)
            partial = np.asarray([p[1] for p in self.partial], np.float32)
            prev_partial = np.zeros(len(partial), np.float32)
            if len(partial) > 1:
                same = spline_of_q[1:] == spline_of_q[:-1]
                prev_partial[1:] = np.where(same, partial[:-1], 0.0)
            ratio = _fma_vec(np.asarray(incrs, np.float32), pi_a, -prev_partial[qi_a]) \
                * np.asarray(self.curvatures_recip, np.float32)[qi_a]
            x = _inv_curvature_vec(_fma_vec(ratio, np.asarray(self.dk, np.float32)[qi_a],
                                            np.asarray(self.k0, np.float32)[qi_a]))
            t = np.clip((x - np.asarray(self.x0, np.float32)[qi_a])
                        * np.asarray(self.dx_recip, np.float32)[qi_a], 0.0, 1.0
                        ).astype(np.float32)
            qx = np.asarray(self.qx, np.float32)
            qy = np.asarray(self.qy, np.float32)
            i0 = 3 * qi_a
            # Unweighted quads: the weight interpolates to exactly 1.
            px = _lerp_vec(t, _lerp_vec(t, qx[i0], qx[i0 + 1]), _lerp_vec(t, qx[i0 + 1], qx[i0 + 2]))
            py = _lerp_vec(t, _lerp_vec(t, qy[i0], qy[i0 + 1]), _lerp_vec(t, qy[i0 + 1], qy[i0 + 2]))
        else:
            px = py = np.zeros(0, np.float32)

        kinds = np.asarray(kinds, np.int8)
        idxs = np.asarray(idxs, np.int64)
        n = len(kinds)
        out_x = np.empty(n, np.float32)
        out_y = np.empty(n, np.float32)
        out_end = np.zeros(n, bool)
        m = kinds == 0
        if sx:
            out_x[m] = np.asarray(sx, np.float32)[idxs[m]]
            out_y[m] = np.asarray(sy, np.float32)[idxs[m]]
        m = kinds == 1
        out_x[m] = px[idxs[m]]
        out_y[m] = py[idxs[m]]
        m = kinds == 2
        if ends:
            out_x[m] = np.asarray([e[0] for e in ends], np.float32)[idxs[m]]
            out_y[m] = np.asarray([e[1] for e in ends], np.float32)[idxs[m]]
            out_end[m] = np.asarray([e[2] for e in ends], bool)[idxs[m]]
        return out_x, out_y, out_end


def flatten(verbs, points):
    """(x, y, contour_end) of one path: its polyline's points, f32, and a
    flag on each point that ends a contour (no line leaves it)."""
    prim = _Primitives()
    pts = [_f32(v) for v in points]
    k = 0
    start = last = None
    for verb in verbs:
        if verb == "M":
            if last is not None and not last.same(start):
                prim.line(last, start)
            start = last = _P(pts[k], pts[k + 1])
            k += 2
            prim.contour = True
        elif verb == "L":
            p = _P(pts[k], pts[k + 1])
            k += 2
            prim.line(last, p)
            last = p
        elif verb == "Q":
            p1, p2 = _P(pts[k], pts[k + 1]), _P(pts[k + 2], pts[k + 3])
            k += 4
            prim.quad(last, p1, p2)
            last = p2
        else:
            raise ValueError(f"unknown verb {verb!r}")
    if last is not None and not last.same(start):
        prim.line(last, start)
    return prim.points()
