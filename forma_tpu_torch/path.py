"""Paths and curve flattening.

A copy of `forma_tpu/path.py` (the JAX package's host scene model,
plain numpy): the port imports nothing of the JAX package.

Mirrors `forma/src/path.rs`: curves are converted to primitives (lines and
quadratic Beziers) as they are pushed onto the `PathBuilder`; cubics are split
into quads with Colomitchi's midpoint method, and quads are flattened to line
segments with Raph Levien's closed-form curvature parameterisation.  Adjacent
near-collinear primitives merge into "splines" so flat geometry emits few
points.

The split of work matches the reference: the sequential per-command pass
(cheap decisions) runs on the host, while the per-point evaluation — the bulk
of the work (`path.rs:473-538` runs it on a thread pool) — is vectorised
numpy here and can be handed to the device wholesale.  Flattening results are
cached per path, so none of this is per-frame work.

All arithmetic is f32, with the reference's `mul_add` fused ops emulated via
f64 intermediates (exact for f32 products, single-rounding in practice).
"""

from __future__ import annotations

import math as _pymath
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .math import MAX_ERROR, GeomPresTransform, Point

MAX_ANGLE_ERROR = 0.001

_F32 = np.float32
_PI = _pymath.pi
_FRAC_PI_2 = _pymath.pi / 2


def _fma(a, b, c):
    """f32 fused multiply-add emulated with an exact f64 product."""
    return _F32(np.float64(a) * np.float64(b) + np.float64(c))


def _lerp(t, a, b):
    # t.mul_add(b, (-t).mul_add(a, a))   (path.rs:44-46)
    return _fma(t, b, _fma(-t, a, a))


def curvature(x):
    """Levien's approximate integral of sqrt(1 + t^2)^-? for quad flattening
    (path.rs:48-51)."""
    c = _F32(0.67)
    inner = _fma(_F32(x) * _F32(x), _F32(0.25), c * c * c * c)
    return _F32(x) / _F32(
        _F32(1.0) - c + _F32(np.sqrt(_F32(np.sqrt(inner))))
    )


def inv_curvature(k):
    """Approximate inverse of ``curvature`` (path.rs:53-56)."""
    c = _F32(0.39)
    inner = _fma(_F32(k) * _F32(k), _F32(0.25), c * c)
    return _F32(k) * _F32(_F32(1.0) - c + _F32(np.sqrt(inner)))


def _inv_curvature_vec(k: np.ndarray) -> np.ndarray:
    c = np.float32(0.39)
    inner = np.asarray(
        np.asarray(k, np.float64) ** 2 * 0.25 + np.float64(c * c), dtype=np.float32
    )
    return (k * (np.float32(1.0) - c + np.sqrt(inner).astype(np.float32))).astype(
        np.float32
    )


@dataclass(frozen=True)
class WeightedPoint:
    point: Point
    weight: float

    def applied(self) -> Point:
        w_recip = _F32(1.0) / _F32(self.weight)
        return Point(_F32(self.point.x) * w_recip, _F32(self.point.y) * w_recip)


def _eval_cubic(t, points) -> WeightedPoint:
    """De Casteljau on weighted points (path.rs:75-120)."""

    def ev(vals):
        ab = _lerp(t, vals[0], vals[1])
        bc = _lerp(t, vals[1], vals[2])
        cd = _lerp(t, vals[2], vals[3])
        return _lerp(t, _lerp(t, ab, bc), _lerp(t, bc, cd))

    x = ev([p.point.x for p in points])
    y = ev([p.point.y for p in points])
    w = ev([p.weight for p in points])
    return WeightedPoint(Point(x, y), w)


class _Spline:
    __slots__ = ("curvature", "p0", "p2", "contour")

    def __init__(self, curvature_: float, p0: Point, p2: Point, contour: bool):
        self.curvature = curvature_
        self.p0 = p0
        self.p2 = p2
        self.contour = contour

    def new_spline_needed(self, angle_changed: bool, point: Point) -> bool:
        """Takes the contour token if a new spline is needed (path.rs:181-188)."""
        needed = angle_changed or (point - self.p2).len() >= MAX_ERROR
        if needed and self.contour:
            self.contour = False
            return True
        return False


@dataclass
class Segments:
    """Flattened polyline SoA: consecutive points form line segments;
    start_new_contour[i] marks that point i begins a new polygonal chain."""

    x: np.ndarray
    y: np.ndarray
    start_new_contour: np.ndarray


def _angle_diff(a0: float, a1: float) -> float:
    diff = abs(a1 - a0)
    if diff > _PI:
        diff -= _PI
    if diff > _FRAC_PI_2:
        diff = _PI - diff
    return diff


class _Primitives:
    """Sequentially accumulates lines/quads into splines (path.rs:190-558)."""

    def __init__(self):
        self.last_angle: Optional[float] = None
        self.contour: bool = True
        self.splines: List[_Spline] = []
        # Per-quad data (3 control points each).
        self.qx: List[float] = []
        self.qy: List[float] = []
        self.qweight: List[float] = []
        self.x0: List[float] = []
        self.dx_recip: List[float] = []
        self.k0: List[float] = []
        self.dk: List[float] = []
        self.curvatures_recip: List[float] = []
        self.partial_curvatures: List[Tuple[int, float]] = []

    def _last_spline_or_insert(self, angle, point: Point, make) -> _Spline:
        take = False
        if self.contour:
            self.contour = False
            take = True
        else:
            angle_changed = False
            if self.last_angle is not None and angle is not None:
                angle_changed = _angle_diff(self.last_angle, angle) > MAX_ANGLE_ERROR
            if self.splines and self.splines[-1].new_spline_needed(
                angle_changed, point
            ):
                take = True
        if take:
            self.splines.append(make())
        return self.splines[-1]

    def push_contour(self):
        self.contour = True

    def push_line(self, points):
        p0 = points[0].applied()
        p1 = points[1].applied()
        d = p1 - p0
        angle = d.angle()

        spline = self._last_spline_or_insert(
            angle, p0, lambda: _Spline(0.0, p0, p1, True)
        )
        spline.p2 = p1
        self.last_angle = angle

    def push_quad(self, points):
        pixel_accuracy_recip = _F32(1.0 / MAX_ERROR)

        p0 = points[0].applied()
        p1 = points[1].applied()
        p2 = points[2].applied()

        a = p1 - p0
        b = p2 - p1

        in_angle = a.angle()
        out_angle = b.angle()

        if in_angle is None and out_angle is None:
            return
        if in_angle is None or out_angle is None:
            self.push_line([points[0], points[2]])
            return

        for p in points:
            self.qx.append(_F32(p.point.x))
            self.qy.append(_F32(p.point.y))
            self.qweight.append(_F32(p.weight))

        spline = self._last_spline_or_insert(
            in_angle, p0, lambda: _Spline(0.0, p0, p2, True)
        )
        spline.p2 = p2

        h = a - b

        # Degenerate quads (collinear / coincident control points) produce
        # inf/NaN through this block BY DESIGN — the `isfinite` guard below
        # substitutes the collinear parameterization exactly like
        # `path.rs:322-332`.  errstate keeps the intended NaN flow from
        # emitting RuntimeWarnings in the library's hot path.
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            cross = _fma(
                _F32(p2.x) - _F32(p0.x), h.y, -(_F32(p2.y) - _F32(p0.y)) * h.x
            )
            cross_recip = _F32(1.0) / cross

            x0 = _fma(a.x, h.x, a.y * h.y) * cross_recip
            x2 = _fma(b.x, h.x, b.y * h.y) * cross_recip
            dx_recip = _F32(1.0) / (x2 - x0)

            scale = abs(cross / (h.len() * (x2 - x0)))

            k0 = curvature(x0)
            k2 = curvature(x2)

            dk = k2 - k0
            current_curvature = _F32(
                _F32(0.5)
                * abs(dk)
                * _F32(np.sqrt(_F32(scale * pixel_accuracy_recip)))
            )

        # Points are collinear (path.rs:322-332): values chosen so the
        # resulting points land at t = 0.5 and t = 1.0.
        if not np.isfinite(current_curvature) or current_curvature <= 1.0:
            x0 = _F32(0.036_624_67)
            dx_recip = _F32(1.0)
            k0 = _F32(0.0)
            dk = _F32(1.0)
            current_curvature = _F32(2.0)

        total_curvature = _F32(_F32(spline.curvature) + current_curvature)
        spline.curvature = total_curvature
        self.last_angle = out_angle

        self.x0.append(_F32(x0))
        self.dx_recip.append(_F32(dx_recip))
        self.k0.append(_F32(k0))
        self.dk.append(_F32(dk))
        self.curvatures_recip.append(_F32(1.0) / current_curvature)
        self.partial_curvatures.append((len(self.splines) - 1, total_curvature))

    def push_cubic(self, points):
        max_cubic_error_squared = _F32((36.0 * 36.0 / 3.0) * MAX_ERROR * MAX_ERROR)

        p0 = points[0].applied()
        p1 = points[1].applied()
        p2 = points[2].applied()

        dx = _fma(_F32(p2.x), _F32(3.0), -_F32(p0.x)) - _fma(
            _F32(p1.x), _F32(3.0), -_F32(p1.x)
        )
        dy = _fma(_F32(p2.y), _F32(3.0), -_F32(p0.y)) - _fma(
            _F32(p1.y), _F32(3.0), -_F32(p1.y)
        )

        err = _fma(dx, dx, dy * dy)

        mult = max(points[1].weight, points[2].weight, 1.0)

        subdivisions = max(
            int(
                _pymath.ceil(
                    _F32(
                        _F32(err * (_F32(1.0) / max_cubic_error_squared))
                        ** _F32(1.0 / 6.0)
                    )
                    * _F32(mult)
                )
            ),
            1,
        )
        incr = _F32(1.0) / _F32(subdivisions)

        quad_p0 = p0
        for i in range(1, subdivisions + 1):
            t = _F32(_F32(i) * incr)
            quad_p2 = _eval_cubic(t, points).applied()
            mid_point = _eval_cubic(_F32(t - _F32(0.5) * incr), points).applied()
            quad_p1 = Point(
                _fma(mid_point.x, _F32(2.0), -_F32(0.5) * (quad_p0.x + quad_p2.x)),
                _fma(mid_point.y, _F32(2.0), -_F32(0.5) * (quad_p0.y + quad_p2.y)),
            )
            self.push_quad(
                [
                    WeightedPoint(quad_p0, 1.0),
                    WeightedPoint(quad_p1, 1.0),
                    WeightedPoint(quad_p2, 1.0),
                ]
            )
            quad_p0 = quad_p2

    # -- point emission ----------------------------------------------------

    def into_segments(self) -> Segments:
        """Evaluates every output point, vectorised (path.rs:400-538).

        Builds the same flat command buffer as `populate_buffers` — one entry
        per output point: spline starts, curvature-equidistant interior
        points, spline ends — then evaluates all interior points in one
        vectorised numpy pass.
        """
        start_xs: List[float] = []
        start_ys: List[float] = []
        start_contour: List[bool] = []
        # Interior points: (point_index, quad_index, incr) triples.
        pis: List[int] = []
        qis: List[int] = []
        incrs: List[float] = []
        # Interleave order: list of ('s'|'i'|'e', index into above arrays).
        order: List[Tuple[int, int]] = []

        KIND_START, KIND_INCR, KIND_END = 0, 1, 2

        i = 0
        last_spline: Optional[_Spline] = None
        ends: List[Tuple[float, float, bool]] = []
        for spline_i, spline in enumerate(self.splines):
            subdivisions = int(_pymath.ceil(spline.curvature))
            point_command = (
                _F32(_F32(spline.curvature) / _F32(subdivisions))
                if subdivisions
                else _F32(0.0)
            )

            needs_start_point = last_spline is None or (
                last_spline.contour
                or (last_spline.p2 - spline.p0).len() > MAX_ERROR
            )
            if needs_start_point:
                order.append((KIND_START, len(start_xs)))
                start_xs.append(spline.p0.x)
                start_ys.append(spline.p0.y)
                start_contour.append(False)

            for pi in range(1, subdivisions):
                if _F32(pi) > self.partial_curvatures[i][1]:
                    i += 1
                order.append((KIND_INCR, len(pis)))
                pis.append(pi)
                qis.append(i)
                incrs.append(point_command)

            order.append((KIND_END, len(ends)))
            ends.append((spline.p2.x, spline.p2.y, spline.contour))

            last_spline = spline
            if subdivisions > 0:
                i += 1

        # Vectorised interior-point evaluation (path.rs:493-525).
        if pis:
            pi_a = np.asarray(pis, dtype=np.float32)
            qi_a = np.asarray(qis, dtype=np.int64)
            incr_a = np.asarray(incrs, dtype=np.float32)

            pc = self.partial_curvatures
            spline_of_q = np.asarray([p[0] for p in pc], dtype=np.int64)
            partial = np.asarray([p[1] for p in pc], dtype=np.float32)

            prev_partial = np.zeros(len(pc), dtype=np.float32)
            if len(pc) > 1:
                same_spline = spline_of_q[1:] == spline_of_q[:-1]
                prev_partial[1:] = np.where(same_spline, partial[:-1], 0.0)

            prev = prev_partial[qi_a]
            ratio = _fma_vec(incr_a, pi_a, -prev) * np.asarray(
                self.curvatures_recip, dtype=np.float32
            )[qi_a]
            k0_a = np.asarray(self.k0, dtype=np.float32)[qi_a]
            dk_a = np.asarray(self.dk, dtype=np.float32)[qi_a]
            x = _inv_curvature_vec(_fma_vec(ratio, dk_a, k0_a))

            x0_a = np.asarray(self.x0, dtype=np.float32)[qi_a]
            dxr_a = np.asarray(self.dx_recip, dtype=np.float32)[qi_a]
            t = np.clip((x - x0_a) * dxr_a, 0.0, 1.0).astype(np.float32)

            qx = np.asarray(self.qx, dtype=np.float32)
            qy = np.asarray(self.qy, dtype=np.float32)
            qw = np.asarray(self.qweight, dtype=np.float32)
            i0 = 3 * qi_a
            w = _lerp_vec(
                t,
                _lerp_vec(t, qw[i0], qw[i0 + 1]),
                _lerp_vec(t, qw[i0 + 1], qw[i0 + 2]),
            )
            w_recip = (np.float32(1.0) / w).astype(np.float32)
            px = (
                _lerp_vec(
                    t,
                    _lerp_vec(t, qx[i0], qx[i0 + 1]),
                    _lerp_vec(t, qx[i0 + 1], qx[i0 + 2]),
                )
                * w_recip
            ).astype(np.float32)
            py = (
                _lerp_vec(
                    t,
                    _lerp_vec(t, qy[i0], qy[i0 + 1]),
                    _lerp_vec(t, qy[i0 + 1], qy[i0 + 2]),
                )
                * w_recip
            ).astype(np.float32)
        else:
            px = py = np.zeros(0, dtype=np.float32)

        n = len(order)
        out_x = np.empty(n, dtype=np.float32)
        out_y = np.empty(n, dtype=np.float32)
        out_contour = np.zeros(n, dtype=bool)

        kinds = np.asarray([k for k, _ in order], dtype=np.int8)
        idxs = np.asarray([j for _, j in order], dtype=np.int64)

        smask = kinds == KIND_START
        imask = kinds == KIND_INCR
        emask = kinds == KIND_END
        if start_xs:
            out_x[smask] = np.asarray(start_xs, dtype=np.float32)[idxs[smask]]
            out_y[smask] = np.asarray(start_ys, dtype=np.float32)[idxs[smask]]
        out_x[imask] = px[idxs[imask]]
        out_y[imask] = py[idxs[imask]]
        if ends:
            ex = np.asarray([e[0] for e in ends], dtype=np.float32)
            ey = np.asarray([e[1] for e in ends], dtype=np.float32)
            ec = np.asarray([e[2] for e in ends], dtype=bool)
            out_x[emask] = ex[idxs[emask]]
            out_y[emask] = ey[idxs[emask]]
            out_contour[emask] = ec[idxs[emask]]

        return Segments(out_x, out_y, out_contour)


def _fma_vec(a, b, c):
    return np.asarray(
        np.asarray(a, np.float64) * np.asarray(b, np.float64)
        + np.asarray(c, np.float64),
        dtype=np.float32,
    )


def _lerp_vec(t, a, b):
    return _fma_vec(t, b, _fma_vec(-t, a, a))


_MOVE, _LINE, _QUAD, _CUBIC = 0, 1, 2, 3


class _PathData:
    def __init__(self):
        self.x: List[float] = [0.0]
        self.y: List[float] = [0.0]
        self.weight: List[float] = [1.0]
        self.commands: List[int] = [_MOVE]
        self.open_point_index = 0
        self.segments_cache: Optional[Segments] = None

    def close(self):
        last = WeightedPoint(Point(self.x[-1], self.y[-1]), self.weight[-1])
        open_ = WeightedPoint(
            Point(self.x[self.open_point_index], self.y[self.open_point_index]),
            self.weight[self.open_point_index],
        )
        if last.applied() != open_.applied():
            self.x.append(open_.point.x)
            self.y.append(open_.point.y)
            self.weight.append(open_.weight)
            self.commands.append(_LINE)

    def _wp(self, i: int) -> WeightedPoint:
        return WeightedPoint(Point(self.x[i], self.y[i]), self.weight[i])

    def segments(self) -> Segments:
        if self.segments_cache is None:
            prim = _Primitives()
            i = 0
            for command in self.commands:
                if command == _MOVE:
                    i += 1
                    prim.push_contour()
                elif command == _LINE:
                    i += 1
                    prim.push_line([self._wp(i - 2), self._wp(i - 1)])
                elif command == _QUAD:
                    i += 2
                    prim.push_quad([self._wp(i - 3), self._wp(i - 2), self._wp(i - 1)])
                else:
                    i += 3
                    prim.push_cubic(
                        [
                            self._wp(i - 4),
                            self._wp(i - 3),
                            self._wp(i - 2),
                            self._wp(i - 1),
                        ]
                    )
            self.segments_cache = prim.into_segments()
        return self.segments_cache


class Path:
    """An immutable flattenable path; flattening is lazy and cached.

    Affine non-scaling-up transforms share geometry (cheap pans/rotations,
    `path.rs:726-765`); anything else clones control points and re-flattens.
    """

    def __init__(self, inner: _PathData, transform: Optional[GeomPresTransform] = None):
        self._inner = inner
        self._transform = transform

    def transform(self, matrix9) -> "Path":
        gp = GeomPresTransform.from_matrix3(list(map(_F32, matrix9)))
        if gp is not None:
            return Path(self._inner, gp)

        m = list(map(_F32, matrix9))
        data = _PathData()
        x = np.asarray(self._inner.x, dtype=np.float32)
        y = np.asarray(self._inner.y, dtype=np.float32)
        w = np.asarray(self._inner.weight, dtype=np.float32)
        nx = _fma_vec(m[0], x, _fma_vec(m[1], y, m[2] * w))
        ny = _fma_vec(m[3], x, _fma_vec(m[4], y, m[5] * w))
        nw = _fma_vec(m[6], x, _fma_vec(m[7], y, m[8] * w))
        data.x = [float(v) for v in nx]
        data.y = [float(v) for v in ny]
        data.weight = [float(v) for v in nw]
        data.commands = list(self._inner.commands)
        data.open_point_index = self._inner.open_point_index
        return Path(data)

    def push_segments_to(self):
        """Returns (x, y, start_new_contour) with the path transform applied
        (path.rs:677-723)."""
        segments = self._inner.segments()
        if self._transform is None:
            return segments.x, segments.y, segments.start_new_contour
        t = self._transform.t
        x = _fma_vec(t.ux, segments.x, _fma_vec(t.vx, segments.y, t.tx))
        y = _fma_vec(t.uy, segments.x, _fma_vec(t.vy, segments.y, t.ty))
        return x, y, segments.start_new_contour


class PathBuilder:
    """Builds paths from move/line/quad/cubic commands, with rational
    (weighted) variants for conics (path.rs:776-925)."""

    def __init__(self):
        self._inner = _PathData()

    def move_to(self, p: Point) -> "PathBuilder":
        inner = self._inner
        if inner.commands[-1] == _MOVE:
            inner.x[-1] = _F32(p.x)
            inner.y[-1] = _F32(p.y)
            inner.weight[-1] = 1.0
        else:
            inner.close()
            inner.open_point_index = len(inner.x)
            inner.x.append(_F32(p.x))
            inner.y.append(_F32(p.y))
            inner.weight.append(1.0)
            inner.commands.append(_MOVE)
        return self

    def line_to(self, p: Point) -> "PathBuilder":
        inner = self._inner
        inner.x.append(_F32(p.x))
        inner.y.append(_F32(p.y))
        inner.weight.append(1.0)
        inner.commands.append(_LINE)
        return self

    def quad_to(self, p1: Point, p2: Point) -> "PathBuilder":
        inner = self._inner
        for p in (p1, p2):
            inner.x.append(_F32(p.x))
            inner.y.append(_F32(p.y))
            inner.weight.append(1.0)
        inner.commands.append(_QUAD)
        return self

    def cubic_to(self, p1: Point, p2: Point, p3: Point) -> "PathBuilder":
        inner = self._inner
        for p in (p1, p2, p3):
            inner.x.append(_F32(p.x))
            inner.y.append(_F32(p.y))
            inner.weight.append(1.0)
        inner.commands.append(_CUBIC)
        return self

    def rat_quad_to(self, p1: Point, p2: Point, weight: float) -> "PathBuilder":
        inner = self._inner
        inner.x.append(_F32(_F32(p1.x) * _F32(weight)))
        inner.y.append(_F32(_F32(p1.y) * _F32(weight)))
        inner.weight.append(_F32(weight))
        inner.x.append(_F32(p2.x))
        inner.y.append(_F32(p2.y))
        inner.weight.append(1.0)
        inner.commands.append(_QUAD)
        return self

    def rat_cubic_to(
        self, p1: Point, p2: Point, p3: Point, w1: float, w2: float
    ) -> "PathBuilder":
        inner = self._inner
        inner.x.append(_F32(_F32(p1.x) * _F32(w1)))
        inner.y.append(_F32(_F32(p1.y) * _F32(w1)))
        inner.weight.append(_F32(w1))
        inner.x.append(_F32(_F32(p2.x) * _F32(w2)))
        inner.y.append(_F32(_F32(p2.y) * _F32(w2)))
        inner.weight.append(_F32(w2))
        inner.x.append(_F32(p3.x))
        inner.y.append(_F32(p3.y))
        inner.weight.append(1.0)
        inner.commands.append(_CUBIC)
        return self

    def build(self) -> Path:
        self._inner.close()
        return Path(self._inner)
