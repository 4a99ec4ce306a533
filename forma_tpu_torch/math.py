"""Points and affine / geometry-preserving transforms.

A copy of `forma_tpu/math.py` (the JAX package's host scene model,
plain numpy): the port imports nothing of the JAX package.

Mirrors `forma/src/math/{point.rs,transform.rs}`.  All math is float32 to
match the reference and the TPU's native precision.
"""

from __future__ import annotations

import math as _pymath
from dataclasses import dataclass

import numpy as np

from . import consts

# Flattening must stay within half a sub-pixel (forma/src/path.rs:39-40).
MAX_ERROR = 1.0 / consts.PIXEL_WIDTH

_MAX_SCALING_FACTOR_X = 1.0 + MAX_ERROR / consts.MAX_WIDTH
_MAX_SCALING_FACTOR_Y = 1.0 + MAX_ERROR / consts.MAX_HEIGHT


def _f32(v) -> float:
    return float(np.float32(v))


def canon_f32_bits(v: float) -> int:
    """Canonical f32 bit pattern for hashing/equality — the reference's
    `CanonBits` (forma/src/utils/mod.rs:28-44): every NaN collapses to the
    canonical quiet NaN and -0.0 to +0.0, so NaN-valued props intern equal
    and +-0 hash identically."""
    f = np.float32(v)
    if np.isnan(f):
        return 0x7FC00000
    if f == 0.0:
        return 0
    return int(f.view(np.uint32))


def _canon_eq_hash(cls, fields):
    """Installs CanonBits-based __eq__/__hash__ on a frozen dataclass whose
    float fields should compare by canonical f32 bits."""

    def key(self):
        return tuple(canon_f32_bits(getattr(self, f)) for f in fields)

    def __eq__(self, other):
        if other.__class__ is not cls:
            return NotImplemented
        return key(self) == key(other)

    def __hash__(self):
        return hash(key(self))

    cls.__eq__ = __eq__
    cls.__hash__ = __hash__
    return cls


def approx_atan2(y: float, x: float) -> float:
    """Polynomial atan2 approximation (forma/src/math/point.rs:53-78).

    Used only to decide whether neighbouring primitives are collinear enough
    to merge, so the exact polynomial matters for golden parity.
    """
    x_abs = abs(x)
    y_abs = abs(y)

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


@dataclass(frozen=True)
class Point:
    """A point in 2D space with f32 coordinates."""

    x: float
    y: float

    def __post_init__(self):
        object.__setattr__(self, "x", _f32(self.x))
        object.__setattr__(self, "y", _f32(self.y))

    @staticmethod
    def new(x: float, y: float) -> "Point":
        return Point(x, y)

    def to_array(self):
        return [self.x, self.y]

    def len(self) -> float:
        return _f32(_pymath.sqrt(_f32(self.x * self.x + self.y * self.y)))

    def angle(self):
        """Angle in radians, or None for (near-)zero-length vectors."""
        if self.len() >= np.finfo(np.float32).eps:
            return approx_atan2(self.y, self.x)
        return None

    def __add__(self, other: "Point") -> "Point":
        return Point(self.x + other.x, self.y + other.y)

    def __sub__(self, other: "Point") -> "Point":
        return Point(self.x - other.x, self.y - other.y)

    def __mul__(self, s: float) -> "Point":
        return Point(self.x * s, self.y * s)

    def __truediv__(self, s: float) -> "Point":
        return Point(self.x / s, self.y / s)


_canon_eq_hash(Point, ("x", "y"))


@dataclass(frozen=True)
class AffineTransform:
    """2x3 affine transform; rows are [ux vx tx; uy vy ty]
    (forma/src/math/transform.rs:32-57)."""

    ux: float = 1.0
    uy: float = 0.0
    vx: float = 0.0
    vy: float = 1.0
    tx: float = 0.0
    ty: float = 0.0

    def transform(self, point: Point) -> Point:
        return Point(
            self.ux * point.x + self.vx * point.y + self.tx,
            self.uy * point.x + self.vy * point.y + self.ty,
        )

    def is_identity(self) -> bool:
        return self == AffineTransform()

    def to_array(self):
        return [self.ux, self.uy, self.vx, self.vy, self.tx, self.ty]

    @staticmethod
    def from_array(a) -> "AffineTransform":
        ux, uy, vx, vy, tx, ty = a
        return AffineTransform(ux, uy, vx, vy, tx, ty)


_canon_eq_hash(AffineTransform, ("ux", "uy", "vx", "vy", "tx", "ty"))


class GeomPresTransformError(ValueError):
    """The transform would scale geometry up or is not affine
    (forma/src/math/transform.rs:109-131)."""


@dataclass(frozen=True)
class GeomPresTransform:
    """Geometry-preserving transform: an affine transform whose scaling factor
    is bounded by ~1.0 so cached flattenings stay within tolerance
    (forma/src/math/transform.rs:151-222).
    """

    t: AffineTransform

    @staticmethod
    def try_new(t: AffineTransform):
        """Returns a GeomPresTransform or None if the transform scales up."""
        scales_up = (
            t.ux * t.ux + t.uy * t.uy > _MAX_SCALING_FACTOR_X**2
            or t.vx * t.vx + t.vy * t.vy > _MAX_SCALING_FACTOR_Y**2
        )
        if scales_up:
            return None
        return GeomPresTransform(t)

    @staticmethod
    def from_matrix3(m):
        """Builds from a row-major 3x3 if it has no perspective part and does
        not scale up; returns None otherwise (forma/src/math/transform.rs:151-222)."""
        if m[6] != 0.0 or m[7] != 0.0 or m[8] != 1.0:
            return None
        return GeomPresTransform.try_new(
            AffineTransform(ux=m[0], vx=m[1], tx=m[2], uy=m[3], vy=m[4], ty=m[5])
        )

    def transform(self, point: Point) -> Point:
        return self.t.transform(point)

    def as_slice(self):
        return self.t.to_array()
