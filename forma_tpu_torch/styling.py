"""Styling model: colors, fills, gradients, textures, blend modes and props.

A copy of `forma_tpu/styling.py` (the JAX package's host scene model,
plain numpy): the port imports nothing of the JAX package.

Mirrors `forma/src/styling.rs`.  Pixel math lives in the backends; this module
is the user-facing scene description plus the exact data conversions
(sRGB -> linear import, the reference's custom f16 texel quantisation) that
must match for golden parity.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

from .math import AffineTransform, Point, _canon_eq_hash


@dataclass(frozen=True)
class Color:
    """Linear-space RGBA color with f32 components.

    Equality and hashing go through canonical f32 bits (`CanonBits`,
    forma/src/utils/mod.rs:28-44): NaN-valued colors intern equal and
    +-0.0 hash identically, matching the reference's props interner."""

    r: float = 0.0
    g: float = 0.0
    b: float = 0.0
    a: float = 1.0

    def to_array(self) -> Tuple[float, float, float, float]:
        return (self.r, self.g, self.b, self.a)


_canon_eq_hash(Color, ("r", "g", "b", "a"))


class FillRule(enum.Enum):
    NonZero = 0
    EvenOdd = 1


class GradientType(enum.Enum):
    Linear = 0
    Radial = 1


_NO_STOP = -1.0


class GradientBuilder:
    """Builds gradients; stops without explicit positions are auto-spaced
    (forma/src/styling.rs:84-139)."""

    def __init__(self, start: Point, end: Point):
        self._type = GradientType.Linear
        self._start = start
        self._end = end
        self._stops: list[tuple[Color, float]] = []

    def type(self, t: GradientType) -> "GradientBuilder":
        self._type = t
        return self

    def color(self, color: Color) -> "GradientBuilder":
        self._stops.append((color, _NO_STOP))
        return self

    def color_with_stop(self, color: Color, stop: float) -> "GradientBuilder":
        if not 0.0 <= stop <= 1.0:
            raise ValueError("gradient stops must be between 0.0 and 1.0")
        self._stops.append((color, stop))
        return self

    def build(self) -> Optional["Gradient"]:
        if len(self._stops) < 2:
            return None
        incr = np.float32(1.0) / np.float32(len(self._stops) - 1)
        stops = tuple(
            (c, float(np.float32(i) * incr) if s == _NO_STOP else s)
            for i, (c, s) in enumerate(self._stops)
        )
        return Gradient(self._type, self._start, self._end, stops)


@dataclass(frozen=True)
class Gradient:
    type: GradientType
    start: Point
    end: Point
    stops: Tuple[Tuple[Color, float], ...]

    def colors_with_stops(self):
        return self.stops


class ImageError(ValueError):
    pass


def _srgb_to_linear(l: np.ndarray) -> np.ndarray:
    """Exact per-channel sRGB -> linear transform (forma/src/styling.rs:252-259)."""
    l = l.astype(np.float32) * np.float32(1.0 / 255.0)
    lo = l * np.float32(1.0 / 12.92)
    hi = ((l + np.float32(0.055)) * np.float32(1.0 / 1.055)) ** np.float32(2.4)
    return np.where(l <= 0.04045, lo, hi).astype(np.float32)


def _f16_roundtrip(v: np.ndarray) -> np.ndarray:
    """Quantise through the reference's custom 16-bit float
    (forma/src/styling.rs:224-249): bits = (f32_bits - 0x3800_0000) >> 13,
    back = 0x3800_0000 + (bits << 13); zero maps to zero.

    Texture fills sample texels that went through this quantisation, so we
    reproduce it exactly on import.
    """
    v = np.ascontiguousarray(v, dtype=np.float32)
    bits = v.view(np.uint32)
    f16 = ((bits - np.uint32(0x3800_0000)) >> np.uint32(13)).astype(np.uint16)
    back = (np.uint32(0x3800_0000) + (f16.astype(np.uint32) << np.uint32(13))).view(
        np.float32
    )
    return np.where(v == 0.0, np.float32(0.0), back).astype(np.float32)


_image_id_counter = itertools.count()


class Image:
    """RGBA texel array in linear space, quantised to the reference's f16.

    data is a numpy array of shape [height, width, 4] float32.
    """

    def __init__(self, data: np.ndarray, width: int, height: int):
        if width * height > (1 << 32) - 1:
            raise ImageError("image dimensions exceed what is addressable with f32")
        if data.shape[0] * data.shape[1] != width * height:
            raise ImageError(
                f"buffer has {data.shape[0] * data.shape[1]} pixels, which does not "
                f"match the specified width ({width}) and height ({height})"
            )
        self.data = data.reshape(height, width, 4).astype(np.float32)
        self.max_x = np.float32(width - 1.0)
        self.max_y = np.float32(height - 1.0)
        self._width = width
        self._height = height
        self.id = next(_image_id_counter)

    @staticmethod
    def from_srgba(data, width: int, height: int) -> "Image":
        """From sRGB color channels and linear alpha (forma/src/styling.rs:305-322)."""
        arr = np.asarray(data, dtype=np.uint8).reshape(-1, 4)
        rgb = _srgb_to_linear(arr[:, :3])
        alpha = arr[:, 3].astype(np.float32) * np.float32(1.0 / 255.0)
        texels = np.concatenate([rgb, alpha[:, None]], axis=1)
        return Image(_f16_roundtrip(texels).reshape(height, width, 4), width, height)

    @staticmethod
    def from_linear_rgba(data, width: int, height: int) -> "Image":
        arr = np.asarray(data, dtype=np.float32).reshape(-1, 4)
        return Image(_f16_roundtrip(arr).reshape(height, width, 4), width, height)

    def width(self) -> int:
        return self._width

    def height(self) -> int:
        return self._height


@dataclass(frozen=True)
class Texture:
    """Shades a surface with a bitmap; transform maps screen -> texture space."""

    transform: AffineTransform
    image: Image


@dataclass(frozen=True)
class Fill:
    """Solid color, gradient or texture fill (forma/src/styling.rs:377-388)."""

    SOLID = 0
    GRADIENT = 1
    TEXTURE = 2

    kind: int = SOLID
    color: Color = field(default_factory=Color)
    gradient: Optional[Gradient] = None
    texture: Optional[Texture] = None

    @staticmethod
    def Solid(color: Color) -> "Fill":
        return Fill(kind=Fill.SOLID, color=color)

    @staticmethod
    def Gradient(gradient: Gradient) -> "Fill":
        return Fill(kind=Fill.GRADIENT, gradient=gradient)

    @staticmethod
    def Texture(texture: Texture) -> "Fill":
        return Fill(kind=Fill.TEXTURE, texture=texture)


class BlendMode(enum.Enum):
    Over = 0
    Multiply = 1
    Screen = 2
    Overlay = 3
    Darken = 4
    Lighten = 5
    ColorDodge = 6
    ColorBurn = 7
    HardLight = 8
    SoftLight = 9
    Difference = 10
    Exclusion = 11
    Hue = 12
    Saturation = 13
    Color = 14
    Luminosity = 15


@dataclass(frozen=True)
class Style:
    is_clipped: bool = False
    fill: Fill = field(default_factory=Fill)
    blend_mode: BlendMode = BlendMode.Over


@dataclass(frozen=True)
class Func:
    """Either draws with a style, or clips the following ``n`` orders
    (forma/src/styling.rs:423-436)."""

    DRAW = 0
    CLIP = 1

    kind: int = DRAW
    style: Style = field(default_factory=Style)
    clip: int = 0

    @staticmethod
    def Draw(style: Style) -> "Func":
        return Func(kind=Func.DRAW, style=style)

    @staticmethod
    def Clip(n: int) -> "Func":
        return Func(kind=Func.CLIP, clip=n)


@dataclass(frozen=True)
class Props:
    fill_rule: FillRule = FillRule.NonZero
    func: Func = field(default_factory=Func)
