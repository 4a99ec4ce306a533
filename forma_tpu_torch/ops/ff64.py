"""Float-float ("double-double" on f32) arithmetic.

Counterpart of `forma_tpu/ops/ff64.py`: the rasterizer's index estimation
needs ~48 mantissa bits (`forma/src/cpu/rasterizer.rs:44-47`) and the
pipeline stays in f32.  `two_product` uses the Veltkamp/Dekker split, so
every mul and add must round on its own: eager PyTorch does, and no fused
op (`addcmul`, `lerp`, ...) may appear here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FF(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def ff(val: torch.Tensor) -> FF:
    return FF(val, torch.zeros_like(val))


def _two_sum(x, y):
    r = x + y
    t = r - x
    e = (x - (r - t)) + (y - t)
    return r, e


def _two_sum_quick(x, y):
    r = x + y
    e = y - (r - x)
    return r, e


def _split(a):
    """Veltkamp split: a == hi + lo with hi, lo having <= 12 mantissa bits."""
    c = a * 4097.0  # 2^12 + 1, exact in f32
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def _two_product(x, y):
    r = x * y
    xh, xl = _split(x)
    yh, yl = _split(y)
    e = ((xh * yh - r) + xh * yl + xl * yh) + xl * yl
    return r, e


def add(x: FF, y: FF) -> FF:
    r, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return FF(*_two_sum_quick(r, e))


def sub(x: FF, y: FF) -> FF:
    r, e = _two_sum(x.hi, -y.hi)
    e = e + (x.lo - y.lo)
    return FF(*_two_sum_quick(r, e))


def mul(x: FF, y: FF) -> FF:
    r, e = _two_product(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return FF(*_two_sum_quick(r, e))


def div(x: FF, y: FF) -> FF:
    """Quotient as in `rasterizer.wgsl:119-129`."""
    r = x.hi / y.hi
    s_hi, s_lo = _two_product(r, y.hi)
    e = (((x.hi - s_hi) - s_lo) + x.lo - r * y.lo) / y.hi
    return FF(*_two_sum_quick(r, e))


def ceil(val: FF) -> torch.Tensor:
    """Ceiling of the ff64 value as f32 (`rasterizer.wgsl:131-140`)."""
    ceil_hi = torch.ceil(val.hi)
    ceil_lo = torch.ceil(val.lo)
    return torch.where(ceil_hi > val.hi, ceil_hi, ceil_hi + ceil_lo)
