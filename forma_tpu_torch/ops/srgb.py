"""Device linear -> sRGB conversion and u8 packing.

Counterpart of `forma_tpu/ops/srgb.py` (`painter/mod.rs:96-162`):
polynomial sRGB approximation on RGB, linear alpha, channel mapping, and
round-half-to-even u8 quantisation (`torch.round` ties to even, like
`jnp.round`).  Constants are f32 values, so each op rounds exactly as in
f32 arithmetic whatever precision the scalar is carried in.
"""

from __future__ import annotations

import numpy as np
import torch

# Channel codes (buffer.Channel values).
RED, GREEN, BLUE, ALPHA, ZERO, ONE = range(6)

_A = float(np.float32(0.201_017_72))
_B = float(np.float32(-0.512_801_47))
_C = float(np.float32(1.344_401))
_D = float(np.float32(-0.030_656_587))
_LIN_MAX = float(np.float32(0.003_130_8))
_LIN_SCALE = float(np.float32(12.92))


def linear_to_srgb(l: torch.Tensor) -> torch.Tensor:
    s = torch.sqrt(torch.clamp(l, min=0.0))
    n = _A * (l * s) + (_B * l + (_C * s + _D))
    return torch.where(l <= _LIN_MAX, l * _LIN_SCALE, n)


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(v * 255.0, 0.0, 255.0)).to(torch.uint8)


def pack_srgb(linear: torch.Tensor, channels=(RED, GREEN, BLUE, ALPHA)):
    """linear f32 [H, W, 4] -> u8 [H, W, len(channels)]."""
    r = linear_to_srgb(linear[..., 0])
    g = linear_to_srgb(linear[..., 1])
    b = linear_to_srgb(linear[..., 2])
    a = linear[..., 3]
    planes = {RED: r, GREEN: g, BLUE: b, ALPHA: a}
    out = []
    for ch in channels:
        if ch in planes:
            out.append(planes[ch])
        elif ch == ZERO:
            out.append(torch.zeros_like(r))
        else:
            out.append(torch.ones_like(r))
    return torch.stack([_to_u8(v) for v in out], dim=-1)
