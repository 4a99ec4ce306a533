"""u32 quantities held as int64.

The JAX pipeline keeps sort keys, payloads, `vline_ends`, run keys and
the `0xFFFFFFFF` sentinel as u32.  PyTorch's CPU build lacks most
`uint32` arithmetic (shifts, adds, compares, scatters), so the port holds
every such value as an int64 in [0, 2^32): the same order, the same bit
fields, and the sentinel still sorts last.  One exception: the segment
sort's keys and payloads stay 32-bit words in int32 tensors from K4 through
the sort (`rasterize_kernel.py`: valid keys fit 31 bits, the sentinel
there is 0x7FFFFFFF), and widen to int64 after it; so do the two-key
emit's payloads.  Bit views between f32
and i32 go through `Tensor.view`.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = 0xFFFFFFFF  # u32 sentinel key, sorts after every real key
MASK32 = 0xFFFFFFFF


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy array -> a copy on `device`; uint32 widens to int64.  To a
    CUDA device the copy goes through pinned memory without a host sync
    (PyTorch keeps the pinned block until the copy has run)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    device = torch.device(device)
    if device.type != "cuda":
        return torch.tensor(a, device=device)
    host = torch.from_numpy(np.array(a, order="C")).pin_memory()
    return host.to(device, non_blocking=True)


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its bit pattern as an i32 (same bits)."""
    return x.contiguous().view(torch.int32)


def bits_f32(x: torch.Tensor) -> torch.Tensor:
    """i32 bit pattern -> f32 (same bits)."""
    return x.to(torch.int32).contiguous().view(torch.float32)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> i32 by two's-complement wrap (the u32 -> i32 bitcast)."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def f2i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 with saturation and NaN -> 0, as XLA converts.

    A plain `.to(torch.int32)` of an out-of-range float is undefined in
    C++ (x86 gives INT_MIN); the JAX pipeline relies on XLA's saturating
    conversion for masked-out lanes."""
    x = torch.nan_to_num(x, nan=0.0, posinf=4e9, neginf=-4e9).clamp(-4e9, 4e9)
    return x.to(torch.int64).clamp(-(1 << 31), (1 << 31) - 1).to(torch.int32)
