"""K1: per-line parameter expansion onto virtual lines.

Counterpart of `forma_tpu/ops/expand_pallas.py:113-198`
(`expand_params_pallas`).  Each virtual line v (at most `k_seg` pixel
segments of one line) receives a bit-exact copy of its owning line's 16
f32 params and its index j within that line.  Line ownership is
monotonic: vline v belongs to the first line whose inclusive vline end
exceeds v, so the CUDA kernel (`csrc/expand.cu`) finds it by an
upper-bound binary search over `vline_ends`, which skips dead lines
(equal ends) for free.
"""

from __future__ import annotations

import torch

from . import _build
from .line_setup import N_PARAMS


def expand_params(params, vline_ends, v_cap: int):
    """Returns (params_t f32 [16, v_cap], j i32 [v_cap]).

    params f32 [L, 16] (L >= 1); vline_ends int64 [L] (u32 values)
    inclusive cumsum of per-line vline counts.  Dead lines (no vlines)
    repeat the previous end, so unlike `expand_params_pallas` no `live`
    mask is needed.  params_t[:, v] is the owning line's row; rows of padding
    vlines (v >= the true vline total) are ZERO and their j is v - total,
    as in the Pallas contract.  CUDA tensors launch `forma_expand`; CPU
    tensors take `expand_params_torch`."""
    if not params.is_cuda:
        return expand_params_torch(params, vline_ends, v_cap)
    L = params.shape[0]
    if L < 1 or not (0 < v_cap < (1 << 24)):
        raise ValueError(f"expand_params: L={L}, v_cap={v_cap} out of range")
    _build.check(params, "params", torch.float32, (L, N_PARAMS))
    _build.check(vline_ends, "vline_ends", torch.int64, (L,))
    pt = torch.empty((N_PARAMS, v_cap), dtype=torch.float32, device=params.device)
    j = torch.empty((v_cap,), dtype=torch.int32, device=params.device)
    _build.launch(
        "forma_expand", "expand",
        params.data_ptr(), vline_ends.data_ptr(), L, v_cap,
        pt.data_ptr(), j.data_ptr(),
    )
    return pt, j


def expand_params_torch(params, vline_ends, v_cap: int):
    """Plain PyTorch version of `expand_params`: the XLA gather branch of
    `rasterize._expand_emit_packed` (`forma_tpu/ops/rasterize.py:250-264`)
    with padding rows zeroed."""
    L = params.shape[0]
    iota_v = torch.arange(v_cap, dtype=torch.int64, device=params.device)
    # Upper bound: the first line whose inclusive end exceeds v; L for
    # padding vlines.
    line_id = torch.searchsorted(vline_ends, iota_v, right=True)
    starts = torch.cat([vline_ends.new_zeros(1), vline_ends])  # exclusive
    j = (iota_v - starts[line_id]).to(torch.int32)
    padded = torch.cat([params, params.new_zeros((1, N_PARAMS))])
    return padded[line_id].t().contiguous(), j
