"""Device line setup: point chains -> per-line rasterization coefficients.

Counterpart of `forma_tpu/ops/line_setup.py:37-194` (`line_setup`): one
elementwise pass over the line arrays (per-geometry gather, affine
transform, cull, grid-crossing coefficients, Manhattan lengths, ff64
progression constants), packed into ONE [L, 16] f32 matrix, followed by
the inclusive cumsum of per-line virtual-line counts.
"""

from __future__ import annotations

import torch

from forma_tpu import consts

from . import ff64
from ._u32 import f2i32

# params column layout (same as the JAX package):
PX0, PY0, PDX, PDY, PA, PB, PC, PD = range(8)
PAOH, PAOL, PBOH, PBOL, PCDH, PCDL = range(8, 14)
PSLOT, PLEN = 14, 15  # exact f32 VALUE conversions (slot < 2^21, len < 2^24)
N_PARAMS = 16


def line_setup(
    px: torch.Tensor,  # f32 [L+1] point x
    py: torch.Tensor,  # f32 [L+1] point y
    line_slot: torch.Tensor,  # i32 [L] index into geometry tables, -1 = no line
    g_slot: torch.Tensor,  # i32 [G] layer style slot, -1 = none
    g_valid: torch.Tensor,  # bool [G]
    g_t: torch.Tensor,  # f32 [G, 6] affine (ux, uy, vx, vy, tx, ty)
    g_has_t: torch.Tensor,  # bool [G]
    width: int,
    height: int,
    k_seg: int = 8,
):
    """Returns (params f32 [L, 16], slots i32 [L], lengths i32 [L],
    vline_ends int64 [L] (u32 values) inclusive cumsum of per-line
    virtual-line counts)."""
    p0x, p0y, p1x, p1y = px[:-1], py[:-1], px[1:], py[1:]

    gi = torch.clamp(line_slot, min=0).long()
    gmat = torch.cat(
        [
            torch.stack(
                [g_slot.float(), g_valid.float(), g_has_t.float()], dim=1
            ),
            g_t,
        ],
        dim=1,
    )  # [G, 9]
    GM = gmat[gi]  # [L, 9]
    gslot_l = GM[:, 0].to(torch.int32)
    valid = (line_slot >= 0) & (GM[:, 1] == 1.0) & (gslot_l >= 0)
    slots = torch.where(valid, gslot_l, torch.zeros_like(gslot_l))

    t = GM[:, 3:9]
    has_t = GM[:, 2] == 1.0
    tp0x = t[:, 0] * p0x + (t[:, 2] * p0y + t[:, 4])
    tp0y = t[:, 1] * p0x + (t[:, 3] * p0y + t[:, 5])
    tp1x = t[:, 0] * p1x + (t[:, 2] * p1y + t[:, 4])
    tp1y = t[:, 1] * p1x + (t[:, 3] * p1y + t[:, 5])
    p0x = torch.where(has_t, tp0x, p0x)
    p0y = torch.where(has_t, tp0y, p0y)
    p1x = torch.where(has_t, tp1x, p1x)
    p1y = torch.where(has_t, tp1y, p1y)

    w = float(width)
    h = float(height)
    skip = (
        (p0y == p1y)
        | ((p0y >= h) & (p1y >= h))
        | ((p0x >= w) & (p1x >= w))
        | ((p0y <= 0.0) & (p1y <= 0.0))
    )
    valid = valid & ~skip

    dx = p1x - p0x
    dy = p1y - p0y
    dx_recip = 1.0 / dx
    dy_recip = 1.0 / dy

    zero = torch.zeros_like(dx)
    t_offset_x = torch.where(
        dx != 0.0,
        torch.maximum(
            (torch.ceil(p0x) - p0x) * dx_recip, (torch.floor(p0x) - p0x) * dx_recip
        ),
        zero,
    )
    t_offset_y = torch.where(
        dy != 0.0,
        torch.maximum(
            (torch.ceil(p0y) - p0y) * dy_recip, (torch.floor(p0y) - p0y) * dy_recip
        ),
        zero,
    )

    a = torch.abs(dx_recip)
    b = torch.abs(dy_recip)
    c = t_offset_x
    d = t_offset_y

    def integers_between(u, v):
        mn = torch.minimum(u, v)
        mx = torch.maximum(u, v)
        return torch.clamp(f2i32(torch.ceil(mx) - torch.floor(mn) - 1.0), min=0)

    lengths = integers_between(p0x, p1x) + integers_between(p0y, p1y) + 1
    lengths = torch.where(valid, lengths, torch.zeros_like(lengths))

    # ff64 progression constants, hoisted to line granularity
    # (`rasterizer.wgsl:294-323`).
    s = a + b
    degenerate = ~torch.isfinite(s)
    sum_ff = ff64.add(ff64.ff(a), ff64.ff(b))
    recip = ff64.div(ff64.ff(torch.ones_like(a)), sum_ff)

    def sel_ff(x):
        return ff64.FF(
            torch.where(degenerate, zero, x.hi), torch.where(degenerate, zero, x.lo)
        )

    a_over = sel_ff(ff64.mul(ff64.ff(a), recip))
    b_over = sel_ff(ff64.mul(ff64.ff(b), recip))
    cd_over = sel_ff(ff64.mul(ff64.sub(ff64.ff(c), ff64.ff(d)), recip))

    pw = float(consts.PIXEL_WIDTH)

    def sel(v):
        return torch.where(valid, v, zero)

    params = torch.stack(
        [
            sel(p0x * pw),
            sel(p0y * pw),
            sel(dx * pw),
            sel(dy * pw),
            sel(a),
            sel(b),
            sel(c),
            sel(d),
            sel(a_over.hi),
            sel(a_over.lo),
            sel(b_over.hi),
            sel(b_over.lo),
            sel(cd_over.hi),
            sel(cd_over.lo),
            slots.float(),
            lengths.float(),
        ],
        dim=1,
    )

    n_v = -(-lengths.long() // k_seg)  # ceil; 0 for culled lines
    vline_ends = torch.cumsum(n_v, 0) & 0xFFFFFFFF
    return params, slots, lengths, vline_ends
