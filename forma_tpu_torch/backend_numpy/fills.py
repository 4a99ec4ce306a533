"""Fill evaluation and blend math, vectorised over pixel grids.

Mirrors `forma/src/cpu/painter/styling.rs`: gradients and textures are
evaluated per pixel; the 16 blend modes follow the SIMD `blend_function!`
select-tree semantics (both branches computed, selected per lane), which is
also how the device backends compute them.

All functions take/return float32 arrays of identical shape (broadcastable
pixel grids).
"""

from __future__ import annotations

import numpy as np


def _f64(v):
    return np.asarray(v, np.float64)

from ..styling import BlendMode, Fill, Gradient, GradientType, Texture


def _fma(a, b, c):
    return (_f64(a) * _f64(b) + _f64(c)).astype(np.float32)


def gradient_color_at(g: Gradient, x: np.ndarray, y: np.ndarray):
    """Evaluates a gradient at pixel coordinates (`painter/styling.rs:58-143`).

    Returns [r, g, b, a] arrays of x's shape.
    """
    sx = np.float32(g.start.x)
    sy = np.float32(g.start.y)
    dx = np.float32(g.end.x) - sx
    dy = np.float32(g.end.y) - sy
    dot = np.float32(dx * dx + dy * dy)
    dot_recip = np.float32(1.0) / dot

    if g.type == GradientType.Linear:
        tx = (x - sx) * dx * dot_recip
        t = _fma((y - sy) * dy, dot_recip, tx)
    else:
        px = x - sx
        py = y - sy
        t = np.sqrt(_fma(py, py, px * px) * dot_recip).astype(np.float32)

    stops = g.stops
    channels = [np.zeros_like(t) for _ in range(4)]

    mask = t <= np.float32(stops[0][1])
    c0 = stops[0][0].to_array()
    for ch in range(4):
        channels[ch] = np.where(mask, np.float32(c0[ch]), channels[ch])

    acc_mask = mask
    start_stop = np.float32(0.0)
    start_color = stops[0][0]
    for color, end_stop in stops[1:]:
        m = acc_mask ^ (t < np.float32(end_stop))
        d_ = np.float32(end_stop) - start_stop
        local_t = (t - start_stop) * (np.float32(1.0) / d_)
        sc = start_color.to_array()
        ec = color.to_array()
        for ch in range(4):
            v = _fma(local_t, np.float32(ec[ch]), _fma(-local_t, np.float32(sc[ch]), np.float32(sc[ch])))
            channels[ch] = np.where(m, v, channels[ch])
        acc_mask = acc_mask | m
        start_stop = np.float32(end_stop)
        start_color = color

    last = stops[-1][0].to_array()
    m = ~acc_mask
    for ch in range(4):
        channels[ch] = np.where(m, np.float32(last[ch]), channels[ch])
    return channels


def texture_color_at(tex: Texture, x: np.ndarray, y: np.ndarray):
    """Samples a texture at pixel coordinates (`painter/styling.rs:146-193`):
    affine transform, clamp, nearest texel."""
    t = tex.transform
    tx = _fma(x, np.float32(t.ux), _fma(np.float32(t.vx), y, np.float32(t.tx)))
    ty = _fma(x, np.float32(t.uy), _fma(np.float32(t.vy), y, np.float32(t.ty)))
    # Saturating f32 -> u32 conversion: negatives clamp to 0, then min(max).
    ix = np.minimum(tx, tex.image.max_x)
    iy = np.minimum(ty, tex.image.max_y)
    ix = np.clip(np.trunc(ix), 0, None).astype(np.int64)
    iy = np.clip(np.trunc(iy), 0, None).astype(np.int64)
    data = tex.image.data.reshape(-1, 4)
    offs = iy * np.int64(tex.image.width()) + ix
    texels = data[offs]
    return [texels[..., ch].astype(np.float32) for ch in range(4)]


def fill_at(fill: Fill, x: np.ndarray, y: np.ndarray):
    if fill.kind == Fill.SOLID:
        c = fill.color.to_array()
        return [np.full_like(x, np.float32(c[ch]), dtype=np.float32) for ch in range(4)]
    if fill.kind == Fill.GRADIENT:
        return gradient_color_at(fill.gradient, x, y)
    return texture_color_at(fill.texture, x, y)


# -- blend modes (SIMD select-tree semantics, painter/styling.rs:342-594) ----


def _lum(r, g, b):
    return _fma(r, np.float32(0.3), _fma(g, np.float32(0.59), b * np.float32(0.11)))


def _sat(r, g, b):
    return np.maximum(r, np.maximum(g, b)) - np.minimum(r, np.minimum(g, b))


def _clip_color(r, g, b):
    l = _lum(r, g, b)
    n = np.minimum(r, np.minimum(g, b))
    x = np.maximum(r, np.maximum(g, b))
    l_1 = l - np.float32(1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_l_recip = np.float32(1.0) / (x - l)
        l_n_recip_l = (np.float32(1.0) / (l - n)) * l

        def one(c):
            low = np.where(n < 0.0, _fma(l_n_recip_l, c - l, l), c)
            high = _fma(x_l_recip, _fma(l, l_1 - c, c), l)
            return np.where(np.float32(1.0) < x, high, low)

        return [one(r), one(g), one(b)]


def _set_lum(r, g, b, l):
    d = l - _lum(r, g, b)
    return _clip_color(r + d, g + d, b + d)


def _set_sat(sat_dst, s_r, s_g, s_b):
    src_min = np.minimum(s_r, np.minimum(s_g, s_b))
    src_max = np.maximum(s_r, np.maximum(s_g, s_b))
    src_mid = s_r + s_g + s_b - src_min - src_max
    min_lt_max = src_min < src_max
    with np.errstate(divide="ignore", invalid="ignore"):
        sat_mid = np.where(
            min_lt_max,
            _fma(sat_dst, -src_min, sat_dst * src_mid) / (src_max - src_min),
            np.float32(0.0),
        )
    sat_max = np.where(min_lt_max, sat_dst, np.float32(0.0))

    def one(s):
        return np.where(
            s == src_max, sat_max, np.where(s == src_min, np.float32(0.0), sat_mid)
        )

    return [one(s_r), one(s_g), one(s_b)]


def blend_function(mode: BlendMode, dst_r, dst_g, dst_b, src_r, src_g, src_b):
    """Returns the blended [r, g, b] before compositing."""
    one = np.float32(1.0)
    two = np.float32(2.0)
    half = np.float32(0.5)

    if mode == BlendMode.Over:
        return [src_r, src_g, src_b]
    if mode == BlendMode.Multiply:
        return [dst_r * src_r, dst_g * src_g, dst_b * src_b]
    if mode == BlendMode.Screen:
        return [
            _fma(d, -s, d) + s
            for d, s in ((dst_r, src_r), (dst_g, src_g), (dst_b, src_b))
        ]
    if mode in (BlendMode.Overlay, BlendMode.HardLight):
        out = []
        for d, s in ((dst_r, src_r), (dst_g, src_g), (dst_b, src_b)):
            lo = d * s * two
            hi = two * (d + s - _fma(d, s, half))
            sel = d <= half if mode == BlendMode.Overlay else s <= half
            out.append(np.where(sel, lo, hi))
        return out
    if mode == BlendMode.Darken:
        return [np.minimum(dst_r, src_r), np.minimum(dst_g, src_g), np.minimum(dst_b, src_b)]
    if mode == BlendMode.Lighten:
        return [np.maximum(dst_r, src_r), np.maximum(dst_g, src_g), np.maximum(dst_b, src_b)]
    if mode == BlendMode.ColorDodge:
        out = []
        with np.errstate(divide="ignore", invalid="ignore"):
            for d, s in ((dst_r, src_r), (dst_g, src_g), (dst_b, src_b)):
                out.append(
                    np.where(s == one, one, np.minimum(one, d / (one - s)))
                )
        return out
    if mode == BlendMode.ColorBurn:
        out = []
        with np.errstate(divide="ignore", invalid="ignore"):
            for d, s in ((dst_r, src_r), (dst_g, src_g), (dst_b, src_b)):
                out.append(
                    np.where(
                        s == 0.0, np.float32(0.0), one - np.minimum(one, (one - d) / s)
                    )
                )
        return out
    if mode == BlendMode.SoftLight:
        out = []
        quarter = np.float32(0.25)
        for d, s in ((dst_r, src_r), (dst_g, src_g), (dst_b, src_b)):
            dd = np.where(
                d <= quarter,
                _fma(_fma(np.float32(16.0), d, np.float32(-12.0)), d, np.float32(4.0)) * d,
                np.sqrt(d).astype(np.float32),
            )
            lo = _fma(d * (one - d), _fma(two, s, -one), d)
            hi = _fma(dd - d, _fma(two, s, -one), d)
            out.append(np.where(s <= half, lo, hi))
        return out
    if mode == BlendMode.Difference:
        return [np.abs(dst_r - src_r), np.abs(dst_g - src_g), np.abs(dst_b - src_b)]
    if mode == BlendMode.Exclusion:
        return [
            _fma(np.float32(-2.0) * d, s, d) + s
            for d, s in ((dst_r, src_r), (dst_g, src_g), (dst_b, src_b))
        ]
    if mode == BlendMode.Hue:
        r, g, b = _set_sat(_sat(dst_r, dst_g, dst_b), src_r, src_g, src_b)
        return _set_lum(r, g, b, _lum(dst_r, dst_g, dst_b))
    if mode == BlendMode.Saturation:
        r, g, b = _set_sat(_sat(src_r, src_g, src_b), dst_r, dst_g, dst_b)
        return _set_lum(r, g, b, _lum(dst_r, dst_g, dst_b))
    if mode == BlendMode.Color:
        return _set_lum(src_r, src_g, src_b, _lum(dst_r, dst_g, dst_b))
    if mode == BlendMode.Luminosity:
        return _set_lum(dst_r, dst_g, dst_b, _lum(src_r, src_g, src_b))
    raise ValueError(mode)


def composite(dst, src_rgb, src_a, blended):
    """The compositing equation (`painter/mod.rs:406-447`): dst and results
    are [r, g, b, a] lists."""
    one = np.float32(1.0)
    inv_dst_a = one - dst[3]
    inv_dst_a_src_a = inv_dst_a * src_a
    inv_src_a = one - src_a
    dst_a_src_a = dst[3] * src_a

    out = []
    for ch in range(3):
        current = _fma(src_rgb[ch], inv_dst_a_src_a, blended[ch] * dst_a_src_a)
        out.append(_fma(dst[ch], inv_src_a, current))
    out.append(_fma(dst[3], inv_src_a, src_a))
    return out


# -- output conversion (painter/mod.rs:96-162) -------------------------------


def linear_to_srgb_approx(l: np.ndarray) -> np.ndarray:
    a = np.float32(0.201_017_72)
    b = np.float32(-0.512_801_47)
    c = np.float32(1.344_401)
    d = np.float32(-0.030_656_587)
    s = np.sqrt(l).astype(np.float32)
    s2 = l
    s3 = (s2 * s).astype(np.float32)
    m = l * np.float32(12.92)
    n = _fma(a, s3, _fma(b, s2, _fma(c, s, d)))
    return np.where(l <= np.float32(0.003_130_8), m, n)


def to_u8(val: np.ndarray) -> np.ndarray:
    """f32 [0,1] -> u8 with round-half-to-even (the 2^23 trick)."""
    scaled = np.clip(val * np.float32(255.0), 0.0, 255.0)
    # Adding 2^23 rounds the mantissa to integer with ties-to-even; numpy's
    # rint has identical semantics.
    return np.rint(scaled).astype(np.uint8)
