// K3: the per-tile paint fold, table mode.
//
// Replaces forma_tpu/ops/paint_pallas.py:paint_fold_pallas (_make_kernel and
// _gradient_fill), which the TPU runs over 32-tile blocks whose unit rows are
// DMA'd into VMEM from a gathered [U, 384] unit matrix, with the carry
// expansion and exclusive cover prefix done as byte-split bf16 one-hot
// matmuls and every blend mode of the frame computed and selected.  Here:
//
//   one block per tile, 256 threads, one pixel each; the pixel's RGBA (and,
//   for clip frames, its clip mask) stays in registers over the tile's whole
//   unit list (no depth cap and no shared memory that grows with it);
//   unit k of tile t is ust[t] + k; its run r = src2[unit] addresses the
//   per-run tables directly (grid row, carry_in, carry_after, run tile x,
//   style row), so no unit matrix is ever gathered;
//   a unit is virtual when tx_s[r] differs from the tile's own x: it takes
//   no grid and carry_after[r]; a real unit takes carry_in[r];
//   the exclusive cover prefix along each 16-pixel row is an integer warp
//   scan (__shfl_up_sync over 16-lane halves: one warp holds two rows);
//   all 256 threads handle the same unit, so its style (fill type, blend
//   mode, clip function) is uniform across the block: the fill and the
//   blend mode are branches on the unit's codes with no divergence, and
//   only the selected mode is computed, where the TPU computes every mode
//   of the frame and selects; the bits are the same;
//   the clip state (clip_last, the end of the open clip range) is per tile
//   and every thread updates its copy in the same order;
//   four specialisations, one per launch counter: solid/Over (compiles
//   none of the fill, blend or clip code), styled (gradient fills and blend
//   modes, each a runtime branch on a lane offset >= 0 and the unit's code),
//   textured (the styled code plus texture fills) and clip (the textured
//   code plus the clip state); lane offsets and the stop count come in as
//   runtime arguments;
//   a texture fill (fill type 2; paint.py:_texture_at, which the JAX
//   package runs on its XLA wave fold, never in the Pallas kernel) samples
//   the linear f32 atlas inside the fold, as forma's GPU painter does in
//   its one kernel: a texture unit's 10 texture lanes are broadcast loads
//   behind the fill-type branch, the texel one 16-byte float4 load per
//   pixel through the cache, at int64 offsets (the atlas reaches 4096 x
//   4096 texels, 256 MB).
//
// Bit-equality with the plain PyTorch version (fold_kernel.paint_fold_torch):
// every f32 op is an explicitly rounded intrinsic (and --fmad=false) in the
// Pallas kernel's expression tree; Python constants are f32 literals; `1.0 /
// x` is a correctly rounded reciprocal; torch.minimum / maximum / clamp(max)
// propagate NaN, which fminf / fmaxf would drop, so they are written as
// compare-and-select; the gradient stop chain keeps the `acc ^ (t < end)`
// masks exactly, since padded stops (last colour, +inf) make local_t NaN or
// inf outside them; a texture coordinate converts to int as XLA does (NaN
// -> 0, saturating: __float2int_rz), and the texel index clamps into the
// atlas as JAX's gather does.
//
// Bound on the H100: latency of the dependent per-unit loads (unit -> run ->
// grid row, style row) times the tile depth; the grid row read is one
// coalesced 1 KB load per unit, the style row a broadcast.  A styled unit
// adds ~90 f32 ops per pixel (gradient + stop chain + blend) to the 29 of a
// solid/Over unit, a texture unit 18 and one dependent 16-byte texel load.
// Each tile's pixels are written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPDA = 512;  // PIXEL_DOUBLE_AREA
constexpr int kPDW = 32;   // PIXEL_DOUBLE_WIDTH
constexpr int kUnclipped = 32;  // FLAG_UNCLIPPED

// Style-row lane offsets (fold_kernel.style_layout; -1 when absent), the
// row width and the gradient stop count.
struct Lay {
  int fr, blend, ft, func, layer, cend, clipped, grad, stops, width, ms;
};

__device__ __forceinline__ float F(int32_t bits) { return __int_as_float(bits); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
// torch.minimum / torch.maximum / torch.clamp(max=): NaN-propagating.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct Rgb {
  float r, g, b;
};

// The texture atlas (f32 [ah, aw, 4], linear) and the offset of the
// style row's texture lanes (-1: a frame without textures).
struct Tex {
  const float4* atlas;
  int64_t ah, aw;
  int off;
};

// paint.py:_lum, _clip_color, _set_lum, _set_sat (forma_tpu/ops/paint.py:418-454).
__device__ __forceinline__ float lum(float r, float g, float b) {
  return add(mul(r, 0.3f), add(mul(g, 0.59f), mul(b, 0.11f)));
}

__device__ __forceinline__ float chroma(float r, float g, float b) {
  return sub(tmax(r, tmax(g, b)), tmin(r, tmin(g, b)));
}

__device__ Rgb clip_color(float r, float g, float b) {
  const float l = lum(r, g, b);
  const float n = tmin(r, tmin(g, b));
  const float x = tmax(r, tmax(g, b));
  const float l_1 = sub(l, 1.0f);
  const float x_l_recip = rcp(sub(x, l));
  const float l_n_recip_l = mul(rcp(sub(l, n)), l);
  auto one = [&](float ch) {
    const float low = n < 0.0f ? add(mul(l_n_recip_l, sub(ch, l)), l) : ch;
    const float high = add(mul(x_l_recip, add(mul(l, sub(l_1, ch)), ch)), l);
    return x > 1.0f ? high : low;
  };
  return {one(r), one(g), one(b)};
}

__device__ __forceinline__ Rgb set_lum(Rgb c, float l) {
  const float d = sub(l, lum(c.r, c.g, c.b));
  return clip_color(add(c.r, d), add(c.g, d), add(c.b, d));
}

__device__ Rgb set_sat(float sat_dst, float r, float g, float b) {
  const float mn = tmin(r, tmin(g, b));
  const float mx = tmax(r, tmax(g, b));
  const float mid = sub(sub(add(add(r, g), b), mn), mx);
  const bool lt = mn < mx;
  const float sat_mid =
      lt ? dv(sub(mul(sat_dst, mid), mul(sat_dst, mn)), sub(mx, mn)) : 0.0f;
  const float sat_max = lt ? sat_dst : 0.0f;
  auto one = [&](float ch) {
    return ch == mx ? sat_max : (ch == mn ? 0.0f : sat_mid);
  };
  return {one(r), one(g), one(b)};
}

// One channel of the separable modes (paint.py:_blend_one, modes 1-11).
__device__ __forceinline__ float blend_sep(int mode, float d, float s) {
  switch (mode) {
    case 1:  // Multiply
      return mul(d, s);
    case 2:  // Screen
      return sub(add(d, s), mul(d, s));
    case 3:    // Overlay
    case 8: {  // HardLight
      const float lo = mul(mul(d, s), 2.0f);
      const float hi = mul(2.0f, sub(add(d, s), add(mul(d, s), 0.5f)));
      return (mode == 3 ? d <= 0.5f : s <= 0.5f) ? lo : hi;
    }
    case 4:  // Darken
      return tmin(d, s);
    case 5:  // Lighten
      return tmax(d, s);
    case 6:  // ColorDodge
      return s == 1.0f ? 1.0f : tmin(dv(d, sub(1.0f, s)), 1.0f);
    case 7:  // ColorBurn
      return s == 0.0f ? 0.0f : sub(1.0f, tmin(dv(sub(1.0f, d), s), 1.0f));
    case 9: {  // SoftLight
      const float dd = d <= 0.25f
                           ? mul(add(mul(sub(mul(16.0f, d), 12.0f), d), 4.0f), d)
                           : __fsqrt_rn(d);
      const float s2 = sub(mul(2.0f, s), 1.0f);
      const float lo = add(mul(mul(d, sub(1.0f, d)), s2), d);
      const float hi = add(mul(sub(dd, d), s2), d);
      return s <= 0.5f ? lo : hi;
    }
    case 10:  // Difference
      return fabsf(sub(d, s));
    case 11:  // Exclusion
      return add(add(mul(mul(-2.0f, d), s), d), s);
    default:
      return s;
  }
}

// The unit's blend mode on dst (d) and fill (s); Over (0) returns s.
__device__ Rgb blend(int mode, Rgb d, Rgb s) {
  switch (mode) {
    case 12:  // Hue
      return set_lum(set_sat(chroma(d.r, d.g, d.b), s.r, s.g, s.b),
                     lum(d.r, d.g, d.b));
    case 13:  // Saturation
      return set_lum(set_sat(chroma(s.r, s.g, s.b), d.r, d.g, d.b),
                     lum(d.r, d.g, d.b));
    case 14:  // Color
      return set_lum(s, lum(d.r, d.g, d.b));
    case 15:  // Luminosity
      return set_lum(d, lum(s.r, s.g, s.b));
    default:
      return {blend_sep(mode, d.r, s.r), blend_sep(mode, d.g, s.g),
              blend_sep(mode, d.b, s.b)};
  }
}

// paint.py:_gradient_at (paint_pallas.py:_gradient_fill) at one pixel.
__device__ void gradient(const int32_t* __restrict__ gm,
                         const int32_t* __restrict__ sp, int ms, float xg,
                         float yg, float& c0, float& c1, float& c2, float& c3) {
  const float gtype = F(gm[0]), sx = F(gm[1]), sy = F(gm[2]);
  const float gdx = F(gm[3]), gdy = F(gm[4]);
  const float dot_recip = F(gm[5]);
  const float tx = mul(mul(sub(xg, sx), gdx), dot_recip);
  const float t_lin = add(mul(mul(sub(yg, sy), gdy), dot_recip), tx);
  const float px = sub(xg, sx);
  const float py = sub(yg, sy);
  const float t_rad = __fsqrt_rn(mul(add(mul(py, py), mul(px, px)), dot_recip));
  const float t = gtype == 1.0f ? t_rad : t_lin;

  bool acc = t <= F(sp[4]);
  c0 = acc ? F(sp[0]) : 0.0f;
  c1 = acc ? F(sp[1]) : 0.0f;
  c2 = acc ? F(sp[2]) : 0.0f;
  c3 = acc ? F(sp[3]) : 0.0f;
  for (int i = 1; i < ms; ++i) {
    const int32_t* s0 = sp + 5 * (i - 1);
    const int32_t* s1 = sp + 5 * i;
    const float start_stop = F(s0[4]);
    const float end_stop = F(s1[4]);
    const bool m = acc ^ (t < end_stop);
    if (m) {
      const float local_t = mul(sub(t, start_stop), rcp(sub(end_stop, start_stop)));
      auto lerp = [&](int ch) {
        const float sc = F(s0[ch]);
        const float ec = F(s1[ch]);
        return add(mul(local_t, ec), add(mul(-local_t, sc), sc));
      };
      c0 = lerp(0);
      c1 = lerp(1);
      c2 = lerp(2);
      c3 = lerp(3);
    }
    acc = acc | m;
  }
}

// paint.py:_texture_at at one pixel: tl = (ux, uy, vx, vy, tx, ty, max_x,
// max_y, ax, ay).  min and the clamp at 0 propagate NaN, which the int
// conversion then maps to 0.
__device__ __forceinline__ float4 texel(const Tex& tex, const float* tl,
                                        float xg, float yg) {
  const float sx = add(mul(xg, tl[0]), add(mul(tl[2], yg), tl[4]));
  const float sy = add(mul(xg, tl[1]), add(mul(tl[3], yg), tl[5]));
  const int64_t ix = __float2int_rz(tmax(truncf(tmin(sx, tl[6])), 0.0f));
  const int64_t iy = __float2int_rz(tmax(truncf(tmin(sy, tl[7])), 0.0f));
  int64_t col = __float2int_rz(tl[8]) + ix;
  int64_t row = __float2int_rz(tl[9]) + iy;
  col = col < 0 ? 0 : (col > tex.aw - 1 ? tex.aw - 1 : col);
  row = row < 0 ? 0 : (row > tex.ah - 1 ? tex.ah - 1 : row);
  return __ldg(tex.atlas + row * tex.aw + col);
}

// kStyled: gradients and blend modes; kTex (implies kStyled): texture
// fills; kClip (implies kTex): clip masks.  Register caps for occupancy:
// the fold is bound by the latency of its dependent per-unit loads.  The
// solid, styled and textured folds are held to 32 registers (8 blocks of
// 256 threads per SM; the styled fold otherwise takes 40 and 6 blocks),
// the clip fold to 40 (6 blocks).
template <bool kStyled, bool kClip, bool kTex>
__global__ void __launch_bounds__(256, kClip ? 6 : 8)
fold_kernel(const int32_t* __restrict__ ust, const int32_t* __restrict__ cnt,
            const int32_t* __restrict__ src2, const int32_t* __restrict__ virt,
            const int32_t* __restrict__ grid,
            const int32_t* __restrict__ carry_in,
            const int32_t* __restrict__ carry_after,
            const int32_t* __restrict__ tx_s,
            const int32_t* __restrict__ style,
            const float* __restrict__ clear, Lay lay, int64_t tiles_x,
            int64_t run_cap, int64_t n_units, float* __restrict__ out,
            Tex tex) {
  const int64_t t = blockIdx.x;
  const int p = threadIdx.x;  // pixel: y = p >> 4, x = p & 15
  const int py = p >> 4;
  const int px = p & 15;
  const int tile_tx = (int)(t % tiles_x);
  const float recip = 1.0f / kPDA;
  // Integer global pixel coordinates (paint_pallas.py:254-262).
  float xg = 0.0f, yg = 0.0f;
  if (kStyled) {
    xg = __int2float_rn(tile_tx * 16 + px);
    yg = __int2float_rn((int)(t / tiles_x) * 16 + py);
  }
  float clipm = 0.0f;
  int32_t clip_last = -1;

  float dr = clear[0], dg = clear[1], db = clear[2], da = clear[3];
  const int n = cnt[t];
  const int64_t base = ust[t];
  for (int k = 0; k < n; ++k) {
    int64_t u = base + k;
    if (u > n_units - 1) u = n_units - 1;
    int64_t r = src2[u];
    r = r < 0 ? 0 : (r > run_cap - 1 ? run_cap - 1 : r);
    const bool is_virt = tx_s[r] != tile_tx;

    int32_t cover = 0, area = 0;
    if (!is_virt) {
      const int32_t g = grid[r * 256 + p];
      cover = (int32_t)(int16_t)(g & 0xFFFF);
      area = (int32_t)((uint32_t)g - (uint32_t)cover) >> 16;
    }
    const int32_t c16 =
        is_virt ? carry_after[r * 16 + py] : carry_in[r * 16 + py];

    // Inclusive scan of cover over the 16 pixels of this row.
    int32_t inc = cover;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, inc, off, 16);
      if (px >= off) inc += y;
    }
    const int32_t ce_exc = c16 + (inc - cover);

    const int32_t dacc = kPDW * ce_exc + area;
    // A solid/Over frame's row is rgba | fill rule at compile-time offsets.
    const int32_t* st = style + r * (kStyled ? lay.width : 5);
    const bool fr_eo = st[kStyled ? lay.fr : 4] != 0;
    const float nz =
        fminf(fmaxf(fabsf(__fmul_rn(__int2float_rn(dacc), recip)), 0.0f), 1.0f);
    const int32_t folded = kPDA - abs((dacc & (2 * kPDA - 1)) - kPDA);
    const float eo = __fmul_rn(__int2float_rn(folded), recip);
    const float cov = fr_eo ? eo : nz;

    bool draw = true;
    if (kClip) {
      const int32_t func = st[lay.func];
      draw = func == 0;
      const bool is_clip_unit = func == 1;
      // Clip expiry precedes everything (painter/mod.rs:302-306).
      if (clip_last >= 0 && clip_last < st[lay.layer]) clip_last = -1;
      if (is_clip_unit && clip_last < 0) clip_last = st[lay.cend];
      if (is_clip_unit) clipm = cov;
    }

    float fr = F(st[0]), fg = F(st[1]), fb = F(st[2]);
    float fa = F(st[3]);
    // Lane 0 stands in for an absent fill-type or blend lane, so both loads
    // issue with the unit's other style loads instead of behind a branch.
    const int32_t fill_type = kStyled ? st[lay.ft >= 0 ? lay.ft : 0] : 0;
    const int32_t mode = kStyled ? st[lay.blend >= 0 ? lay.blend : 0] : 0;
    if (kStyled && lay.ft >= 0 && fill_type == 1) {
      gradient(st + lay.grad, st + lay.stops, lay.ms, xg, yg, fr, fg, fb, fa);
    }
    if (kTex && tex.off >= 0 && fill_type == 2) {
      // The texture lanes load behind the branch: issued with the unit's
      // other style loads instead, every solid unit loads them too, and
      // the fold ran 3.5% slower on paris-30k-textured (PERF.md).
      float tl[10];
#pragma unroll
      for (int i = 0; i < 10; ++i) tl[i] = F(st[tex.off + i]);
      const float4 c = texel(tex, tl, xg, yg);
      fr = c.x;
      fg = c.y;
      fb = c.z;
      fa = c.w;
    }

    float src_a = mul(fa, cov);
    if (kClip) {
      // FLAG_UNCLIPPED: the draw's governing full clip was dropped.
      const bool clipped =
          st[lay.clipped] == 1 && (virt[u] & kUnclipped) == 0;
      if (clipped) src_a = clip_last >= 0 ? mul(src_a, clipm) : 0.0f;
      src_a = mul(src_a, draw ? 1.0f : 0.0f);
    }

    Rgb bl = {fr, fg, fb};
    if (kStyled && lay.blend >= 0) bl = blend(mode, {dr, dg, db}, {fr, fg, fb});

    const float inv_dst_a = sub(1.0f, da);
    const float inv_dst_a_src_a = mul(inv_dst_a, src_a);
    const float inv_src_a = sub(1.0f, src_a);
    const float dst_a_src_a = mul(da, src_a);
    dr = add(mul(dr, inv_src_a),
             add(mul(fr, inv_dst_a_src_a), mul(bl.r, dst_a_src_a)));
    dg = add(mul(dg, inv_src_a),
             add(mul(fg, inv_dst_a_src_a), mul(bl.g, dst_a_src_a)));
    db = add(mul(db, inv_src_a),
             add(mul(fb, inv_dst_a_src_a), mul(bl.b, dst_a_src_a)));
    da = add(mul(da, inv_src_a), src_a);
  }
  float* o = out + t * 1024;
  o[p] = dr;
  o[256 + p] = dg;
  o[512 + p] = db;
  o[768 + p] = da;
}

using FoldFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, const int32_t*,
                        const float*, Lay, int64_t, int64_t, int64_t, float*,
                        Tex);

// Solid/Over, styled, textured, clip (fold_kernel.variant).
const FoldFn kFold[4] = {
    fold_kernel<false, false, false>,
    fold_kernel<true, false, false>,
    fold_kernel<true, false, true>,
    fold_kernel<true, true, true>,
};

}  // namespace

// layout (host memory): fr, blend, ft, func, layer, cend, clipped, grad,
// stops, width, ms, tex; an offset of -1 leaves its feature out.  virt may
// be null for a frame without clips, atlas for a frame without textures.
extern "C" int forma_fold(const void* ust, const void* cnt, const void* src2,
                          const void* virt, const void* grid,
                          const void* carry_in, const void* carry_after,
                          const void* tx_s, const void* style,
                          const void* clear, const void* layout,
                          int64_t n_tiles, int64_t tiles_x, int64_t run_cap,
                          int64_t n_units, void* out, const void* atlas,
                          int64_t atlas_h, int64_t atlas_w,
                          cudaStream_t stream) {
  const int32_t* l = static_cast<const int32_t*>(layout);
  const Lay lay = {l[0], l[1], l[2], l[3], l[4], l[5],
                   l[6], l[7], l[8], l[9], l[10]};
  const Tex tex = {static_cast<const float4*>(atlas), atlas_h, atlas_w, l[11]};
  const int idx =
      lay.func >= 0
          ? 3
          : (tex.off >= 0 ? 2 : (lay.grad >= 0 || lay.blend >= 0 ? 1 : 0));
  kFold[idx]<<<(unsigned)n_tiles, 256, 0, stream>>>(
      static_cast<const int32_t*>(ust), static_cast<const int32_t*>(cnt),
      static_cast<const int32_t*>(src2), static_cast<const int32_t*>(virt),
      static_cast<const int32_t*>(grid),
      static_cast<const int32_t*>(carry_in),
      static_cast<const int32_t*>(carry_after),
      static_cast<const int32_t*>(tx_s), static_cast<const int32_t*>(style),
      static_cast<const float*>(clear), lay, tiles_x, run_cap, n_units,
      static_cast<float*>(out), tex);
  return (int)cudaGetLastError();
}
