// K3: the per-tile paint fold, in table mode and assembly mode.
//
// Replaces forma_tpu/ops/paint_pallas.py:paint_fold_pallas (_make_kernel and
// _gradient_fill), which the TPU runs over 32-tile blocks whose unit rows are
// DMA'd into VMEM from a gathered [U, 384] unit matrix, with the carry
// expansion and exclusive cover prefix done as byte-split bf16 one-hot
// matmuls and every blend mode of the frame computed and selected.  Here:
//
//   one block per tile, 128 threads, two horizontally adjacent pixels
//   each; the pixels' RGBA (and, for clip frames, their clip masks) stay in
//   registers over the tile's whole unit list (no depth cap);
//   unit k of tile t is ust[t] + k; its run r = src2[unit] addresses the
//   carry-chain-ordered tables (carry_in, carry_after, run tile x, style
//   row) and g = src[unit] its grid row in run order, so no unit matrix is
//   ever gathered.  After the packed-key sort the two orders are one (the
//   TPU kernel's table mode, src_u == src2_u): the caller passes one array
//   twice and the kernel loads one index.  After the two-key sort they
//   differ (its assembly mode, paint.py:245-272): g is staged beside r, 32
//   more ints of shared memory a block and one more coalesced index load
//   a chunk, where permuting the grid into carry-chain order would move
//   1 KiB per run;
//   a unit is virtual when tx_s[r] differs from the tile's own x (its
//   owner run lies in an earlier tile of the same row and layer; the TPU
//   kernel reads FLAG_VIRTUAL, which agrees): it takes no grid and
//   carry_after[r]; a real unit takes carry_in[r];
//   the exclusive cover prefix along each 16-pixel row is an integer warp
//   scan of the pairs' sums (__shfl_up_sync over 8-lane groups: one warp
//   holds four rows) plus one add inside the thread;
//   all 128 threads handle the same unit, so its style (fill type, blend
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
//   its one kernel: the texel is one 16-byte float4 load per pixel through
//   the cache, at int64 offsets (the atlas reaches 4096 x 4096 texels,
//   256 MB).
//
// What bounds it on the H100, and what the design does about each:
//
//   1. The tail of deep tiles.  Tile depths are skewed (paris-30k@1080p:
//      median 38 units, max 250) and the deepest sit in the frame's last
//      tile rows, so in index order they start last and the card idles
//      behind them.  The wrapper passes the tiles deepest first (`order`,
//      fold_kernel.tile_order, computed on the device) to the styled,
//      textured and clip folds when they do not all fit the card at once;
//      block b folds tile order[b] and writes it at its own place.  The
//      solid fold's steps are cheap enough that the sort would cost more
//      than the tail it removes, so it takes index order.
//   2. The chain of dependent loads per unit (unit -> src2 and src -> run
//      -> tx_s -> grid, carry and style rows).  The block walks its units
//      in chunks of kChunk: one coalesced pass loads src2, src and tx_s of
//      the chunk, a second, every thread taking a share, copies each unit's
//      carry row (carry_in or carry_after by virtuality: 16 i32) and its
//      whole style row (gradient, stop and texture lanes included) into
//      shared memory;
//      a step reads them as shared broadcasts and its grid words at an
//      address known before the chunk's first step.
//   3. Instructions per unit-pixel: the fold is bound by their issue (each
//      f32 op issues alone under --fmad=false).  Two pixels per thread pay
//      a unit's own work (its flags, carry and style lanes, the fill-type
//      and blend branches, the loop) once for both, and the scan takes 3
//      shuffles for 16 pixels where one pixel per thread took 4.  A virtual
//      unit's cover is 0 across the block, so it branches past the grid
//      load and the scan: its exclusive prefix is 0 and ce_exc its carry.
//   A ring of cp.async copies that kept the next units' grid rows in
//   flight lost on the card (PERF.md section 6): 10-12 blocks of 4 warps
//   per SM hide the grid load's latency, and the ring's own instructions
//   cost more than it hid.  What is left is the issue of each step's
//   instructions (the scan, the coverage and Over chains; a styled unit
//   adds ~90 f32 ops per pixel for the gradient, stop chain and blend, a
//   texture unit 18 and one dependent 16-byte texel load).  Dynamic shared
//   memory per block: the chunk's carries (2 KB), runs, grid rows and
//   flags, and kChunk style rows (4 * kChunk * width bytes), above 48 KB
//   only after cudaFuncSetAttribute; rows past ~1,790 lanes (gradients of
//   ~350 stops) pass a block's 227 KB, and the launch fails with its CUDA
//   error.  Each
//   tile's pixels are written once, two per thread in 8-byte stores.
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
// atlas as JAX's gather does.  Units fold in the same order; the cover
// prefix is an integer sum, exact in any order.

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
// Inlined, so the stop lanes load from shared memory by 32-bit addresses.
__device__ __forceinline__ void gradient(const int32_t* __restrict__ gm,
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

constexpr int kThreads = 128;  // one per two horizontally adjacent pixels
constexpr int kChunk = 32;     // units staged in shared memory at once
constexpr int kVirt = 1;       // staged unit flags
constexpr int kUnclip = 2;

// Dynamic shared memory of a block, in 4-byte words: the chunk's carry
// rows [kChunk, 16], runs, grid rows and flags [kChunk] each, style rows
// [kChunk, width].
constexpr int smem_words(int width) {
  return kChunk * 16 + 3 * kChunk + kChunk * width;
}

struct Px {
  float r, g, b, a;
};

// A pixel's coverage from its exclusive cover prefix and area.
__device__ __forceinline__ float coverage(int32_t ce_exc, int32_t area, bool fr_eo) {
  const float recip = 1.0f / kPDA;
  const int32_t dacc = kPDW * ce_exc + area;
  const float nz =
      fminf(fmaxf(fabsf(__fmul_rn(__int2float_rn(dacc), recip)), 0.0f), 1.0f);
  const int32_t folded = kPDA - abs((dacc & (2 * kPDA - 1)) - kPDA);
  const float eo = __fmul_rn(__int2float_rn(folded), recip);
  return fr_eo ? eo : nz;
}

// The unit's fill at one pixel: solid, gradient or texel.
template <bool kStyled, bool kTex>
__device__ __forceinline__ Px fill_at(const int32_t* st, const Lay& lay,
                                      const Tex& tex, int32_t fill_type,
                                      float xg, float yg) {
  Px f = {F(st[0]), F(st[1]), F(st[2]), F(st[3])};
  if (kStyled && fill_type == 1) {
    gradient(st + lay.grad, st + lay.stops, lay.ms, xg, yg, f.r, f.g, f.b, f.a);
  }
  if (kTex && tex.off >= 0 && fill_type == 2) {
    float tl[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) tl[i] = F(st[tex.off + i]);
    const float4 c = texel(tex, tl, xg, yg);
    f = {c.x, c.y, c.z, c.w};
  }
  return f;
}

// The unit's blend mode, then Over, on one pixel.
template <bool kStyled>
__device__ __forceinline__ void over(Px& d, const Px& f, float src_a,
                                     bool has_blend, int32_t mode) {
  Rgb bl = {f.r, f.g, f.b};
  if (kStyled && has_blend) bl = blend(mode, {d.r, d.g, d.b}, {f.r, f.g, f.b});
  const float inv_dst_a = sub(1.0f, d.a);
  const float inv_dst_a_src_a = mul(inv_dst_a, src_a);
  const float inv_src_a = sub(1.0f, src_a);
  const float dst_a_src_a = mul(d.a, src_a);
  d.r = add(mul(d.r, inv_src_a),
            add(mul(f.r, inv_dst_a_src_a), mul(bl.r, dst_a_src_a)));
  d.g = add(mul(d.g, inv_src_a),
            add(mul(f.g, inv_dst_a_src_a), mul(bl.g, dst_a_src_a)));
  d.b = add(mul(d.b, inv_src_a),
            add(mul(f.b, inv_dst_a_src_a), mul(bl.b, dst_a_src_a)));
  d.a = add(mul(d.a, inv_src_a), src_a);
}

// kStyled: gradients and blend modes; kTex (implies kStyled): texture
// fills; kClip (implies kTex): clip masks.  Register caps: 40 for the
// solid and textured folds (12 blocks of 128 threads per SM), 48 for the
// styled and clip folds (10 blocks), which spill at 40.
template <bool kStyled, bool kClip, bool kTex>
__global__ void __launch_bounds__(kThreads, (kStyled && !kTex) || kClip ? 10 : 12)
fold_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ ust,
            const int32_t* __restrict__ cnt, const int32_t* src,
            const int32_t* src2,
            const int32_t* __restrict__ virt, const int32_t* __restrict__ grid,
            const int32_t* __restrict__ carry_in,
            const int32_t* __restrict__ carry_after,
            const int32_t* __restrict__ tx_s,
            const int32_t* __restrict__ style,
            const float* __restrict__ clear, Lay lay, int64_t tiles_x,
            int64_t run_cap, int64_t n_units, float* __restrict__ out,
            Tex tex, const int32_t* __restrict__ row_lo) {
  extern __shared__ int32_t smem[];
  int32_t* carry_s = smem;
  int32_t* run_s = carry_s + kChunk * 16;
  int32_t* grow_s = run_s + kChunk;
  int32_t* flag_s = grow_s + kChunk;
  int32_t* style_s = flag_s + kChunk;
  // A solid/Over frame's row is rgba | fill rule at compile-time offsets.
  const int sw = kStyled ? lay.width : 5;

  // Tile, unit and run indices fit i32 (the tables are i32-indexed); 64
  // bits only in the address arithmetic, to spare registers.
  const int t = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int q = threadIdx.x;  // pixels 2q, 2q + 1: y = q >> 3, x = 2 (q & 7) + {0, 1}
  const int py = q >> 3;
  const int qx = q & 7;
  const int tile_tx = t % (int)tiles_x;
  // Integer global pixel coordinates (paint_pallas.py:254-262) of the first
  // pixel; the second's is xg + 1, exact below 2^24.  row_lo is the tile
  // row of the frame's first tile row (paint.py:284-288): a row-span crop
  // renders tile rows row_lo .., and its fills evaluate at global rows.  It
  // is read from device memory, as JAX traces it, so that one CUDA graph
  // of the frame serves every row span.
  float xg = 0.0f, yg = 0.0f;
  if (kStyled) {
    xg = __int2float_rn(tile_tx * 16 + 2 * qx);
    yg = __int2float_rn((t / (int)tiles_x + *row_lo) * 16 + py);
  }
  float clipm0 = 0.0f, clipm1 = 0.0f;
  int32_t clip_last = -1;

  Px d0 = {clear[0], clear[1], clear[2], clear[3]};
  Px d1 = d0;
  const int n = cnt[t];
  const int base = ust[t];

  // One index array for both orders (table mode): uniform across the grid.
  const bool table_mode = src == src2;

  // Stages the chunk of units k0 ..: the run, grid row and flags of each
  // unit, then its carry row and style row.  n is uniform across the
  // block, so every thread reaches both barriers.
  auto stage = [&](int k0) {
    if (q < kChunk && k0 + q < n) {
      const int u = min(base + k0 + q, (int)(n_units - 1));
      const int r = max(0, min(__ldg(src2 + u), (int)(run_cap - 1)));
      int32_t f = tx_s[r] != tile_tx ? kVirt : 0;
      // FLAG_UNCLIPPED: the draw's governing full clip was dropped.
      if (kClip && (virt[u] & kUnclipped) != 0) f |= kUnclip;
      run_s[q] = r;
      grow_s[q] = table_mode ? r : max(0, min(__ldg(src + u), (int)(run_cap - 1)));
      flag_s[q] = f;
    }
    __syncthreads();
    const int m = min(kChunk, n - k0);
    for (int i = q; i < m * 16; i += kThreads) {
      const int j = i >> 4;
      const int64_t at = (int64_t)run_s[j] * 16 + (i & 15);
      carry_s[i] = (flag_s[j] & kVirt) ? carry_after[at] : carry_in[at];
    }
    for (int i = q; i < m * sw; i += kThreads) {
      const int j = i / sw;
      style_s[i] = style[(int64_t)run_s[j] * sw + (i - j * sw)];
    }
    __syncthreads();
  };
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    if (k0 > 0) __syncthreads();  // the last chunk's rows are read
    stage(k0);
    const int m = min(kChunk, n - k0);
    for (int j = 0; j < m; ++j) {
      const int32_t f = flag_s[j];
      int32_t ce0 = carry_s[j * 16 + py];
      int32_t ce1 = ce0;
      int32_t area0 = 0, area1 = 0;
      if (!(f & kVirt)) {  // a virtual unit: no grid, cover 0, no scan
        const int2 g = *reinterpret_cast<const int2*>(
            grid + (int64_t)grow_s[j] * 256 + 2 * q);
        const int32_t cover0 = (int32_t)(int16_t)(g.x & 0xFFFF);
        area0 = (int32_t)((uint32_t)g.x - (uint32_t)cover0) >> 16;
        const int32_t cover1 = (int32_t)(int16_t)(g.y & 0xFFFF);
        area1 = (int32_t)((uint32_t)g.y - (uint32_t)cover1) >> 16;
        // Inclusive scan of the pairs' cover over the 8 threads of a row.
        const int32_t pair = cover0 + cover1;
        int32_t inc = pair;
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          const int32_t y = __shfl_up_sync(0xffffffffu, inc, off, 8);
          if (qx >= off) inc += y;
        }
        ce0 += inc - pair;
        ce1 = ce0 + cover0;
      }

      const int32_t* st = style_s + j * sw;
      const bool fr_eo = st[kStyled ? lay.fr : 4] != 0;
      const float cov0 = coverage(ce0, area0, fr_eo);
      const float cov1 = coverage(ce1, area1, fr_eo);

      bool draw = true;
      if (kClip) {
        const int32_t func = st[lay.func];
        draw = func == 0;
        const bool is_clip_unit = func == 1;
        // Clip expiry precedes everything (painter/mod.rs:302-306).
        if (clip_last >= 0 && clip_last < st[lay.layer]) clip_last = -1;
        if (is_clip_unit && clip_last < 0) clip_last = st[lay.cend];
        if (is_clip_unit) {
          clipm0 = cov0;
          clipm1 = cov1;
        }
      }
      const int32_t fill_type = kStyled && lay.ft >= 0 ? st[lay.ft] : 0;
      const bool has_blend = lay.blend >= 0;
      const int32_t mode = kStyled && has_blend ? st[lay.blend] : 0;
      const bool clipped = kClip && st[lay.clipped] == 1 && (f & kUnclip) == 0;

      auto paint = [&](Px& d, float cov, float clipm, float x) {
        const Px fl = fill_at<kStyled, kTex>(st, lay, tex, fill_type, x, yg);
        float src_a = mul(fl.a, cov);
        if (kClip) {
          if (clipped) src_a = clip_last >= 0 ? mul(src_a, clipm) : 0.0f;
          src_a = mul(src_a, draw ? 1.0f : 0.0f);
        }
        over<kStyled>(d, fl, src_a, has_blend, mode);
      };
      paint(d0, cov0, clipm0, xg);
      paint(d1, cov1, clipm1, add(xg, 1.0f));
    }
  }
  float2* o = reinterpret_cast<float2*>(out + (int64_t)t * 1024) + q;
  o[0] = make_float2(d0.r, d1.r);
  o[128] = make_float2(d0.g, d1.g);
  o[256] = make_float2(d0.b, d1.b);
  o[384] = make_float2(d0.a, d1.a);
}

using FoldFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*,
                        const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const float*, Lay, int64_t, int64_t,
                        int64_t, float*, Tex, const int32_t*);

// Solid/Over, styled, textured, clip (fold_kernel.variant).
const FoldFn kFold[4] = {
    fold_kernel<false, false, false>,
    fold_kernel<true, false, false>,
    fold_kernel<true, false, true>,
    fold_kernel<true, true, true>,
};

}  // namespace

// order: the tiles in the order the blocks fold them (a permutation of 0 ..
// n_tiles - 1), or null for index order.  src: each unit's grid row (run
// order); src2: its run in carry-chain order; pass the same pointer twice
// when the orders are one.  layout (host memory): fr, blend,
// ft, func, layer, cend, clipped, grad, stops, width, ms, tex; an offset of
// -1 leaves its feature out.  virt may be null for a frame without clips,
// atlas for a frame without textures.  row_lo (device memory, one int32):
// the global tile row of the
// frame's tile row 0 (gradients and textures evaluate at global pixels).
extern "C" int forma_fold(const void* order, const void* ust, const void* cnt,
                          const void* src, const void* src2, const void* virt,
                          const void* grid,
                          const void* carry_in, const void* carry_after,
                          const void* tx_s, const void* style,
                          const void* clear, const void* layout,
                          int64_t n_tiles, int64_t tiles_x, int64_t run_cap,
                          int64_t n_units, void* out, const void* atlas,
                          int64_t atlas_h, int64_t atlas_w, const void* row_lo,
                          cudaStream_t stream) {
  const int32_t* l = static_cast<const int32_t*>(layout);
  const Lay lay = {l[0], l[1], l[2], l[3], l[4], l[5],
                   l[6], l[7], l[8], l[9], l[10]};
  const Tex tex = {static_cast<const float4*>(atlas), atlas_h, atlas_w, l[11]};
  const int idx =
      lay.func >= 0
          ? 3
          : (tex.off >= 0 ? 2 : (lay.grad >= 0 || lay.blend >= 0 ? 1 : 0));
  const int smem = 4 * smem_words(idx == 0 ? 5 : lay.width);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kFold[idx], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kFold[idx]<<<(unsigned)n_tiles, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(ust),
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(src2),
      static_cast<const int32_t*>(virt), static_cast<const int32_t*>(grid),
      static_cast<const int32_t*>(carry_in),
      static_cast<const int32_t*>(carry_after),
      static_cast<const int32_t*>(tx_s), static_cast<const int32_t*>(style),
      static_cast<const float*>(clear), lay, tiles_x, run_cap, n_units,
      static_cast<float*>(out), tex, static_cast<const int32_t*>(row_lo));
  return (int)cudaGetLastError();
}
