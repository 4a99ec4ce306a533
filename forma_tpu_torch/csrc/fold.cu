// K3: the per-tile paint fold, table mode, solid fills, Over blending.
//
// Replaces forma_tpu/ops/paint_pallas.py:paint_fold_pallas (_make_kernel
// with table_mode=True and Features()), which the TPU runs over 32-tile
// blocks whose unit rows are DMA'd into VMEM from a gathered [U, 384] unit
// matrix, with the carry expansion and exclusive cover prefix done as
// byte-split bf16 one-hot matmuls.  Here:
//
//   one block per tile, 256 threads, one pixel each; the pixel's RGBA stays
//   in registers over the tile's whole unit list (no depth cap and no
//   shared memory that grows with it);
//   unit k of tile t is ust[t] + k; its run r = src2[unit] addresses the
//   per-run tables directly (grid row, carry_in, carry_after, run tile x,
//   style row), so no unit matrix is ever gathered;
//   a unit is virtual when tx_s[r] differs from the tile's own x: it takes
//   no grid and carry_after[r]; a real unit takes carry_in[r];
//   the exclusive cover prefix along each 16-pixel row is an integer warp
//   scan (__shfl_up_sync over 16-lane halves: one warp holds two rows);
//   coverage, fill and Over follow paint_pallas.py:327-336,404-415 op for
//   op with explicitly rounded f32 intrinsics (and --fmad=false), so the
//   result is bit-equal to the plain PyTorch version.
//
// Bound on the H100: latency of the dependent per-unit loads (unit -> run ->
// grid row) times the tile depth; the grid row read is one coalesced 1 KB
// load per unit, the rest are broadcasts.  Each tile's pixels are written
// once.  Overlapping the next unit's loads with this unit's math is the
// obvious next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStyleW = 5;  // rgba bits | fill rule
constexpr int kPDA = 512;   // PIXEL_DOUBLE_AREA
constexpr int kPDW = 32;    // PIXEL_DOUBLE_WIDTH

__global__ void __launch_bounds__(256)
fold_kernel(const int32_t* __restrict__ ust, const int32_t* __restrict__ cnt,
            const int32_t* __restrict__ src2, const int32_t* __restrict__ grid,
            const int32_t* __restrict__ carry_in,
            const int32_t* __restrict__ carry_after,
            const int32_t* __restrict__ tx_s,
            const int32_t* __restrict__ style,
            const float* __restrict__ clear, int64_t tiles_x, int64_t run_cap,
            int64_t n_units, float* __restrict__ out) {
  const int64_t t = blockIdx.x;
  const int p = threadIdx.x;  // pixel: y = p >> 4, x = p & 15
  const int py = p >> 4;
  const int px = p & 15;
  const int tile_tx = (int)(t % tiles_x);
  const float recip = 1.0f / kPDA;

  float dr = clear[0], dg = clear[1], db = clear[2], da = clear[3];
  const int n = cnt[t];
  const int64_t base = ust[t];
  for (int k = 0; k < n; ++k) {
    int64_t u = base + k;
    if (u > n_units - 1) u = n_units - 1;
    int64_t r = src2[u];
    r = r < 0 ? 0 : (r > run_cap - 1 ? run_cap - 1 : r);
    const bool virt = tx_s[r] != tile_tx;

    int32_t cover = 0, area = 0;
    if (!virt) {
      const int32_t g = grid[r * 256 + p];
      cover = (int32_t)(int16_t)(g & 0xFFFF);
      area = (int32_t)((uint32_t)g - (uint32_t)cover) >> 16;
    }
    const int32_t c16 = virt ? carry_after[r * 16 + py] : carry_in[r * 16 + py];

    // Inclusive scan of cover over the 16 pixels of this row.
    int32_t inc = cover;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, inc, off, 16);
      if (px >= off) inc += y;
    }
    const int32_t ce_exc = c16 + (inc - cover);

    const int32_t dacc = kPDW * ce_exc + area;
    const int32_t* st = style + r * kStyleW;
    const bool fr_eo = st[4] != 0;
    const float nz =
        fminf(fmaxf(fabsf(__fmul_rn(__int2float_rn(dacc), recip)), 0.0f), 1.0f);
    const int32_t folded = kPDA - abs((dacc & (2 * kPDA - 1)) - kPDA);
    const float eo = __fmul_rn(__int2float_rn(folded), recip);
    const float cov = fr_eo ? eo : nz;

    const float fr = __int_as_float(st[0]);
    const float fg = __int_as_float(st[1]);
    const float fb = __int_as_float(st[2]);
    const float fa = __int_as_float(st[3]);
    const float src_a = __fmul_rn(fa, cov);
    const float inv_dst_a = __fsub_rn(1.0f, da);
    const float inv_dst_a_src_a = __fmul_rn(inv_dst_a, src_a);
    const float inv_src_a = __fsub_rn(1.0f, src_a);
    const float dst_a_src_a = __fmul_rn(da, src_a);
    dr = __fadd_rn(__fmul_rn(dr, inv_src_a),
                   __fadd_rn(__fmul_rn(fr, inv_dst_a_src_a),
                             __fmul_rn(fr, dst_a_src_a)));
    dg = __fadd_rn(__fmul_rn(dg, inv_src_a),
                   __fadd_rn(__fmul_rn(fg, inv_dst_a_src_a),
                             __fmul_rn(fg, dst_a_src_a)));
    db = __fadd_rn(__fmul_rn(db, inv_src_a),
                   __fadd_rn(__fmul_rn(fb, inv_dst_a_src_a),
                             __fmul_rn(fb, dst_a_src_a)));
    da = __fadd_rn(__fmul_rn(da, inv_src_a), src_a);
  }
  float* o = out + t * 1024;
  o[p] = dr;
  o[256 + p] = dg;
  o[512 + p] = db;
  o[768 + p] = da;
}

}  // namespace

extern "C" int forma_fold(const void* ust, const void* cnt, const void* src2,
                          const void* grid, const void* carry_in,
                          const void* carry_after, const void* tx_s,
                          const void* style, const void* clear,
                          int64_t n_tiles, int64_t tiles_x, int64_t run_cap,
                          int64_t n_units, void* out, cudaStream_t stream) {
  fold_kernel<<<(unsigned)n_tiles, 256, 0, stream>>>(
      static_cast<const int32_t*>(ust), static_cast<const int32_t*>(cnt),
      static_cast<const int32_t*>(src2), static_cast<const int32_t*>(grid),
      static_cast<const int32_t*>(carry_in),
      static_cast<const int32_t*>(carry_after),
      static_cast<const int32_t*>(tx_s), static_cast<const int32_t*>(style),
      static_cast<const float*>(clear), tiles_x, run_cap, n_units,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
