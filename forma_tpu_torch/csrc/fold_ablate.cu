// K8: the fold ablation.
//
// Replaces tools/fold_kernel_ablate.py:run (make_kernel), a copy of the
// TPU's solid/Over paint fold (paint_pallas.py) with four pieces that
// switch off one by one, to price each: the per-step dynamic row loads
// from the VMEM unit window, the carry expansion (three byte-split bf16
// one-hot matmuls), the exclusive cover prefix (four lane rolls) and the
// Over blend.  Its inputs are a unit matrix u_mat i32 [U, 384] (grid row
// 0..255, carries 256..271, fill bits 272..275, fill rule 276) and per
// 32-tile block a blkinfo row in paint_pallas's layout (START, NCHUNK,
// KMAX, then per tile BASE0, CNT, X0, Y0).  Tile t = 32 b + i folds rows
// START[b] + BASE0[b, i] + k for k < CNT[b, i], from the clear colour:
//
//   g = row[p]; cover = (g << 16) >> 16; area = (g - cover) >> 16;
//   exc = exclusive prefix of cover along p's 16-pixel row;
//   ce = row[256 + p / 16];  da = 32 (ce + exc) + area;
//   cov = row[276] ? (512 - |(da & 1023) - 512|) / 512
//                  : clip(|da / 512|, 0, 1);
//   Over with fill = f32 bits of row[272..275].
//
// Here, as K3 (csrc/fold.cu) is: one block per tile, 256 threads, one
// pixel each, RGBA in registers over the tile's rows; a step's grid row
// is one coalesced 1 KB load, the 16 carries and the fill broadcast
// loads; the prefix a 16-lane __shfl_up_sync scan.  The TPU loops every
// tile of a block to the block's KMAX and masks the steps past a tile's
// count; such a step leaves dst bit for bit as it was (dst * 1 + 0 for
// finite fills), so each tile here loops to its own count.  A row index
// clamps to U - 1, as the TPU's clamps into its window.
//
// Variants (template flags, the tool's six at :193-198):
//   kLoads  false: the tile's first row is loaded from device memory once,
//           into shared memory, and every step reads it from there through
//           a volatile pointer, as the TPU reads its `asm` scratch each
//           step (the tool never fills `asm` when loads are off, so its
//           result is undefined; this is the port's definition).  The
//           volatile reads keep the step's arithmetic in the loop: only
//           the device-memory row loads go.
//   kDots   false: ce = 0 (the carry broadcast and its load go).
//   kRolls  false: exc = cover (the scan goes).
//   kBlend  false: dst channel 0 += cov instead of Over (the fill loads
//           and the blend go).
//
// Bit-equality with the plain version (probes.fold_ablate.
// fold_ablate_torch): the shifts are int32 (two's complement, arithmetic
// right shifts), every f32 op an explicitly rounded intrinsic in the
// tool's expression order (--fmad=false), 1/512 a constant.
//
// Bound on the H100: the rows a fold addresses, 277 of their 384 lanes
// (~324k units x 1,108 bytes on the tool's paris-like inputs), plus the
// 33 MB output; 29 f32 ops per unit-pixel.  What it really waits on is
// what K3 waits on, the latency of each step's row load times the tile
// depth; the variants say how much of the step each piece costs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTB = 32;    // tiles per blkinfo row (paint_pallas.TB)
constexpr int kUW = 384;   // u_mat lanes (paint_pallas.UW)
constexpr int kLanes = 277;  // lanes a step reads: grid, carries, fill, rule
constexpr int kPDA = 512;  // PIXEL_DOUBLE_AREA
constexpr int kPDW = 32;   // PIXEL_DOUBLE_WIDTH
constexpr int kBase0 = 8;  // blkinfo: per-tile first row, relative to START
constexpr int kCnt0 = 8 + kTB;  // blkinfo: per-tile row count

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <bool kLoads, bool kDots, bool kRolls, bool kBlend>
__global__ void __launch_bounds__(256)
fold_ablate_kernel(const int32_t* __restrict__ u_mat,
                   const int32_t* __restrict__ blkinfo,
                   const float* __restrict__ clear, int64_t n_rows, int bi_w,
                   float* __restrict__ out) {
  __shared__ int32_t held[kLanes];
  const int64_t t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = p & 15;
  const int py = p >> 4;
  const int32_t* bi = blkinfo + (t / kTB) * bi_w;
  const int i = (int)(t % kTB);
  const int64_t first = (int64_t)bi[0] + bi[kBase0 + i];
  const int n = bi[kCnt0 + i];
  const float recip = 1.0f / kPDA;

  if (!kLoads) {
    if (n > 0) {
      const int64_t r = first < n_rows - 1 ? first : n_rows - 1;
      for (int l = p; l < kLanes; l += 256) held[l] = u_mat[r * kUW + l];
    }
    __syncthreads();
  }
  const volatile int32_t* hv = held;

  float d0 = clear[0], d1 = clear[1], d2 = clear[2], d3 = clear[3];
  for (int k = 0; k < n; ++k) {
    int64_t r = first + k;
    if (r > n_rows - 1) r = n_rows - 1;
    const int32_t* row = u_mat + r * kUW;
    const int32_t g = kLoads ? row[p] : hv[p];
    const int32_t cover = (int32_t)((uint32_t)g << 16) >> 16;
    const int32_t area = (g - cover) >> 16;

    int32_t exc = cover;
    if (kRolls) {
      int32_t inc = cover;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, inc, off, 16);
        if (px >= off) inc += y;
      }
      exc = inc - cover;
    }
    const int32_t ce = kDots ? (kLoads ? row[256 + py] : hv[256 + py]) : 0;
    const int32_t da = kPDW * (ce + exc) + area;
    const bool fr_eo = (kLoads ? row[276] : hv[276]) != 0;
    const float nz = fminf(fmaxf(fabsf(mul(__int2float_rn(da), recip)), 0.0f), 1.0f);
    const int32_t folded = kPDA - abs((da & (2 * kPDA - 1)) - kPDA);
    const float eo = mul(__int2float_rn(folded), recip);
    const float cov = fr_eo ? eo : nz;

    if (kBlend) {
      float f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f[c] = __int_as_float(kLoads ? row[272 + c] : hv[272 + c]);
      const float src_a = mul(f[3], cov);
      const float inv_dst_a = sub(1.0f, d3);
      const float inv_dst_a_src_a = mul(inv_dst_a, src_a);
      const float inv_src_a = sub(1.0f, src_a);
      const float dst_a_src_a = mul(d3, src_a);
      d0 = add(mul(d0, inv_src_a), add(mul(f[0], inv_dst_a_src_a), mul(f[0], dst_a_src_a)));
      d1 = add(mul(d1, inv_src_a), add(mul(f[1], inv_dst_a_src_a), mul(f[1], dst_a_src_a)));
      d2 = add(mul(d2, inv_src_a), add(mul(f[2], inv_dst_a_src_a), mul(f[2], dst_a_src_a)));
      d3 = add(mul(d3, inv_src_a), src_a);
    } else {
      d0 = add(d0, cov);
    }
  }
  float* o = out + t * 1024;
  o[p] = d0;
  o[256 + p] = d1;
  o[512 + p] = d2;
  o[768 + p] = d3;
}

using AblateFn = void (*)(const int32_t*, const int32_t*, const float*,
                          int64_t, int, float*);
// The tool's six variants (fold_kernel_ablate.py:193-198), in the order of
// probes.fold_ablate.VARIANTS: full, no loads, no dots, no rolls, no
// blend, loads only.
const AblateFn kAblate[6] = {
    fold_ablate_kernel<true, true, true, true>,
    fold_ablate_kernel<false, true, true, true>,
    fold_ablate_kernel<true, false, true, true>,
    fold_ablate_kernel<true, true, false, true>,
    fold_ablate_kernel<true, true, true, false>,
    fold_ablate_kernel<true, false, false, false>,
};

}  // namespace

// u_mat i32 [n_rows, 384]; blkinfo i32 [n_tiles / 32, bi_w]; clear f32
// [4]; out f32 [n_tiles, 1024]; variant 0-5 as kAblate.
extern "C" int forma_fold_ablate(const void* u_mat, const void* blkinfo,
                                 const void* clear, int64_t n_tiles,
                                 int64_t n_rows, int64_t bi_w, int64_t variant,
                                 void* out, cudaStream_t stream) {
  if (variant < 0 || variant > 5) return (int)cudaErrorInvalidValue;
  kAblate[variant]<<<(unsigned)n_tiles, 256, 0, stream>>>(
      static_cast<const int32_t*>(u_mat), static_cast<const int32_t*>(blkinfo),
      static_cast<const float*>(clear), n_rows, (int)bi_w,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
