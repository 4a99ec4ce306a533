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
// Here the step is K3's solid fold step (csrc/fold.cu), so that the pieces
// price what K3 spends: one block per tile, 128 threads, two horizontally
// adjacent pixels each (q: y = q >> 3, x = 2 (q & 7) + {0, 1}), RGBA in
// registers over the tile's rows; the exclusive cover prefix is an integer
// scan of the pairs' sums by __shfl_up_sync over 8-lane groups (3
// shuffles) plus one add inside the thread; the units go in chunks of 32
// whose per-unit lanes (carries 256..271, fill 272..275, rule 276) are
// staged in shared memory before the chunk's steps and read as broadcasts.
// Designs of the row loads (`design`):
//
//   0 direct: the block stages each chunk's per-unit lanes (a warp a row,
//     84 bytes) and every step reads its grid words, one 8-byte load a
//     thread (1 KB a row, coalesced), from device memory at an address
//     known before the chunk, as K3 reads its grid rows; 12 blocks of 4
//     warps per SM (at most 40 registers);
//   1 TMA: a tile's rows are one contiguous range of u_mat, so one warp
//     copies the next chunk of 16 rows (280 lanes, 1,120 bytes each, one
//     cp.async.bulk a lane, completed on an mbarrier) into the second of
//     two shared buffers while the block folds the current chunk, and a
//     step reads its grid words from shared memory too; 35 KB of buffers
//     a block, so 6 blocks an SM.
//
// On the card (PERF.md section 6) the TMA design wins, the default: the
// copies cost the block no instructions, and 6 blocks an SM keep the step's
// instructions flowing.  The direct design loses by a third (its per-step
// grid loads); it stays as the price of K3's step.  Lost there too: TMA
// chunks of 32 rows (3 blocks an SM, too few warps) and of 8 (a barrier
// twice as often), and the tiles folded deepest first, whose sort costs
// more than the tail it shortens.  What bounds the default is the rate of
// the step's instructions (loads_only, a loop that keeps only the step's
// coverage, takes most of the time) and the tail of the deepest tiles,
// which start last in index order.
//
// The TPU loops every tile of a block to the block's KMAX and masks the
// steps past a tile's count; such a step leaves dst bit for bit as it was
// (dst * 1 + 0 for finite fills), so each tile here loops to its own
// count.  A row index clamps to U - 1, as the TPU's clamps into its window.
//
// Variants (template flags, the tool's six at :193-198):
//   kLoads  false: the tile's first row is loaded from device memory once,
//           into shared memory, and every step reads it from there through
//           a volatile pointer, as the TPU reads its `asm` scratch each
//           step (the tool never fills `asm` when loads are off, so its
//           result is undefined; this is the port's definition).  The
//           volatile reads keep the step's arithmetic in the loop: only
//           the device-memory loads and the chunk staging go; the same
//           kernel in every design.
//   kDots   false: ce = 0 (the carries are not staged or read).
//   kRolls  false: exc = cover (the scan goes).
//   kBlend  false: dst channel 0 += cov instead of Over (the fill lanes
//           are not staged or read; the blend goes).
//
// Bit-equality with the plain version (probes.fold_ablate.
// fold_ablate_torch): the shifts are int32 (two's complement, arithmetic
// right shifts), every f32 op an explicitly rounded intrinsic in the
// tool's expression order (--fmad=false), 1/512 a constant; the prefix is
// an integer sum, exact in any order.
//
// Bound on the H100: the rows a fold addresses, 277 of their 384 lanes
// (465,747 units x 1,108 bytes on the tool's paris-like inputs), plus the
// 33 MB output; 29 f32 ops per unit-pixel.  The variants say what each
// piece of K3's step costs, the designs what staging the rows by TMA
// changes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTB = 32;      // tiles per blkinfo row (paint_pallas.TB)
constexpr int kUW = 384;     // u_mat lanes (paint_pallas.UW)
constexpr int kLanes = 277;  // lanes a step reads: grid, carries, fill, rule
constexpr int kRowW = 280;   // lanes a bulk copy moves (1,120 bytes, 16 | it)
constexpr int kUL = 21;      // per-unit lanes staged: 256..276
constexpr int kPDA = 512;    // PIXEL_DOUBLE_AREA
constexpr int kPDW = 32;     // PIXEL_DOUBLE_WIDTH
constexpr int kBase0 = 8;    // blkinfo: per-tile first row, relative to START
constexpr int kCnt0 = 8 + kTB;  // blkinfo: per-tile row count
constexpr int kThreads = 128;   // one per two horizontally adjacent pixels
constexpr int kChunk = 32;      // units staged at once (direct design)
constexpr int kTC = 16;         // rows a TMA chunk copies (TMA design)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Px {
  float r, g, b, a;
};

__device__ __forceinline__ float coverage(int32_t ce_exc, int32_t area, bool fr_eo) {
  const float recip = 1.0f / kPDA;
  const int32_t da = kPDW * ce_exc + area;
  const float nz = fminf(fmaxf(fabsf(mul(__int2float_rn(da), recip)), 0.0f), 1.0f);
  const int32_t folded = kPDA - abs((da & (2 * kPDA - 1)) - kPDA);
  const float eo = mul(__int2float_rn(folded), recip);
  return fr_eo ? eo : nz;
}

__device__ __forceinline__ void over(Px& d, const float* f, float cov) {
  const float src_a = mul(f[3], cov);
  const float inv_dst_a = sub(1.0f, d.a);
  const float inv_dst_a_src_a = mul(inv_dst_a, src_a);
  const float inv_src_a = sub(1.0f, src_a);
  const float dst_a_src_a = mul(d.a, src_a);
  d.r = add(mul(d.r, inv_src_a), add(mul(f[0], inv_dst_a_src_a), mul(f[0], dst_a_src_a)));
  d.g = add(mul(d.g, inv_src_a), add(mul(f[1], inv_dst_a_src_a), mul(f[1], dst_a_src_a)));
  d.b = add(mul(d.b, inv_src_a), add(mul(f[2], inv_dst_a_src_a), mul(f[2], dst_a_src_a)));
  d.a = add(mul(d.a, inv_src_a), src_a);
}

// One unit on the thread's two pixels: g0, g1 their grid words, `lanes`
// the unit's lanes 256.. (shared memory, plain or volatile).
template <bool kDots, bool kRolls, bool kBlend, typename L>
__device__ __forceinline__ void step(int32_t g0, int32_t g1, L lanes, int qx, int py,
                                     Px& p0, Px& p1) {
  const int32_t cover0 = (int32_t)(int16_t)(g0 & 0xFFFF);
  const int32_t area0 = (int32_t)((uint32_t)g0 - (uint32_t)cover0) >> 16;
  const int32_t cover1 = (int32_t)(int16_t)(g1 & 0xFFFF);
  const int32_t area1 = (int32_t)((uint32_t)g1 - (uint32_t)cover1) >> 16;
  const int32_t ce = kDots ? lanes[py] : 0;
  int32_t e0, e1;
  if (kRolls) {  // inclusive scan of the pairs' cover over the 8 threads of a row
    const int32_t pair = cover0 + cover1;
    int32_t inc = pair;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, inc, off, 8);
      if (qx >= off) inc += y;
    }
    e0 = ce + (inc - pair);
    e1 = e0 + cover0;
  } else {
    e0 = ce + cover0;
    e1 = ce + cover1;
  }
  const bool fr_eo = lanes[20] != 0;
  const float c0 = coverage(e0, area0, fr_eo);
  const float c1 = coverage(e1, area1, fr_eo);
  if (kBlend) {
    float f[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = __int_as_float(lanes[16 + c]);
    over(p0, f, c0);
    over(p1, f, c1);
  } else {
    p0.r = add(p0.r, c0);
    p1.r = add(p1.r, c1);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Waits for phase `parity` of the mbarrier at `bar`; traps (a launch
// error, not a hang) if it never completes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}

// kTma false: direct; true: TMA-staged rows (kTC rows a chunk).  Block
// slots an SM: 12, or the 6 that two buffers of kTC rows leave.
template <bool kTma, bool kLoads, bool kDots, bool kRolls, bool kBlend>
__global__ void __launch_bounds__(kThreads, kTma ? 6 : 12)
fold_ablate_kernel(const int32_t* __restrict__ u_mat,
                   const int32_t* __restrict__ blkinfo,
                   const float* __restrict__ clear, int64_t n_rows, int bi_w,
                   float* __restrict__ out) {
  __shared__ int32_t held[kLoads ? 1 : kLanes];
  __shared__ int32_t lanes_s[!kTma && kLoads ? kChunk * kUL : 1];
  extern __shared__ __align__(16) int32_t dyn[];
  const int t = (int)blockIdx.x;
  const int q = threadIdx.x;
  const int py = q >> 3;
  const int qx = q & 7;
  const int32_t* bi = blkinfo + (int64_t)(t / kTB) * bi_w;
  const int64_t first = (int64_t)bi[0] + bi[kBase0 + t % kTB];
  const int n = bi[kCnt0 + t % kTB];
  auto row_of = [&](int k) {
    const int64_t r = first + k;
    return u_mat + (r < n_rows - 1 ? r : n_rows - 1) * kUW;
  };

  Px p0 = {clear[0], clear[1], clear[2], clear[3]};
  Px p1 = p0;
  if constexpr (!kLoads) {
    if (n > 0)
      for (int l = q; l < kLanes; l += kThreads) held[l] = row_of(0)[l];
    __syncthreads();
    const volatile int32_t* hv = held;
    for (int k = 0; k < n; ++k)
      step<kDots, kRolls, kBlend>(hv[2 * q], hv[2 * q + 1], hv + 256, qx, py, p0, p1);
  } else if constexpr (!kTma) {
    // A warp stages a row's lanes 256..276 that the variant reads.
    const int lane = q & 31;
    const bool staged = lane < kUL && (kDots || lane >= 16) &&
                        (kBlend || lane < 16 || lane == 20);
    for (int k0 = 0; k0 < n; k0 += kChunk) {
      const int m = min(kChunk, n - k0);
      if (k0 > 0) __syncthreads();  // the last chunk's lanes are read
      if (staged)
        for (int j = q >> 5; j < m; j += kThreads / 32)
          lanes_s[j * kUL + lane] = row_of(k0 + j)[256 + lane];
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const int2 g = *reinterpret_cast<const int2*>(row_of(k0 + j) + 2 * q);
        step<kDots, kRolls, kBlend>(g.x, g.y, lanes_s + j * kUL, qx, py, p0, p1);
      }
    }
  } else {
    // Two buffers of kTC rows and their mbarriers (one arrival: the
    // expect_tx of warp 0's lane 0, plus the chunk's bytes).
    const uint32_t buf0 = smem_addr(dyn);
    const uint32_t bar0 = smem_addr(dyn + 2 * kTC * kRowW);
    if (q == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar0) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar0 + 8) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const int nc = (n + kTC - 1) / kTC;
    // Warp 0: chunk c's rows into buffer c & 1, one bulk copy a lane.
    auto copy_chunk = [&](int c) {
      const int k0 = c * kTC;
      const int m = min(kTC, n - k0);
      const uint32_t bar = bar0 + 8 * (c & 1);
      if (q == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(m * kRowW * 4) : "memory");
      __syncwarp();
      if (q < m)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            :: "r"(buf0 + (uint32_t)(((c & 1) * kTC + q) * kRowW * 4)),
               "l"(row_of(k0 + q)), "r"(kRowW * 4), "r"(bar)
            : "memory");
    };
    if (q < 32 && nc > 0) copy_chunk(0);
    for (int c = 0; c < nc; ++c) {
      // Buffer (c + 1) & 1 was last read in chunk c - 1, before the barrier.
      if (q < 32 && c + 1 < nc) copy_chunk(c + 1);
      mbar_wait(bar0 + 8 * (c & 1), (c >> 1) & 1);
      const int32_t* cb = dyn + (c & 1) * kTC * kRowW;
      const int m = min(kTC, n - c * kTC);
      for (int j = 0; j < m; ++j) {
        const int2 g = *reinterpret_cast<const int2*>(cb + j * kRowW + 2 * q);
        step<kDots, kRolls, kBlend>(g.x, g.y, cb + j * kRowW + 256, qx, py, p0, p1);
      }
      __syncthreads();
    }
  }
  float2* o = reinterpret_cast<float2*>(out + (int64_t)t * 1024) + q;
  o[0] = make_float2(p0.r, p1.r);
  o[128] = make_float2(p0.g, p1.g);
  o[256] = make_float2(p0.b, p1.b);
  o[384] = make_float2(p0.a, p1.a);
}

using AblateFn = void (*)(const int32_t*, const int32_t*, const float*, int64_t, int,
                          float*);

// The tool's six variants (fold_kernel_ablate.py:193-198), in the order of
// probes.fold_ablate.VARIANTS: full, no loads, no dots, no rolls, no
// blend, loads only; "no loads" is one kernel in both designs.
template <bool kTma>
AblateFn ablate_fn(int variant) {
  switch (variant) {
    case 0: return fold_ablate_kernel<kTma, true, true, true, true>;
    case 1: return fold_ablate_kernel<false, false, true, true, true>;
    case 2: return fold_ablate_kernel<kTma, true, false, true, true>;
    case 3: return fold_ablate_kernel<kTma, true, true, false, true>;
    case 4: return fold_ablate_kernel<kTma, true, true, true, false>;
    default: return fold_ablate_kernel<kTma, true, false, false, false>;
  }
}

// Dynamic shared memory (bytes) of the TMA kernels: two buffers of rows and
// two mbarriers.
constexpr int kTmaSmem = 2 * kTC * kRowW * 4 + 16;

cudaError_t set_attributes() {
  for (int v = 0; v < 6; ++v) {
    if (v == 1) continue;
    const cudaError_t e = cudaFuncSetAttribute(
        ablate_fn<true>(v), cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// u_mat i32 [n_rows, 384], 16-byte aligned; blkinfo i32 [n_tiles / 32,
// bi_w]; clear f32 [4]; out f32 [n_tiles, 1024]; variant 0-5 as
// ablate_fn; design 0 direct, 1 TMA.
extern "C" int forma_fold_ablate(const void* u_mat, const void* blkinfo,
                                 const void* clear, int64_t n_tiles, int64_t n_rows,
                                 int64_t bi_w, int64_t variant, int64_t design, void* out,
                                 cudaStream_t stream) {
  if (variant < 0 || variant > 5 || design < 0 || design > 1)
    return (int)cudaErrorInvalidValue;
  // Once per process (a call inside a CUDA graph capture then only
  // launches).
  static const cudaError_t attr = set_attributes();
  if (attr != cudaSuccess) return (int)attr;
  const bool tma = design == 1 && variant != 1;
  const AblateFn fn = design == 1 ? ablate_fn<true>((int)variant) : ablate_fn<false>((int)variant);
  fn<<<(unsigned)n_tiles, kThreads, tma ? kTmaSmem : 0, stream>>>(
      static_cast<const int32_t*>(u_mat), static_cast<const int32_t*>(blkinfo),
      static_cast<const float*>(clear), n_rows, (int)bi_w, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
