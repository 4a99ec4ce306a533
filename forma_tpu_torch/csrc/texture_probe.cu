// K5: the texture-fold probe.
//
// Replaces tools/texture_fold_probe.py:run (make_kernel), a Pallas kernel
// that asked whether texture fills can be sampled inside the TPU's paint
// fold: per 32-tile block it loops k over the fold depth and adds, per
// pixel, a texel to a VMEM-resident [TB, 1024] framebuffer, with the
// texel picked either by a whole-atlas row select (a [256, AH] one-hot
// bf16 matmul, then a column mask) or from a per-tile [SH, AW*4] slab,
// against a baseline that only computes the affine coordinates.  Here the
// function, not the one-hot matmuls:
//
//   one block per tile, 256 threads, one pixel each; the tile's 8 info
//   words are broadcast loads; the loop over k runs in registers, and the
//   four channel sums stay there until the one write of the tile's pixels;
//   a texel is one 8-byte load of 4 bf16 values (the wrapper converts the
//   atlas to bf16 once, as the Pallas body's `.astype(bf16)` does; the
//   one-hot product then returns that bf16 value exactly), read through
//   the cache: the probe's atlas is 64 KB in bf16.
//
// Bit-equality with the plain version (probes.texture_fold.
// texture_fold_torch): every f32 op an explicitly rounded intrinsic in the
// Pallas expression order (--fmad=false); trunc and the clamps exact; bf16
// widened by a 16-bit shift.
//
// Bound on the H100: per tile-step and pixel ~15-19 f32 ops and, when it
// samples, one cached 8-byte load; the probe's paris shape (8,160 tiles,
// 44 steps) is 92M pixel-steps, ~1.7 GFLOP (~0.026 ms at 67 TFLOP/s),
// against 33 MB of output.  The dependent load latency per step is what
// the sampling modes add over the base mode.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSH = 32;  // slab rows (texture_fold_probe.py:SH)
constexpr int kSW = 32;  // slab columns (SW)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float bf16(uint32_t bits) { return __uint_as_float(bits << 16); }
// jnp.clip(x, lo, hi) for a finite x: maximum, then minimum.
__device__ __forceinline__ int clipi(float x, float lo, float hi) {
  return __float2int_rz(fminf(fmaxf(x, lo), hi));
}
__device__ __forceinline__ int clamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// kMode: 0 base (coordinates only), 1 atlas_rowsel, 2 slab.
template <int kMode>
__global__ void __launch_bounds__(256)
texture_probe_kernel(const int32_t* __restrict__ info,
                     const uint16_t* __restrict__ atlas, int ah, int aw,
                     int kmax, float* __restrict__ out) {
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int32_t* in = info + t * 8;
  // prm = f32(info) * 0.001 (texture_fold_probe.py:68-71).
  const float ux = mul(__int2float_rn(in[0]), 0.001f);
  const float uy = mul(__int2float_rn(in[1]), 0.001f);
  const float vx = mul(__int2float_rn(in[2]), 0.001f);
  const float vy = mul(__int2float_rn(in[3]), 0.001f);
  const float tx = mul(__int2float_rn(in[4]), 0.001f);
  const float ty = mul(__int2float_rn(in[5]), 0.001f);
  const int oy0 = in[6];
  const int ox0 = in[7];
  // The slab is a dynamic slice of SH rows: its start clamps into the
  // atlas as the slice does; its offset within uses the unclamped oy0.
  const int slab0 = clamp(oy0, 0, ah - kSH);
  const float xg = __int2float_rn(j & 15);
  const float yg = __int2float_rn(j >> 4);
  const int64_t row_words = 4 * (int64_t)aw;

  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int k = 0; k < kmax; ++k) {
    const float sx = add(mul(xg, ux), add(mul(yg, vx), add(tx, __int2float_rn(k))));
    const float sy = add(mul(xg, uy), add(mul(yg, vy), ty));
    float c0, c1, c2, c3;
    if (kMode == 0) {
      c0 = sx;
      c1 = sy;
      c2 = mul(sx, sy);
      c3 = sub(sx, sy);
    } else {
      int ix = clipi(truncf(sx), 0.0f, (float)(aw - 1));
      int iy = clipi(truncf(sy), 0.0f, (float)(ah - 1));
      if (kMode == 2) {
        // The Pallas slab spans all AW columns from column 0
        // (texture_fold_probe.py:123,134): the column is clipped relative
        // to ox0 but not offset by it.  This is what the TPU kernel
        // computes, copied as it is.
        iy = slab0 + clamp(iy - oy0, 0, kSH - 1);
        ix = clamp(ix - ox0, 0, kSW - 1);
      }
      const uint2 v =
          __ldg(reinterpret_cast<const uint2*>(atlas + iy * row_words + 4 * ix));
      c0 = bf16(v.x & 0xFFFFu);
      c1 = bf16(v.x >> 16);
      c2 = bf16(v.y & 0xFFFFu);
      c3 = bf16(v.y >> 16);
    }
    a0 = add(a0, c0);
    a1 = add(a1, c1);
    a2 = add(a2, c2);
    a3 = add(a3, c3);
  }
  float* o = out + t * 1024;
  o[j] = a0;
  o[256 + j] = a1;
  o[512 + j] = a2;
  o[768 + j] = a3;
}

using ProbeFn = void (*)(const int32_t*, const uint16_t*, int, int, int, float*);
const ProbeFn kProbe[3] = {
    texture_probe_kernel<0>,
    texture_probe_kernel<1>,
    texture_probe_kernel<2>,
};

}  // namespace

// info i32 [n_tiles, 8]; atlas bf16 bits [ah, 4 * aw] (8-byte aligned;
// unread by mode 0); out f32 [n_tiles, 1024]; mode 0 base, 1 atlas_rowsel,
// 2 slab.
extern "C" int forma_texture_probe(const void* info, const void* atlas,
                                   int64_t n_tiles, int64_t ah, int64_t aw,
                                   int64_t kmax, int64_t mode, void* out,
                                   cudaStream_t stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  kProbe[mode]<<<(unsigned)n_tiles, 256, 0, stream>>>(
      static_cast<const int32_t*>(info), static_cast<const uint16_t*>(atlas),
      (int)ah, (int)aw, (int)kmax, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
