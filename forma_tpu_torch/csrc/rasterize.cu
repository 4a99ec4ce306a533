// K4: virtual-line expansion fused with the packed pixel-segment emit.
//
// Replaces forma_tpu/ops/expand_pallas.py:rasterize_blocks_pallas, which
// the TPU runs over 1024-vline blocks: a compact live-line space, params
// moved into VMEM windows as byte-split bf16 planes and selected with a
// one-hot matmul, then the emit (`_emit_packed`) traced into the kernel.
// None of that blocking carries over: on the card a gather is cheap.  Each
// thread owns one virtual line v (at most k_seg pixel segments of one line):
//
//   li = the owning line, found once per warp (`warp_owning_line`,
//   vlines.cuh: a 32-ary search by ballots, then a window of ends searched
//   by shuffles), not by one binary search per thread;
//   the line's 16 params are loaded once, as raw 32-bit words;
//   for each segment k: i = j * k_seg + k, the float-float `_find` of the
//   (i+1)-th grid crossing (rasterizer.rs:22-76) -- the i-th is the one
//   the segment before computed, carried in a register, so n segments run
//   n + 1 finds, not 2n -- the rounded endpoints, border, cover and area,
//   and the packed key
//     ((tile_y + 1) << slot_bits | slot) << tx_bits | (tile_x + 1)
//   with the payload
//     local_x << 21 | local_y << 17 | (area + 1024) << 6 | (cover + 16),
//   stored as 32-bit words to packed[k * v_cap + v] / payload[k * v_cap + v]
//   (one 128-byte line per warp and k); invalid segments store the
//   sentinel key and the zero payload.
//
// The words are the TPU kernel's u32 values in int32 tensors, which the
// segment sort orders as signed.  A valid key is below 2^31: the caller
// keeps row + slot + tx within 31 bits (`slot_bits_for`, ops/pipeline.py).
// So the sentinel is 0x7FFFFFFF, not the u32 0xFFFFFFFF (which would read
// as -1 and sort first), and no valid key reaches it: tx_bits =
// bit_length(tiles_x + 1) keeps tile_x + 1 <= tiles_x < 2^tx_bits - 1, so
// the tx field is never all ones.
//
// Exactness: the result is bit-equal to the plain PyTorch version
// (`_emit_packed` over `expand_params_torch`, ops/rasterize_kernel.py).
// Every f32 op rounds alone (explicit __f*_rn intrinsics, --fmad=false):
// the Veltkamp split in two_product depends on it.  A carried find is the
// same operations on the same float as the one it replaces.  A NaN guess
// becomes +inf before the min, as in `_find`.  Float -> int conversions
// saturate with NaN -> 0 (cvt.rzi.s32.f32, `__float2int_rz`), as `f2i32`
// does.  Integer fields wrap in 32 bits like the plain version's int64
// arithmetic masked to 32 bits, so they are computed in uint32_t.
// row_lo is one int32 in device memory, not an argument: a frame's CUDA
// graph keeps its launch parameters, and reads the row span there.
//
// Bound on the H100: 8 bytes stored per segment slot, against f32
// operations issued alone at --fmad=false (76 per find, 12 per line for
// the splits and tests that depend only on the line, 22 per segment for
// the clamps and endpoints); at paris-30k's shapes the bytes bound it, the
// operations close behind.  Every integer, convert and address instruction
// competes with the f32 work for issue slots, hence the carried find and
// the warp's search.

#include <cstdint>
#include <cuda_runtime.h>

#include "vlines.cuh"

namespace {

constexpr int kParams = 16;
// Param columns (ops/line_setup.py).
constexpr int PX0 = 0, PY0 = 1, PDX = 2, PDY = 3, PA = 4, PB = 5, PC = 6,
              PD = 7, PAOH = 8, PAOL = 9, PBOH = 10, PBOL = 11, PCDH = 12,
              PCDL = 13, PSLOT = 14, PLEN = 15;
constexpr uint32_t kSentinel = 0x7FFFFFFFu;  // see above
constexpr uint32_t kZeroPayload = (1024u << 6) | 16u;
constexpr int kPixelShift = 4;   // consts.PIXEL_SHIFT
constexpr int kPixelWidth = 16;  // consts.PIXEL_WIDTH
constexpr int kTileShift = 4;    // consts.TILE_{WIDTH,HEIGHT}_SHIFT

struct FF {
  float hi, lo;
};

__device__ __forceinline__ void two_sum(float x, float y, float& r, float& e) {
  r = __fadd_rn(x, y);
  const float t = __fsub_rn(r, x);
  e = __fadd_rn(__fsub_rn(x, __fsub_rn(r, t)), __fsub_rn(y, t));
}

__device__ __forceinline__ FF two_sum_quick(float x, float y) {
  const float r = __fadd_rn(x, y);
  return {r, __fsub_rn(y, __fsub_rn(r, x))};
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(a, 4097.0f);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_product(float x, float y, float& r,
                                            float& e) {
  r = __fmul_rn(x, y);
  float xh, xl, yh, yl;
  split(x, xh, xl);
  split(y, yh, yl);
  e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(xh, yh), r), __fmul_rn(xh, yl)),
                __fmul_rn(xl, yh)),
      __fmul_rn(xl, yl));
}

// ff64.mul(x, ff(f)): the low word of ff(f) is 0 and still takes part.
__device__ __forceinline__ FF mul_f(FF x, float f) {
  float r, e;
  two_product(x.hi, f, r, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(x.hi, 0.0f), __fmul_rn(x.lo, f)));
  return two_sum_quick(r, e);
}

__device__ __forceinline__ FF add(FF x, FF y) {
  float r, e;
  two_sum(x.hi, y.hi, r, e);
  e = __fadd_rn(e, __fadd_rn(x.lo, y.lo));
  return two_sum_quick(r, e);
}

__device__ __forceinline__ FF sub(FF x, FF y) {
  float r, e;
  two_sum(x.hi, -y.hi, r, e);
  e = __fadd_rn(e, __fsub_rn(x.lo, y.lo));
  return two_sum_quick(r, e);
}

__device__ __forceinline__ float ff_ceil(FF v) {
  const float ch = ceilf(v.hi);
  const float cl = ceilf(v.lo);
  return ch > v.hi ? ch : __fadd_rn(ch, cl);
}

struct Line {
  float a, b, c, d;
  FF a_over, b_over, cd_over;
};

// `_find`: the i-th element of the merged progressions (rasterizer.rs:32-61).
__device__ __forceinline__ float find(float fi, const Line& l) {
  const float ja =
      isfinite(l.b) ? ff_ceil(sub(mul_f(l.b_over, fi), l.cd_over)) : fi;
  const float jb =
      isfinite(l.a) ? ff_ceil(add(mul_f(l.a_over, fi), l.cd_over)) : fi;
  float ga = __fadd_rn(__fmul_rn(l.a, ja), l.c);
  float gb = __fadd_rn(__fmul_rn(l.b, jb), l.d);
  if (isnan(ga)) ga = __int_as_float(0x7f800000);
  if (isnan(gb)) gb = __int_as_float(0x7f800000);
  return gb < ga ? gb : ga;
}

// round_ of `_emit_core`: floor(v + 0.5) through the saturating f2i32.
__device__ __forceinline__ int32_t round_px(float v) {
  return __float2int_rz(floorf(__fadd_rn(v, 0.5f)));
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rasterize_kernel(const uint32_t* __restrict__ params,
                 const int64_t* __restrict__ vline_ends,
                 const int64_t* __restrict__ v_total, int64_t n_lines,
                 int64_t v_cap, int k_seg, int rows, int tiles_x,
                 const int32_t* __restrict__ row_lo,
                 int slot_bits, int tx_bits, uint32_t* __restrict__ packed,
                 uint32_t* __restrict__ payload) {
  const int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // The whole warp searches, lanes past v_cap included.
  const Owner own = warp_owning_line(vline_ends, n_lines, v - lane, lane);
  if (v >= v_cap) return;
  // The global tile row of the frame's row 0, read from device memory (as
  // JAX traces it), so one CUDA graph of the frame serves every row span.
  const int row0 = *row_lo;
  int len = 0;  // a padding vline emits nothing
  float p[kParams] = {};
  int32_t j = 0;
  if (v < *v_total && own.line < n_lines) {
    const uint4* row =
        reinterpret_cast<const uint4*>(params + own.line * kParams);
#pragma unroll
    for (int q = 0; q < kParams / 4; ++q) {
      const uint4 w = row[q];
      p[4 * q + 0] = __uint_as_float(w.x);
      p[4 * q + 1] = __uint_as_float(w.y);
      p[4 * q + 2] = __uint_as_float(w.z);
      p[4 * q + 3] = __uint_as_float(w.w);
    }
    len = __float2int_rz(p[PLEN]);
    j = (int32_t)(v - own.start);
  }
  const Line l = {p[PA], p[PB], p[PC], p[PD],
                  {p[PAOH], p[PAOL]}, {p[PBOH], p[PBOL]}, {p[PCDH], p[PCDL]}};
  const uint32_t slot = (uint32_t)__float2int_rz(p[PSLOT]);
  const int32_t skip = (int32_t)(l.c != 0.0f) + (int32_t)(l.d != 0.0f);
  const int32_t i0 = j * k_seg;
  // The raw find of the segment's first crossing: segment 0 computes it,
  // every later one takes the segment before's second crossing.
  float f_lo = i0 < len ? find(__int2float_rn(i0 - skip), l) : 0.0f;

  for (int k = 0; k < k_seg; ++k) {
    const int32_t i = i0 + k;
    uint32_t key = kSentinel, pay = kZeroPayload;
    if (i < len) {
      const float f_hi = find(__int2float_rn(i - skip + 1), l);
      const float t0 = fmaxf(f_lo, 0.0f);
      const float t1 = fminf(f_hi, 1.0f);
      f_lo = f_hi;
      const int32_t x0s = round_px(__fadd_rn(__fmul_rn(t0, p[PDX]), p[PX0]));
      const int32_t y0s = round_px(__fadd_rn(__fmul_rn(t0, p[PDY]), p[PY0]));
      const int32_t x1s = round_px(__fadd_rn(__fmul_rn(t1, p[PDX]), p[PX0]));
      const int32_t y1s = round_px(__fadd_rn(__fmul_rn(t1, p[PDY]), p[PY0]));

      const int32_t border_x = min(x0s, x1s) >> kPixelShift;
      const int32_t border_y = min(y0s, y1s) >> kPixelShift;
      int32_t tile_x = border_x >> kTileShift;
      const int32_t tile_y =
          (int32_t)((uint32_t)(border_y >> kTileShift) - (uint32_t)row0);
      const uint32_t local_x = (uint32_t)border_x & 15u;
      const uint32_t local_y = (uint32_t)border_y & 15u;

      const uint32_t border =
          ((uint32_t)border_x << kPixelShift) + (uint32_t)kPixelWidth;
      const uint32_t cover = (uint32_t)y1s - (uint32_t)y0s;
      const uint32_t dx = (uint32_t)x1s - (uint32_t)x0s;
      const uint32_t adx = (int32_t)dx < 0 ? 0u - dx : dx;
      const uint32_t mult = adx + 2u * (border - (uint32_t)max(x0s, x1s));
      const uint32_t area = mult * cover;

      // Left of the viewport clamps to the cover-carry tile -1; rows
      // outside [0, rows) and tiles right of the viewport drop.
      tile_x = max(tile_x, -1);
      if (tile_y >= 0 && tile_y < rows && tile_x < tiles_x) {
        key = (((((uint32_t)tile_y + 1u) << slot_bits) | slot) << tx_bits) |
              ((uint32_t)tile_x + 1u);
        pay = (local_x << 21) | (local_y << 17) | ((area + 1024u) << 6) |
              (cover + 16u);
      }
    }
    packed[k * v_cap + v] = key;
    payload[k * v_cap + v] = pay;
  }
}

}  // namespace

extern "C" int forma_rasterize(const void* params, const void* vline_ends,
                               const void* v_total, int64_t n_lines,
                               int64_t v_cap, int64_t k_seg, int64_t rows,
                               int64_t tiles_x, const void* row_lo,
                               int64_t slot_bits, int64_t tx_bits,
                               void* packed, void* payload,
                               cudaStream_t stream) {
  const int64_t blocks = (v_cap + kThreads - 1) / kThreads;
  rasterize_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(params),
      static_cast<const int64_t*>(vline_ends),
      static_cast<const int64_t*>(v_total), n_lines, v_cap, (int)k_seg,
      (int)rows, (int)tiles_x, static_cast<const int32_t*>(row_lo),
      (int)slot_bits, (int)tx_bits,
      static_cast<uint32_t*>(packed), static_cast<uint32_t*>(payload));
  return (int)cudaGetLastError();
}
