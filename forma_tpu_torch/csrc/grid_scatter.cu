// K9: the scatter probe.
//
// Replaces tools/pallas_scatter_probe.py:run (kernel), which asked how fast
// one TPU core can accumulate a stream of (row, cell, val) segments into a
// [256, 256] i32 window held in VMEM, one dynamic [1, 256] read-modify-
// write per segment: acc[row, cell] += val.  That is the question of K2's
// untried shared-memory run window (csrc/grid.cu adds every segment to
// device memory with a global atomic).  Here:
//
//   the window is 256 KB, more than a block's 227 KB of shared memory, so
//   it splits into two bands of 128 rows (128 KB each); block (x, b) takes
//   segments [x * chunk, (x + 1) * chunk) and keeps those whose row lies in
//   band b (row >> 7 == b: each row in [0, 256) falls in exactly one band),
//   adding each into its band in shared memory with an integer atomicAdd;
//   then it stores the band, with plain stores, into chunk x's partial
//   window in device memory; a second kernel adds the chunks' partial
//   windows cell by cell.  No global atomics: flushing the bands by
//   global atomics would issue, on independent segments, about as many of
//   them as there are segments.  Integer sums are exact in any order.  Segments whose row or cell lies outside
//   [0, 256) add nothing (the TPU kernel's one-hot row ignores such a
//   cell; such a row would leave its window).
//
// Bound on the H100: reading 12 bytes per segment (12.6 MB at the tool's
// 2^20) and writing the 256 KB window.  The kernel also reads every chunk
// once per band (mostly from L2) and writes and reads back a 256 KB
// partial window per chunk (16 MB at 64 chunks, mostly in L2), and waits
// on the shared-memory atomics, contended when many segments hit one cell
// (the tool's own inputs had row == cell: 256 targets).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 256;      // cells per row
constexpr int kBandShift = 7;    // 128 rows per band
constexpr int kBandRows = 1 << kBandShift;
constexpr int kBands = 256 / kBandRows;
constexpr int kBandWords = kBandRows * kCells;
constexpr int kWindow = 256 * kCells;
constexpr int kThreads = 512;

__device__ __forceinline__ void add(int32_t* band, int b, int32_t r, int32_t c,
                                    int32_t v) {
  if ((uint32_t)r < 256u && (uint32_t)c < (uint32_t)kCells && (r >> kBandShift) == b)
    atomicAdd(&band[(r & (kBandRows - 1)) * kCells + c], v);
}

__device__ __forceinline__ void add4(int32_t* band, int b, int4 r, int4 c, int4 v) {
  add(band, b, r.x, c.x, v.x);
  add(band, b, r.y, c.y, v.y);
  add(band, b, r.z, c.z, v.z);
  add(band, b, r.w, c.w, v.w);
}

__global__ void __launch_bounds__(kThreads)
grid_scatter_kernel(const int32_t* __restrict__ row,
                    const int32_t* __restrict__ cell,
                    const int32_t* __restrict__ val, int64_t n, int64_t chunk,
                    int32_t* __restrict__ partial) {
  extern __shared__ int32_t band[];
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < kBandWords; j += kThreads) band[j] = 0;
  __syncthreads();
  const int64_t lo = blockIdx.x * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  // Four segments per int4 of each array, two int4 triples in flight per
  // thread before their atomics (chunk is a multiple of 4, the arrays
  // 16-byte aligned), then the ragged end one by one.
  const int4* r4 = reinterpret_cast<const int4*>(row + lo);
  const int4* c4 = reinterpret_cast<const int4*>(cell + lo);
  const int4* v4 = reinterpret_cast<const int4*>(val + lo);
  const int64_t nv = (hi - lo) >> 2;
  for (int64_t j = threadIdx.x; j < nv; j += 2 * kThreads) {
    const bool two = j + kThreads < nv;
    const int4 ra = r4[j], ca = c4[j], va = v4[j];
    int4 rb = ra, cb = ca, vb = va;
    if (two) {
      rb = r4[j + kThreads];
      cb = c4[j + kThreads];
      vb = v4[j + kThreads];
    }
    add4(band, b, ra, ca, va);
    if (two) add4(band, b, rb, cb, vb);
  }
  for (int64_t i = lo + 4 * nv + threadIdx.x; i < hi; i += kThreads)
    add(band, b, row[i], cell[i], val[i]);
  __syncthreads();
  // The band goes to this chunk's partial window with plain int4 stores.
  int4* o = reinterpret_cast<int4*>(partial + (int64_t)blockIdx.x * kWindow +
                                    (int64_t)b * kBandWords);
  const int4* sb = reinterpret_cast<const int4*>(band);
  for (int j = threadIdx.x; j < kBandWords / 4; j += kThreads) o[j] = sb[j];
}

// out[cell] = sum over chunks of partial[chunk][cell], eight chunks' loads
// in flight per thread.
__global__ void __launch_bounds__(256)
window_sum_kernel(const int32_t* __restrict__ partial, int64_t chunks,
                  int32_t* __restrict__ out) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  int32_t acc = 0;
  int64_t x = 0;
  for (; x + 8 <= chunks; x += 8) {
    int32_t v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = partial[(x + q) * kWindow + j];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc += v[q];
  }
  for (; x < chunks; ++x) acc += partial[x * kWindow + j];
  out[j] = acc;
}

}  // namespace

// row, cell, val i32 [n], 16-byte aligned; chunk segments per block, a
// multiple of 4; partial i32 [ceil(n / chunk), 256 * 256] scratch; out i32
// [256, 256] (every cell written).
extern "C" int forma_grid_scatter(const void* row, const void* cell,
                                  const void* val, int64_t n, int64_t chunk,
                                  void* partial, void* out, cudaStream_t stream) {
  if (chunk < 4 || chunk % 4) return (int)cudaErrorInvalidValue;
  const int smem = kBandWords * (int)sizeof(int32_t);
  // Once per process (a call inside a CUDA graph capture then only
  // launches).
  static cudaError_t attr = cudaFuncSetAttribute(
      grid_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaError_t rc = attr;
  if (rc != cudaSuccess) return (int)rc;
  const int64_t chunks = (n + chunk - 1) / chunk;
  if (chunks > 0) {
    grid_scatter_kernel<<<dim3((unsigned)chunks, kBands), kThreads, smem, stream>>>(
        static_cast<const int32_t*>(row), static_cast<const int32_t*>(cell),
        static_cast<const int32_t*>(val), n, chunk, static_cast<int32_t*>(partial));
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  window_sum_kernel<<<kWindow / 256, 256, 0, stream>>>(
      static_cast<const int32_t*>(partial), chunks, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
