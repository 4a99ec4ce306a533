// K6 and K7: the TPU microbenchmarks' Pallas kernels.
//
// K6 replaces tools/tpu_microbench2.py:unit_stream (unit_stream_kernel),
// which asked whether a sequential stream of units, each a [2, 128]
// read-modify-write of its tile's 256 pixels in VMEM, runs fast on the
// TPU:  for u in order: out[tile_of[u]] = out * (1 - c) + c, c = cov[u].
// The TPU runs one scalar loop over all units.  Here the units come
// grouped by tile in increasing u (a stable sort, prep that the wrapper
// runs and times apart), and the tiles fold in parallel: one block per
// tile, 256 threads, one pixel each, the pixel's value in a register; a
// unit is one coalesced 1 KB row of cov.  Units are read four at a time,
// their loads issued before the four dependent folds, so each warp keeps
// four rows in flight.  Every tile starts at 0 (the TPU kernel reads out
// before it ever writes it; the port defines the start).  Bound on the
// H100: the 1 KB of cov per unit, 268 MB at the tool's 2^18 units.
//
// K7 replaces tools/tpu_microbench2.py:seg_loop (seg_kernel), a per-segment
// scalar loop that adds 1.0 to acc[s // 128, s % 128] for each of 2^20
// segments: a 256-bin histogram as f32 counts.  Here a histogram per warp
// in shared memory with integer atomics (each thread streams 16 segments
// as four int4 loads in flight), each block's sums written to a partial
// row, then a one-block kernel adds the rows and converts to f32: exact
// in any order, since every count stays below 2^24.  Bound on the H100:
// reading the 4 MB of segments.
//
// Both are bit-equal to their plain versions (probes.microbench): K6's
// folds are explicitly rounded f32 ops in the tool's order
// (--fmad=false), K7's counts integers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fold(float acc, float c) {
  return __fadd_rn(__fmul_rn(acc, __fsub_rn(1.0f, c)), c);
}

__global__ void __launch_bounds__(256)
unit_stream_kernel(const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ start,
                   const float* __restrict__ cov, float* __restrict__ out) {
  const int64_t t = blockIdx.x;
  const int p = threadIdx.x;
  const int32_t lo = start[t], hi = start[t + 1];
  float acc = 0.0f;
  int32_t i = lo;
  for (; i + 4 <= hi; i += 4) {
    float c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = cov[(int64_t)perm[i + j] * 256 + p];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = fold(acc, c[j]);
  }
  for (; i < hi; ++i) acc = fold(acc, cov[(int64_t)perm[i] * 256 + p]);
  out[t * 256 + p] = acc;
}

constexpr int kBins = 256;

__device__ __forceinline__ void count(int32_t* hist, int32_t s) {
  if ((uint32_t)s < kBins) atomicAdd(&hist[s], 1);
}

__device__ __forceinline__ void count4(int32_t* hist, int4 v) {
  count(hist, v.x);
  count(hist, v.y);
  count(hist, v.z);
  count(hist, v.w);
}

constexpr int kWarps = 8;  // seg_hist_kernel: 256 threads

// Each warp counts into its own shared histogram (fewer threads contend
// for one bin); each thread reads segments as int4 vectors, four vectors
// in flight (16 segments) before their atomics, so an SM keeps enough
// loads outstanding to stream the input (segs 16-byte aligned).  Block x
// writes its 256 sums to partial[x]: no global atomics.
__global__ void __launch_bounds__(256)
seg_hist_kernel(const int32_t* __restrict__ segs, int64_t n,
                int32_t* __restrict__ partial) {
  __shared__ int32_t hist[kWarps][kBins];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) hist[w][threadIdx.x] = 0;
  __syncthreads();
  int32_t* mine = hist[threadIdx.x >> 5];
  const int4* v = reinterpret_cast<const int4*>(segs);
  const int64_t nv = n >> 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < nv; j += 4 * stride) {
    int4 a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j + q * stride < nv) a[q] = v[j + q * stride];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j + q * stride < nv) count4(mine, a[q]);
  }
  if (blockIdx.x == 0 && 4 * nv + threadIdx.x < n) count(mine, segs[4 * nv + threadIdx.x]);
  __syncthreads();
  int32_t h = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) h += hist[w][threadIdx.x];
  partial[(int64_t)blockIdx.x * kBins + threadIdx.x] = h;
}

// out[bin] = f32(sum over blocks of partial[block][bin]).
__global__ void seg_sum_kernel(const int32_t* __restrict__ partial, int blocks,
                               float* __restrict__ out) {
  int32_t h = 0;
  for (int x = 0; x < blocks; ++x) h += partial[x * kBins + threadIdx.x];
  out[threadIdx.x] = __int2float_rn(h);
}

}  // namespace

// perm i32 [units] (unit ids grouped by tile, u increasing within a
// tile); start i32 [n_tiles + 1] (tile t's units are perm[start[t] ..
// start[t+1])); cov f32 [units, 256]; out f32 [n_tiles, 256].
extern "C" int forma_unit_stream(const void* perm, const void* start,
                                 const void* cov, int64_t n_tiles, void* out,
                                 cudaStream_t stream) {
  unit_stream_kernel<<<(unsigned)n_tiles, 256, 0, stream>>>(
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(start),
      static_cast<const float*>(cov), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// segs i32 [n], 16-byte aligned (values outside [0, 256) count nowhere);
// partial i32 [blocks, 256] scratch (the wrapper picks blocks, about 16
// segments a thread); out f32 [256].
extern "C" int forma_seg_loop(const void* segs, int64_t n, int64_t blocks,
                              void* partial, void* out, cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  seg_hist_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const int32_t*>(segs), n, static_cast<int32_t*>(partial));
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  seg_sum_kernel<<<1, kBins, 0, stream>>>(static_cast<const int32_t*>(partial),
                                          (int)blocks, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
