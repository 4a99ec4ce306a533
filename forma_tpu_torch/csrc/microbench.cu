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
// segments: a 256-bin histogram as f32 counts.  Bound on the H100: reading
// the 4 MB of segments, 1.3 us, under the cost of one launch; so the
// design is one launch and no scratch a call.  A grid sized to the card
// (blocks per SM x SMs, fewer for a short input); each warp counts into
// its own shared histogram with integer atomics, each thread four int4
// loads in flight (16 segments) before their atomics; each block adds its
// 256 sums into a persistent u32 counter row with global atomics, then
// takes a ticket (__threadfence, then atomicAdd on a counter): the last
// block reads the row as f32 into out and zeroes the row and the ticket
// for the next call.  The 1 KB + 4 B workspace is the wrapper's, one per
// (device, stream), zeroed once.  Exact in any block order: the counts
// are integers, converted once.  On the H100 one block an SM beat two and
// four (fewer global atomics and a shorter ticket tail for the same 4 MB),
// and this design beat f32 atomics straight into a memset output and warp
// aggregation by __match_any_sync (PERF.md).
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
constexpr int kWarps = 8;  // seg_loop_kernel: 256 threads
constexpr int kInFlight = 4;  // int4 loads a thread issues before their atomics

__device__ __forceinline__ void count(uint32_t* hist, int32_t s) {
  if ((uint32_t)s < kBins) atomicAdd(&hist[s], 1u);
}

__device__ __forceinline__ void count4(uint32_t* hist, int4 v) {
  count(hist, v.x);
  count(hist, v.y);
  count(hist, v.z);
  count(hist, v.w);
}

// segs 16-byte aligned; values outside [0, 256) count nowhere.  ws u32
// [257]: the counter row and the ticket, zero on entry and on exit.
__global__ void __launch_bounds__(256)
seg_loop_kernel(const int32_t* __restrict__ segs, int64_t n,
                uint32_t* __restrict__ ws, float* __restrict__ out) {
  __shared__ uint32_t hist[kWarps][kBins];
  __shared__ bool last;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) hist[w][threadIdx.x] = 0;
  __syncthreads();
  uint32_t* mine = hist[threadIdx.x >> 5];
  const int4* v = reinterpret_cast<const int4*>(segs);
  const int64_t nv = n >> 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < nv;
       j += kInFlight * stride) {
    int4 a[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q)
      if (j + q * stride < nv) a[q] = __ldcs(v + j + q * stride);
#pragma unroll
    for (int q = 0; q < kInFlight; ++q)
      if (j + q * stride < nv) count4(mine, a[q]);
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) count(mine, segs[4 * nv + threadIdx.x]);
  __syncthreads();
  uint32_t h = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) h += hist[w][threadIdx.x];
  if (h) atomicAdd(&ws[threadIdx.x], h);
  __threadfence();  // this block's adds land before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&ws[kBins], 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    out[threadIdx.x] = __uint2float_rn(atomicExch(&ws[threadIdx.x], 0u));
    if (threadIdx.x == 0) ws[kBins] = 0;
  }
}

__global__ void empty_kernel() {}

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
// blocks (the wrapper sizes the grid to the card); ws u32 [257], zero (the
// wrapper's, one per stream); out f32 [256].
extern "C" int forma_seg_loop(const void* segs, int64_t n, int64_t blocks,
                              void* ws, void* out, cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  seg_loop_kernel<<<(unsigned)blocks, kBins, 0, stream>>>(
      static_cast<const int32_t*>(segs), n, static_cast<uint32_t*>(ws),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One launch of a kernel that does nothing: the launch floor that K7's
// time is judged against.
extern "C" int forma_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
