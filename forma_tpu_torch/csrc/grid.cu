// K2: per-run packed area|cover grids, cover row sums and run keys.
//
// Replaces forma_tpu/ops/grid_pallas.py:grid_build_pallas (body _kernel,
// with_keys=True), which the TPU runs as one-hot bf16 matmuls over 32-row
// chunks carried across a sequential grid.  Here one thread owns one
// segment of the run-sorted stream:
//
//   grid[rid, cell]          += area * 65536 + cover   (integer atomicAdd)
//   rowcov[rid, cell >> 4]   += cover                  (integer atomicAdd)
//   runkeys[rid] = (key_hi, key_lo)   by the run's first segment, where rid
//                                     steps up from its predecessor
//
// Integer atomics make the sums exact in any order: packed two's-complement
// sums equal the packing of the sums (forma_tpu/ops/runs.py:88-93), and the
// per-cell cover sums stay within i16, so the cover rows equal the row sums
// of the grid's sign-extended low halves.  Padding and sentinel segments
// carry zero area and cover and skip the atomics.  The outputs arrive
// zeroed from the wrapper, so rows past the last run read 0.
//
// Bound on the H100: atomic throughput into L2 (one or two 4-byte atomics
// per live segment) plus 40 bytes of reads per segment.  Segments of one
// run are contiguous, so a warp's atomics mostly land in one 1 KB grid row.
// A shared-memory window per run range (as paint.wgsl:320-362 does) is the
// next step if the atomics show in a profile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void grid_kernel(const int32_t* __restrict__ rid,
                            const int32_t* __restrict__ cell,
                            const int32_t* __restrict__ area,
                            const int32_t* __restrict__ cover,
                            const int64_t* __restrict__ key_hi,
                            const int64_t* __restrict__ key_lo, int64_t n,
                            int64_t run_cap, int32_t* __restrict__ grid,
                            int32_t* __restrict__ rowcov,
                            int64_t* __restrict__ runkeys) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r = rid[i];
  if (r < 0 || r >= run_cap) return;
  if (i == 0 || rid[i - 1] != r) {
    runkeys[2 * r] = key_hi[i];
    runkeys[2 * r + 1] = key_lo[i];
  }
  const int32_t a = area[i];
  const int32_t c = cover[i];
  if (a == 0 && c == 0) return;
  const int32_t k = cell[i];
  // Unsigned arithmetic: the packed value wraps mod 2^32 like the i32 sum.
  const uint32_t packed = ((uint32_t)a << 16) + (uint32_t)c;
  atomicAdd(reinterpret_cast<unsigned int*>(grid + r * 256 + k), packed);
  if (c != 0) atomicAdd(rowcov + r * 16 + (k >> 4), c);
}

}  // namespace

extern "C" int forma_grid(const void* rid, const void* cell, const void* area,
                          const void* cover, const void* key_hi,
                          const void* key_lo, int64_t n, int64_t run_cap,
                          void* grid, void* rowcov, void* runkeys,
                          cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  grid_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(rid), static_cast<const int32_t*>(cell),
      static_cast<const int32_t*>(area), static_cast<const int32_t*>(cover),
      static_cast<const int64_t*>(key_hi), static_cast<const int64_t*>(key_lo),
      n, run_cap, static_cast<int32_t*>(grid), static_cast<int32_t*>(rowcov),
      static_cast<int64_t*>(runkeys));
  return (int)cudaGetLastError();
}
