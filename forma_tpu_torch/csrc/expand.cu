// K1: per-line parameter expansion onto virtual lines.
//
// Replaces forma_tpu/ops/expand_pallas.py:expand_params_pallas (body
// _expand_kernel), which the TPU runs as a byte-split bf16 one-hot matmul
// over 1024-vline windows.  Here each thread owns one virtual line v:
//
//   li   = first line whose inclusive vline end exceeds v (upper-bound
//          binary search over vline_ends, `owning_line` in vlines.cuh;
//          dead lines repeat the previous end, so they are skipped),
//   out[c, v] = params[li, c] for the 16 columns, copied as raw 32-bit
//          words (no float instruction touches them, so every bit pattern,
//          inf and NaN included, survives),
//   j[v] = v - (exclusive start of li).
//
// Padding vlines (v >= the vline total) get zero params and j = v - total,
// as in the Pallas contract.
//
// Bound on the H100: memory traffic.  The output is 68 bytes per vline,
// written column-major ([16, v_cap]) so that neighbouring threads store to
// neighbouring addresses (coalesced); the reads of params rows and of the
// search path hit L2, since neighbouring vlines share lines.

#include <cstdint>
#include <cuda_runtime.h>

#include "vlines.cuh"

namespace {

constexpr int kParams = 16;

__global__ void expand_kernel(const uint32_t* __restrict__ params,
                              const int64_t* __restrict__ vline_ends,
                              int64_t n_lines, int64_t v_cap,
                              uint32_t* __restrict__ out,
                              int32_t* __restrict__ j_out) {
  const int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (v >= v_cap) return;
  const int64_t li = owning_line(vline_ends, n_lines, v);
  const int64_t start = li > 0 ? vline_ends[li - 1] : 0;
  j_out[v] = (int32_t)(v - start);
  if (li < n_lines) {
    const uint32_t* row = params + li * kParams;
#pragma unroll
    for (int c = 0; c < kParams; ++c) out[c * v_cap + v] = row[c];
  } else {
#pragma unroll
    for (int c = 0; c < kParams; ++c) out[c * v_cap + v] = 0u;
  }
}

}  // namespace

extern "C" int forma_expand(const void* params, const void* vline_ends,
                            int64_t n_lines, int64_t v_cap, void* out,
                            void* j_out, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (v_cap + threads - 1) / threads;
  expand_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint32_t*>(params),
      static_cast<const int64_t*>(vline_ends), n_lines, v_cap,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(j_out));
  return (int)cudaGetLastError();
}
