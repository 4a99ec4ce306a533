// The stage stamp: one thread that reads the device's global timer at a
// stage boundary of a frame (`forma_tpu_torch/tracing.py`, `mark`).
//
// Replaces no TPU kernel.  The frame is one CUDA graph replay, which the
// host cannot fence inside, so the pipeline's stages time themselves on
// the device: a stamp node between two stages adds the nanoseconds since
// the previous stamp to the stage that just ended.  Stamps run in stream
// order, so each one starts after the stage before it has finished and
// the next stage waits for it; the time between two stamps is the stage's
// kernels plus the gaps between them.
//
// Bound on the H100: launch latency, about a microsecond a node in a
// graph; it reads and writes four words of one int64 accumulator
// (`acc`: ns per stage [n_stages], stamps per stage [n_stages], frames,
// the previous stamp's time), which lives outside every graph pool so
// that the graphs keep its address.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void stage_stamp_kernel(int64_t* acc, int64_t stage, int64_t n_stages,
                                   int64_t last) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  int64_t* prev = acc + 2 * n_stages + 1;
  if (stage >= 0) {
    acc[stage] += (int64_t)now - *prev;
    acc[n_stages + stage] += 1;
  }
  *prev = (int64_t)now;
  if (last) acc[2 * n_stages] += 1;
}

}  // namespace

// acc int64 [2 * n_stages + 2]; stage: the stage that ends here, -1 at a
// frame's first stamp; last: the frame's last stamp (counts the frame).
extern "C" int forma_stage_stamp(void* acc, int64_t stage, int64_t n_stages,
                                 int64_t last, cudaStream_t stream) {
  if (stage < -1 || stage >= n_stages) return (int)cudaErrorInvalidValue;
  stage_stamp_kernel<<<1, 1, 0, stream>>>(static_cast<int64_t*>(acc), stage, n_stages,
                                          last);
  return (int)cudaGetLastError();
}
