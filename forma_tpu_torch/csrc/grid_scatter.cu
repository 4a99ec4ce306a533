// K9: the scatter probe.
//
// Replaces tools/pallas_scatter_probe.py:run (kernel), which asked how fast
// one TPU core can accumulate a stream of (row, cell, val) segments into a
// [256, 256] i32 window held in VMEM, one dynamic [1, 256] read-modify-
// write per segment: acc[row, cell] += val.  That is the question of K2's
// untried shared-memory run window (csrc/grid.cu adds every segment to
// device memory with a global atomic).  Here:
//
//   the 256 KB window is larger than a block's 227 KB of shared memory, so
//   a thread-block cluster of 2 CTAs holds it in distributed shared memory:
//   rank k owns rows [128 k, 128 k + 128).  Cluster g reads its own
//   contiguous share of the segments once, four segments per int4 of each
//   array spread over all 1,024 threads, and adds each segment into the
//   rank that owns its row (cooperative_groups::this_cluster().
//   map_shared_rank, then atomicAdd on the mapped address: half of the
//   adds cross to the other SM).  Every thread fences its adds into the
//   async proxy before a cluster barrier; then each CTA adds its rows into
//   the output with bulk reductions (cp.reduce.async.bulk .add.u32, 4 KB
//   each, done in L2: no per-word global atomics), each cluster starting
//   at another piece; the output is zeroed by a 256 KB memset queued
//   before the kernel.  So a call is one memset and one launch, with no
//   scratch and no allocation but the output.  Integer sums are exact in
//   any order.  Segments whose row or cell lies outside [0, 256) add
//   nothing (the TPU kernel's one-hot row ignores such a cell; such a row
//   would leave its window).
//
// Bound on the H100: reading 12 bytes per segment (12.6 MB at the tool's
// 2^20) and writing the 256 KB window.  What bounds the kernel is the rest
// (PERF.md section 6): the remote adds, and the clusters' windows reduced
// in L2 (256 KB each: 16 MB for the 64 pairs that keep 128 SMs adding),
// which run at a per-SM rate.  Designs that lost on the card: clusters of
// 4, 8 and 16 CTAs (fewer windows to reduce, but a remote add across more
// than the two SMs of a pair costs several times as much), an accumulator
// kept across calls and copied out by the last cluster to arrive (one
// launch, but that cluster's copy of its rows is a tail longer than the
// memset), an outbox of the other rank's segments read by its owner in
// 16-byte loads (no faster than the remote adds), and the design before
// clusters, a 16,384-segment chunk's window per block in two 128-row bands
// (each chunk read once per band) stored to a partial in device memory and
// summed by a second kernel, which is faster on the card by CUDA graph
// (PERF.md section 6).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCells = 256;   // cells per row
constexpr int kRows = 256;    // rows of the window
constexpr int kWindow = kRows * kCells;
constexpr int kThreads = 512;
constexpr int kCluster = 2;      // CTAs per cluster
constexpr int kRankShift = 7;    // log2 of the rows a rank owns (256 / kCluster)
constexpr int kRankWords = kCells << kRankShift;
constexpr int kPiece = 4096;     // bytes per bulk reduction

__device__ __forceinline__ void add(int32_t* band, int32_t r, int32_t c, int32_t v) {
  if ((uint32_t)r < (uint32_t)kRows && (uint32_t)c < (uint32_t)kCells) {
    int32_t* owner = cg::this_cluster().map_shared_rank(band, (int)((uint32_t)r >> kRankShift));
    atomicAdd(owner + ((r & ((1 << kRankShift) - 1)) << 8) + c, v);
  }
}

__device__ __forceinline__ void add4(int32_t* band, int4 r, int4 c, int4 v) {
  add(band, r.x, c.x, v.x);
  add(band, r.y, c.y, v.y);
  add(band, r.z, c.z, v.z);
  add(band, r.w, c.w, v.w);
}

// out i32 [256 * 256], zero on entry.  One CTA an SM (its 128 KB of
// rows), which the launch bounds tell ptxas: at its default register
// target the kernel spills.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
grid_scatter_kernel(const int32_t* __restrict__ row,
                    const int32_t* __restrict__ cell,
                    const int32_t* __restrict__ val, int64_t n,
                    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t band[];  // this rank's rows
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();

  int4* b4 = reinterpret_cast<int4*>(band);
  for (int j = threadIdx.x; j < kRankWords / 4; j += kThreads) b4[j] = make_int4(0, 0, 0, 0);
  cluster.sync();  // every rank's rows are zero before any add reaches them

  // This cluster's share of the int4 vectors, the threads of all its ranks
  // interleaved; two int4 triples in flight per thread before their adds.
  const int clusters = (int)(gridDim.x / kCluster);
  const int cid = (int)(blockIdx.x / kCluster);
  const int64_t nv = n >> 2;
  const int64_t lo = nv * cid / clusters;
  const int64_t hi = nv * (cid + 1) / clusters;
  const int4* r4 = reinterpret_cast<const int4*>(row);
  const int4* c4 = reinterpret_cast<const int4*>(cell);
  const int4* v4 = reinterpret_cast<const int4*>(val);
  const int tid = rank * kThreads + threadIdx.x;
  const int stride = kCluster * kThreads;
  for (int64_t j = lo + tid; j < hi; j += 2 * stride) {
    const bool two = j + stride < hi;
    const int4 ra = r4[j], ca = c4[j], va = v4[j];
    int4 rb = ra, cb = ca, vb = va;
    if (two) {
      rb = r4[j + stride];
      cb = c4[j + stride];
      vb = v4[j + stride];
    }
    add4(band, ra, ca, va);
    if (two) add4(band, rb, cb, vb);
  }
  if (cid == clusters - 1)  // the ragged end, one by one
    for (int64_t i = 4 * nv + tid; i < n; i += stride)
      add(band, row[i], cell[i], val[i]);
  // This thread's adds, to either rank, are seen by the async proxy that
  // the bulk reductions read through; after the barrier every add has
  // landed and no rank touches another.
  asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
  cluster.sync();

  // This rank's rows into out: bulk reductions in L2, one thread a 4 KB
  // piece, the clusters' first pieces spread; each waits for its own
  // before the CTA (and its shared memory) goes.
  constexpr int kPieces = kRankWords * 4 / kPiece;
  if (threadIdx.x < kPieces) {
    const int p = (threadIdx.x + cid) % kPieces;
    const uint32_t src = (uint32_t)__cvta_generic_to_shared(band) + p * kPiece;
    int32_t* dst = out + (int64_t)rank * kRankWords + p * (kPiece / 4);
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 [%0], [%1], %2;"
        :: "l"(dst), "r"(src), "r"(kPiece) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

}  // namespace

// row, cell, val i32 [n], 16-byte aligned; clusters >= 1 (pairs of CTAs);
// out i32 [256, 256] (zeroed here, then every cell written).
extern "C" int forma_grid_scatter(const void* row, const void* cell,
                                  const void* val, int64_t n, int64_t clusters,
                                  void* out, cudaStream_t stream) {
  if (clusters < 1 || n < 0) return (int)cudaErrorInvalidValue;
  // Once per process (a call inside a CUDA graph capture then only
  // launches).
  static const cudaError_t attr =
      cudaFuncSetAttribute(grid_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kRankWords * (int)sizeof(int32_t));
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t rc = cudaMemsetAsync(out, 0, kWindow * sizeof(int32_t), stream);
  if (rc != cudaSuccess) return (int)rc;
  grid_scatter_kernel<<<(unsigned)(kCluster * clusters), kThreads,
                        kRankWords * sizeof(int32_t), stream>>>(
      static_cast<const int32_t*>(row), static_cast<const int32_t*>(cell),
      static_cast<const int32_t*>(val), n, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
