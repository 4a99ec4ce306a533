// Virtual-line ownership, shared by K1 (expand.cu) and K4 (rasterize.cu).
//
// vline_ends is the inclusive cumsum of per-line virtual-line counts, so
// line ownership is monotonic: vline v belongs to the first line whose
// inclusive end exceeds v.  Dead lines (no vlines) repeat the previous end
// and are never chosen.  Padding vlines (v >= the total) get n_lines.

#pragma once

#include <cstdint>

static __device__ __forceinline__ int64_t owning_line(
    const int64_t* __restrict__ vline_ends, int64_t n_lines, int64_t v) {
  // Upper bound: smallest i with vline_ends[i] > v, or n_lines.
  int64_t lo = 0, hi = n_lines;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (vline_ends[mid] > v) hi = mid; else lo = mid + 1;
  }
  return lo;
}
