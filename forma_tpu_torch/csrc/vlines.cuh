// Virtual-line ownership, shared by K1 (expand.cu) and K4 (rasterize.cu).
//
// vline_ends is the inclusive cumsum of per-line virtual-line counts, so
// line ownership is monotonic: vline v belongs to the first line whose
// inclusive end exceeds v.  Dead lines (no vlines) repeat the previous end
// and are never chosen.  Padding vlines (v >= the total) get n_lines.

#pragma once

#include <cstdint>

// Upper bound over [lo, n_lines): the smallest i >= lo with
// vline_ends[i] > v, or n_lines.  One thread, ~log2(n_lines - lo)
// dependent loads.
static __device__ __forceinline__ int64_t owning_line(
    const int64_t* __restrict__ vline_ends, int64_t lo, int64_t n_lines,
    int64_t v) {
  int64_t hi = n_lines;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (vline_ends[mid] > v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

static __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Owner {
  int64_t line;   // owning line (n_lines for a padding vline)
  int64_t start;  // its exclusive vline start: vline_ends[line - 1], or 0
};

// owning_line for the 32 consecutive vlines v0 + lane of one warp, which
// every lane of the full warp calls together (v0 a multiple of 32).
//
// 1. The warp finds L0, the owner of v0, by a 32-ary search: each round
//    its lanes probe 32 evenly spaced ends and vote (`__ballot_sync`), so
//    294,724 lines take 4 rounds of loads, not ~19.
// 2. One coalesced load brings the window of ends of lines L0 - 1 ..
//    L0 + 30, held relative to v0 as int32 (clamped at 2^30: only ends
//    above v0 + 31 are clamped, and they only need to compare greater).
// 3. Each lane counts the window's ends <= its own vline by a binary search
//    over shuffles.  Lines own >= 1 vline unless dead, so without dead lines
//    the warp's vlines always fall inside the window; a lane whose vline lies
//    past it (a run of dead lines) finishes with `owning_line` from L0 + 31.
static __device__ __forceinline__ Owner warp_owning_line(
    const int64_t* __restrict__ vline_ends, int64_t n_lines, int64_t v0,
    int lane) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  constexpr int32_t kFar = 1 << 30;
  int64_t lo = 0, hi = n_lines;  // L0 lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = min64(lo + (lane + 1) * step, hi) - 1;
    const unsigned m = __ballot_sync(kAll, vline_ends[p] > v0);
    if (m == 0) {
      lo = hi;
    } else {
      // Probes before lane f are <= v0; lane f's is > v0.
      const int f = __ffs(m) - 1;
      const int64_t next_hi = min64(lo + (f + 1) * step, hi) - 1;
      lo = min64(lo + f * step, hi);
      hi = next_hi;
    }
  }
  const int64_t p = lo + lane;
  const unsigned m = __ballot_sync(kAll, p >= hi || vline_ends[p] > v0);
  const int64_t l0 = m ? lo + __ffs(m) - 1 : hi;

  const int64_t q = l0 - 1 + lane;
  const int32_t d =
      q < 0 ? (int32_t)-v0
            : (q < n_lines ? (int32_t)min64(vline_ends[q] - v0, kFar)
                           : kFar);
  // d of entry 0 (the end of line l0 - 1) is <= 0, so cnt >= 1.
  int cnt = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    if (__shfl_sync(kAll, d, cnt + s - 1) <= lane) cnt += s;
  }
  const int32_t d_last = __shfl_sync(kAll, d, 31);  // every lane shuffles
  if (cnt == 31 && d_last <= lane) cnt = 32;
  const int32_t start = __shfl_sync(kAll, d, cnt - 1);
  if (cnt < 32) return {l0 - 1 + cnt, v0 + start};
  const int64_t line = owning_line(vline_ends, l0 + 31, n_lines, v0 + lane);
  return {line, vline_ends[line - 1]};
}
