// The owner search of the ragged expansions: slot p of an expansion
// belongs to the first source s whose inclusive cumsum excl[s] + counts[s]
// exceeds p, so sources with a zero count own nothing.  Kernel B
// (hitfuse.cu: records over segments) and expand (expand.cu: slots over
// source rows) both take it the same way: one warp per end of a block of
// slots finds the owners of the block's first and last live slot, and each
// thread then binary-searches only that span, a few sources in lines the
// block already has in L1.  The tails' lower bound over the sorted
// entries' tiles lives here too.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

// The first source in [0, n_src) whose inclusive cumsum exceeds p (n_src
// when none), by one warp: each step probes 32 evenly spaced sources of
// the range left and keeps the gap after the last probe that does not
// exceed p (about four dependent loads over 2^16 sources).  Every lane
// returns the answer.
__device__ int warp_search(const int* __restrict__ counts,
                           const int* __restrict__ excl, int n_src, int p) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n_src;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    // Probes at or past hi count as exceeding p (the answer is <= hi).
    const bool gt = q >= hi || excl[q] + counts[q] > p;
    const unsigned m = __ballot_sync(FULL, gt);
    const int f = m ? __ffs(m) - 1 : 32;  // the first exceeding probe
    if (f == 0) break;                    // the answer is lo
    const int q_last = lo + (f - 1) * step;
    lo = q_last + 1;
    if (f < 32) hi = min(hi, lo + step - 1);
  }
  return lo;
}

// The first index of the non-decreasing v[0, n) whose value is at least
// key (n if none), by one warp: each step probes 32 evenly spaced entries
// of the remaining range [lo, hi], so n entries take about log32(n)
// loads.  The sorted entries' tile runs (dense_tail.cu, entries_tail.cu)
// take it.  Every lane returns the answer.
__device__ int warp_lower_bound(const int* v, int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;
    const unsigned ge = __ballot_sync(FULL, p >= hi || __ldg(v + p) >= key);
    if (ge == 0) return hi;  // lane 31 probed hi - 1
    const int k = __ffs(ge) - 1;
    hi = min(lo + (k + 1) * step - 1, hi);
    lo += k * step;
  }
  return lo;
}

}  // namespace
