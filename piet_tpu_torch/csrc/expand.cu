// Ragged expansion + row gather: out[p] = rows[src(p)].
//
// Replaces piet_tpu/ops/expand.py::_expand_kernel (the Pallas kernel
// behind expand_rows).  Source s owns counts[s] consecutive output slots
// starting at excl[s]; src(p) = #{s : excl[s] + counts[s] <= p}, so
// zero-count sources own nothing.  Slots at or past the live total get
// all-zero words.  Rows are any 32-bit payload and move as int32 words,
// never through a float register op: NaN payloads, -0.0 and denormal
// patterns keep their bits.
//
// Bound on the H100: data movement (the device-animation path expands
// (NI, 14) item rows into 49,152 x 14 words, 2.75 MB written).  The TPU
// kernel built a banded one-hot matrix and gathered with a bf16 matmul
// (four 8-bit quarters per word), because its vector core has no gather;
// here one thread per (slot, word) binary-searches the slot's owner over
// the inclusive offsets (held in L1/L2) and copies one word, so
// neighbouring threads write neighbouring words.
#include "cmd_math.cuh"

namespace {

__global__ void expand_kernel(const int* __restrict__ rows,
                              const int* __restrict__ counts,
                              const int* __restrict__ excl,
                              const int* __restrict__ total_p,
                              int* __restrict__ out, int n_src, int words,
                              int cap) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)cap * words) return;
  const int p = (int)(t / words);
  const int w = (int)(t - (long long)p * words);
  int v = 0;
  if (p < *total_p) {
    // Owner: the first source whose inclusive offset exceeds p.
    int lo = 0, hi = n_src;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (excl[mid] + counts[mid] > p) hi = mid; else lo = mid + 1;
    }
    lo = min(lo, n_src - 1);
    v = rows[(size_t)lo * words + w];
  }
  out[t] = v;
}

}  // namespace

// rows (n_src, words) and out (cap, words) are int32 words; total holds
// the live slot count (excl[-1] + counts[-1]) on the device.
extern "C" int piet_expand(const void* rows, const void* counts,
                           const void* excl, const void* total, void* out,
                           int n_src, int words, int cap,
                           cudaStream_t stream) {
  const long long n = (long long)cap * words;
  if (n <= 0) return 0;
  if (n_src <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  expand_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  stream>>>(
      static_cast<const int*>(rows), static_cast<const int*>(counts),
      static_cast<const int*>(excl), static_cast<const int*>(total),
      static_cast<int*>(out), n_src, words, cap);
  return (int)cudaGetLastError();
}
