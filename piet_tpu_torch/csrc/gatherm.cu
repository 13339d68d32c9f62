// Row gather for K index streams in one launch: out[k, p] = rows[idx[k, p]].
//
// Replaces piet_tpu/ops/gatherm.py::_make_kernel (the Pallas kernel
// behind gather_monotone).  Rows are any 32-bit payload and move as int32
// words.  Indices are clamped into [0, n_rows), as a JAX gather clamps.
//
// Bound on the H100: data movement (on the device-animation path, two
// streams of 49,152 points, 0.79 MB written, and one stream of 10,240 csum
// words).  The TPU kernel needed the indices nondecreasing: it walked one
// source window per block of slots and gathered with a one-hot bf16
// matmul, because its vector core has no gather.  A GPU thread loads any
// address, so here one thread per (stream, slot, word) copies one word;
// monotone indices only make neighbouring threads read neighbouring rows.
#include "cmd_math.cuh"

namespace {

__global__ void gatherm_kernel(const int* __restrict__ rows,
                               const int* __restrict__ idx,
                               int* __restrict__ out, int n_rows, int words,
                               long long n_slots_all) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_slots_all * words) return;
  const long long kp = t / words;
  const int w = (int)(t - kp * words);
  const int i = min(max(idx[kp], 0), n_rows - 1);
  out[t] = rows[(size_t)i * words + w];
}

}  // namespace

// rows (n_rows, words) int32 words; idx (n_streams, n_slots) int32;
// out (n_streams, n_slots, words) int32 words.
extern "C" int piet_gatherm(const void* rows, const void* idx, void* out,
                            int n_rows, int words, int n_streams,
                            int n_slots, cudaStream_t stream) {
  const long long slots = (long long)n_streams * n_slots;
  const long long n = slots * words;
  if (n <= 0) return 0;
  if (n_rows <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  gatherm_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                   stream>>>(
      static_cast<const int*>(rows), static_cast<const int*>(idx),
      static_cast<int*>(out), n_rows, words, slots);
  return (int)cudaGetLastError();
}
