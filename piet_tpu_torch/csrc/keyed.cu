// Keyed sum of small integers: out[k, v] = sum of values[e, v] over the
// entries e with keys[e] == k; keys outside [0, n_out) drop.
//
// Replaces piet_tpu/ops/keyed.py::_keyed_kernel (the Pallas kernel behind
// keyed_sum).  Its callers sum integer values with |v| <= 256 (command
// counts 0/1/2, winding deltas +-1) and every sum stays below 2^24, so f32
// addition is exact in any order and atomics give the same bits as the
// JAX segment_sum.  Zero values are skipped: a slot starts at +0.0, a sum
// of nonzero integers is never -0.0, and x + (+-0.0) == x for every other
// x, so skipping them changes no bit -- a slot that receives only -0.0,
// or nothing, reads +0.0, as segment_sum gives.  Skipping also keeps the
// many dead records (value 0) from contending on one address.
//
// Bound on the H100: data movement (57,344 x 8 B read, 10,240 x 4 B
// written on the 1664^2 tiger).  The TPU kernel built a one-hot key-match
// matrix per block of keys and reduced it with a bf16 matmul, because its
// vector core has no scatter; here one thread per (entry, column) adds its
// value with atomicAdd into the output, which the wrapper zeroes.  The
// window bounds the TPU kernel needs (lo_bound/hi_bound) are not read.
#include "cmd_math.cuh"

namespace {

__global__ void keyed_kernel(const float* __restrict__ values,
                             const int* __restrict__ keys,
                             float* __restrict__ out, int n_entries,
                             int width, int n_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_entries * width) return;
  const int e = (int)(t / width);
  const int v = (int)(t - (long long)e * width);
  const int k = keys[e];
  if (k < 0 || k >= n_out) return;
  const float x = values[t];
  if (x == 0.0f) return;
  atomicAdd(out + (size_t)k * width + v, x);
}

}  // namespace

// values (n_entries, width) f32, keys (n_entries,) int32; out (n_out,
// width) f32 must hold zeros.
extern "C" int piet_keyed(const void* values, const void* keys, void* out,
                          int n_entries, int width, int n_out,
                          cudaStream_t stream) {
  const long long n = (long long)n_entries * width;
  if (n <= 0 || n_out <= 0) return 0;
  const int threads = 256;
  keyed_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                 stream>>>(
      static_cast<const float*>(values), static_cast<const int*>(keys),
      static_cast<float*>(out), n_entries, width, n_out);
  return (int)cudaGetLastError();
}
