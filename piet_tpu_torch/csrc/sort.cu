// Kernel C: bitonic sort of (f32 key, int32 index) pairs.
//
// Replaces piet_tpu/ops/sort.py::_sort_kernel (behind _sort_pallas and
// stable_sort_multi).  The record index rides in the comparison --
// (key, idx) lexicographic, idx unique -- so the order is total and the
// result equals a stable sort on the key alone.  The caller pads to a
// power of two (at least 2048) with (+inf, n, n+1, ...), as the JAX
// wrapper does.
//
// Bound on the H100: memory passes.  A network over 2^17 pairs has 153
// compare-exchange stages; every stage whose partner distance j is below
// 2048 stays inside one block's 16 KB of shared memory, so only the 21
// stages with j >= 2048 make a pass over device memory (1 MB each, L2
// resident).  28 launches per sort instead of 153.  The TPU kernel held
// the whole array in VMEM for all stages; no H100 block can hold 1 MB,
// hence the split.  A radix sort is later work.
#include "cmd_math.cuh"

namespace {

constexpr int LOCAL = 2048;      // elements per shared-memory block
constexpr int THREADS = LOCAL / 2;

__device__ __forceinline__ bool lex_lt(float ka, int ia, float kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// One compare-exchange of (i, l = i + j): ascending where (i & k) == 0.
__device__ __forceinline__ void ce(float* key, int* idx, int i, int l,
                                   bool asc) {
  const float ki = key[i], kl = key[l];
  const int ii = idx[i], il = idx[l];
  const bool swap = asc ? lex_lt(kl, il, ki, ii) : lex_lt(ki, ii, kl, il);
  if (swap) {
    key[i] = kl;
    key[l] = ki;
    idx[i] = il;
    idx[l] = ii;
  }
}

// Stages (k, j) for k in [k_lo, k_hi] and j < LOCAL, all in shared memory:
// k_lo = 2, k_hi = LOCAL sorts each block; k_lo = k_hi = k finishes the
// merge of size k after the global stages with j >= LOCAL.
__global__ void sort_local(float* __restrict__ key, int* __restrict__ idx,
                           int k_lo, int k_hi) {
  __shared__ float sk[LOCAL];
  __shared__ int si[LOCAL];
  const int base = blockIdx.x * LOCAL;
  for (int t = threadIdx.x; t < LOCAL; t += THREADS) {
    sk[t] = key[base + t];
    si[t] = idx[base + t];
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = min(k >> 1, LOCAL >> 1); j >= 1; j >>= 1) {
      const int t = threadIdx.x;
      const int i = 2 * j * (t / j) + (t % j);
      ce(sk, si, i, i + j, ((base + i) & k) == 0);
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < LOCAL; t += THREADS) {
    key[base + t] = sk[t];
    idx[base + t] = si[t];
  }
}

__global__ void sort_global(float* __restrict__ key, int* __restrict__ idx,
                            int n, int k, int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const int i = 2 * j * (t / j) + (t % j);
  ce(key, idx, i, i + j, (i & k) == 0);
}

}  // namespace

// Sorts key/idx (length n, a power of two >= LOCAL) in place.
extern "C" int piet_sort_f32_i32(void* key_p, void* idx_p, int n,
                                 cudaStream_t stream) {
  float* key = static_cast<float*>(key_p);
  int* idx = static_cast<int*>(idx_p);
  if (n < LOCAL || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int blocks = n / LOCAL;
  sort_local<<<blocks, THREADS, 0, stream>>>(key, idx, 2, LOCAL);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int k = 2 * LOCAL; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= LOCAL; j >>= 1) {
      sort_global<<<(n / 2 + 255) / 256, 256, 0, stream>>>(key, idx, n, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    sort_local<<<blocks, THREADS, 0, stream>>>(key, idx, k, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
