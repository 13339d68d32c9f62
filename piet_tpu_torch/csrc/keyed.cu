// Keyed sums of small integers, up to two streams in one launch: for each
// stream s, out_s[k, v] = sum of vals_s[e, v] over the entries e with
// key_s[e] == k; keys outside [0, n_out) drop, and so do entries at or
// past the stream's live count when it has one.
//
// Replaces piet_tpu/ops/keyed.py::_keyed_kernel (the Pallas kernel behind
// keyed_sum).  Its callers sum integer values with |v| <= 256 (command
// counts 0/1/2, winding deltas +-1) and every sum stays below 2^24, so f32
// addition is exact in any order and atomics give the same bits as the
// JAX segment_sum.  Zero values are skipped: a slot starts at +0.0, a sum
// of nonzero integers is never -0.0, and x + (+-0.0) == x for every other
// x, so skipping them changes no bit -- a slot that receives only -0.0,
// or nothing, reads +0.0, as segment_sum gives.  Skipping also keeps the
// many dead records (value 0) from contending on one address.  A stream
// may sum into int32 instead (integer atomics of the exact integer
// values): the f32 sum converted by .to(int32) gives the same integers.
//
// Bound on the H100: data movement (the coarse pass reads two value and
// two key words of each of ~90k hit records and writes 2 x 10,240 words
// on the 1664^2 tiger), but a call this small is bound by its latency.
// The TPU kernel built a one-hot key-match matrix per block of keys and
// reduced it with a bf16 matmul, because its vector core has no scatter;
// here one thread per (entry, column) adds its values with atomics.  What
// cost time before was the number of device ops around the sums, so the
// coarse pass's two sums are one call: both streams read kernel B's
// (cap, 24) f32 records in place through a row stride (their four words
// share one 32-byte sector of the record), the key words are f32 exact
// integers converted as .to(int32) converts them (__float2int_rz), and the
// outputs share one allocation that the entry point zeroes with one
// cudaMemsetAsync before the one launch.  The window bounds the TPU kernel
// needs (lo_bound/hi_bound) are not read.
#include "cmd_math.cuh"

namespace {

constexpr int MAX_STREAMS = 2;

struct KeyedArgs {
  const float* vals[MAX_STREAMS];  // entry e, column v at e * val_stride + v
  const void* keys[MAX_STREAMS];   // entry e at e * key_stride
  const int* live[MAX_STREAMS];    // live entry count, or null: all live
  void* out;                       // stream s at s * n_out * width words
  int n_streams, n_entries, width, n_out, val_stride, key_stride;
  int key_f32;   // keys are f32 words holding exact integers, else int32
  int i32_mask;  // bit s: stream s sums into int32, else f32
};

__global__ void keyed_kernel(const KeyedArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)a.n_entries * a.width) return;
  const int e = (int)(t / a.width);
  const int v = (int)(t - (long long)e * a.width);
#pragma unroll
  for (int s = 0; s < MAX_STREAMS; ++s) {
    if (s >= a.n_streams) break;
    if (a.live[s] != nullptr && e >= *a.live[s]) continue;
    const float x = a.vals[s][(size_t)e * a.val_stride + v];
    if (x == 0.0f) continue;
    const size_t ke = (size_t)e * a.key_stride;
    const int k =
        a.key_f32 ? __float2int_rz(static_cast<const float*>(a.keys[s])[ke])
                  : static_cast<const int*>(a.keys[s])[ke];
    if (k < 0 || k >= a.n_out) continue;
    const size_t o = ((size_t)s * a.n_out + k) * a.width + v;
    if ((a.i32_mask >> s) & 1)
      atomicAdd(static_cast<int*>(a.out) + o, __float2int_rz(x));
    else
      atomicAdd(static_cast<float*>(a.out) + o, x);
  }
}

}  // namespace

// Stream s (s < n_streams <= 2) reads vals_s and keys_s with the shared
// strides (in 4-byte words) and, when live_s is not null, only the entries
// below *live_s.  out holds n_streams * n_out * width words; it is zeroed
// here, then one launch sums every stream into it.
extern "C" int piet_keyed(const void* vals0, const void* keys0,
                          const void* live0, const void* vals1,
                          const void* keys1, const void* live1, void* out,
                          int n_streams, int n_entries, int width, int n_out,
                          int val_stride, int key_stride, int key_f32,
                          int i32_mask, cudaStream_t stream) {
  if (n_streams < 1 || n_streams > MAX_STREAMS || width < 1 || n_out < 0 ||
      n_entries < 0)
    return (int)cudaErrorInvalidValue;
  const size_t out_words = (size_t)n_streams * n_out * width;
  if (out_words == 0) return 0;
  cudaError_t rc = cudaMemsetAsync(out, 0, out_words * 4, stream);
  if (rc != cudaSuccess) return (int)rc;
  const long long n = (long long)n_entries * width;
  if (n == 0) return 0;
  KeyedArgs a;
  a.vals[0] = static_cast<const float*>(vals0);
  a.vals[1] = static_cast<const float*>(vals1);
  a.keys[0] = keys0;
  a.keys[1] = keys1;
  a.live[0] = static_cast<const int*>(live0);
  a.live[1] = static_cast<const int*>(live1);
  a.out = out;
  a.n_streams = n_streams;
  a.n_entries = n_entries;
  a.width = width;
  a.n_out = n_out;
  a.val_stride = val_stride;
  a.key_stride = key_stride;
  a.key_f32 = key_f32;
  a.i32_mask = i32_mask;
  const int threads = 256;
  keyed_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                 stream>>>(a);
  return (int)cudaGetLastError();
}
