// Ragged expansion + row gather: out[p] = rows[src(p)].
//
// Replaces piet_tpu/ops/expand.py::_expand_kernel (the Pallas kernel
// behind expand_rows).  Source s owns counts[s] consecutive output slots
// starting at excl[s]; src(p) = #{s : excl[s] + counts[s] <= p}, so
// zero-count sources own nothing.  Slots at or past the live total,
// excl[n_src - 1] + counts[n_src - 1], get all-zero words.  Rows are any
// 32-bit payload and move as int32 words, never through a float register
// op: NaN payloads, -0.0 and denormal patterns keep their bits.
//
// Bound on the H100: data movement (the device-animation path expands
// (NI, 14) item rows into 49,152 x 14 words, 2.75 MB written), but a call
// this small is bound by its latency: a chain of dependent loads (the
// owner search, then the row) and one launch.  The TPU kernel built a
// banded one-hot matrix and gathered with a bf16 matmul (four 8-bit
// quarters per word), because its vector core has no gather.  Here, as in
// kernel B (hitfuse.cu), whose expansion this is without the tile tests:
//
// - A block of 128 slots finds the owners of its first and of its last
//   live slot once, each by a one-warp 32-way search (owner_search.cuh).
//   Each thread then binary-searches only the sources its block spans for
//   its own slot: one source when a source owns the whole block, a few
//   otherwise, zero-count sources among them owning nothing.
// - The block's 128 x words output words are staged in shared memory
//   (read row word by row word, neighbouring threads on neighbouring
//   words) and written out as one contiguous span of 16-byte stores; the
//   span is 512 x words bytes, so every block's span starts 16-byte
//   aligned.  Only the ragged last block (cap % 128 slots) may end in a
//   few 4-byte stores.
// - Blocks wholly at or past the live total write zeros the same way, with
//   no search and no row read.
// - The live total is read here, so the wrapper makes no device op of its
//   own: one launch per call.
#include "cmd_math.cuh"
#include "owner_search.cuh"

namespace {

constexpr int BLOCK = 128;    // slots per block
constexpr int STAGE = 4096;   // words staged at once: 128 slots of 32 words

// Store n words of src (shared memory, or zeros when src is null) to dst,
// both 16-byte aligned: 16-byte stores, then the tail word by word.
__device__ __forceinline__ void store_span(int* __restrict__ dst,
                                           const int* src, int n) {
  const int n4 = n >> 2;
  int4* d4 = reinterpret_cast<int4*>(dst);
  const int4* s4 = reinterpret_cast<const int4*>(src);
  for (int i = threadIdx.x; i < n4; i += BLOCK)
    d4[i] = src ? s4[i] : make_int4(0, 0, 0, 0);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += BLOCK)
    dst[i] = src ? src[i] : 0;
}

__global__ void __launch_bounds__(BLOCK)
expand_kernel(const int* __restrict__ rows, const int* __restrict__ counts,
              const int* __restrict__ excl, int* __restrict__ out,
              int n_src, int words, int cap) {
  __shared__ __align__(16) int stage[STAGE];
  __shared__ int own[BLOCK];   // each slot's source, -1 past the total
  __shared__ int span[2];
  const int p0 = blockIdx.x * BLOCK;
  const int n_slot = min(BLOCK, cap - p0);
  const int n_words = n_slot * words;
  const int total = excl[n_src - 1] + counts[n_src - 1];
  int* dst = out + (size_t)p0 * words;
  if (p0 >= total) {  // wholly dead: zeros, coalesced
    store_span(dst, nullptr, n_words);
    return;
  }
  // The sources of the block's first and last live slots.
  if (threadIdx.x < 64) {
    const int wp = threadIdx.x < 32 ? p0 : min(p0 + n_slot, total) - 1;
    const int s = warp_search(counts, excl, n_src, wp);
    if ((threadIdx.x & 31) == 0) span[threadIdx.x >> 5] = s;
  }
  __syncthreads();
  if (threadIdx.x < n_slot) {
    const int p = p0 + threadIdx.x;
    int lo = -1;
    if (p < total) {
      lo = span[0];
      int hi = span[1];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (excl[mid] + counts[mid] > p) hi = mid; else lo = mid + 1;
      }
      // Clamped to the last source, as the plain version's owner.
      lo = min(lo, n_src - 1);
    }
    own[threadIdx.x] = lo;
  }
  __syncthreads();
  for (int base = 0; base < n_words; base += STAGE) {
    const int n = min(STAGE, n_words - base);
    for (int i = threadIdx.x; i < n; i += BLOCK) {
      const int j = base + i;
      const int s = j / words;
      const int o = own[s];
      stage[i] = o >= 0 ? rows[(size_t)o * words + (j - s * words)] : 0;
    }
    __syncthreads();
    store_span(dst + base, stage, n);
    __syncthreads();  // the stage is refilled next round
  }
}

}  // namespace

// rows (n_src, words) and out (cap, words) are int32 words, out 16-byte
// aligned; counts and excl (n_src,) int32.
extern "C" int piet_expand(const void* rows, const void* counts,
                           const void* excl, void* out, int n_src, int words,
                           int cap, cudaStream_t stream) {
  if ((long long)cap * words <= 0) return 0;
  if (n_src <= 0 || (reinterpret_cast<size_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  expand_kernel<<<(cap + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      static_cast<const int*>(rows), static_cast<const int*>(counts),
      static_cast<const int*>(excl), static_cast<int*>(out), n_src, words,
      cap);
  return (int)cudaGetLastError();
}
