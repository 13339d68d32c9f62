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
//
// Pairing's compaction (piet_compact_rows; the TPU package ran it through
// the same _expand_kernel with 0/1 counts): the kept rows of an (E, 20)
// int32 bundle, in order, then all-zero rows.  A compaction needs no
// owner search: a kept row's slot is its rank among the kept rows.  Bound
// by bytes (each kept row read once, every output row written once:
// 1.8 + 5.4 MB at the tiger's 22,768 of 67,584 rows), and at that size
// by its latency.  Two launches, no op between them:
//
// - compact_count: each block of 512 rows counts its kept rows
//   (__syncthreads_count) into the scratch, and lets the second launch
//   start at once (programmatic dependent launch).
// - compact_rows: each block ranks its kept rows by a block scan of the
//   keep flags, listing them in shared memory by rank, while the counts
//   land; then waits for them, adds up the blocks before its own (at
//   most a few hundred words from L2), and copies each kept row to its
//   slot as five 16-byte loads and stores, neighbouring threads on
//   neighbouring words.  Its dead rows are zeros at the top of the
//   output: block b's dead_b slots end where the dead rows of the blocks
//   before it begin, at E - (dead rows before b), so no block waits for
//   the live total.  The last block writes the total after the counts.
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

constexpr int CROWS = 512;     // compaction: rows per block
constexpr int CTHREADS = 256;  // threads per block, 2 rows each
constexpr int ROW_VEC = 5;     // 16-byte words per row (20 int32)

// Programmatic dependent launch (Hopper), as in sort.cu.
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Block b's kept rows into kept[b].
__global__ void __launch_bounds__(CTHREADS)
compact_count(const unsigned char* __restrict__ keep, int n_rows,
              int* __restrict__ kept) {
  let_next_start();
  const int r = blockIdx.x * CROWS + threadIdx.x;
  const int c =
      __syncthreads_count(r < n_rows && keep[r] != 0) +
      __syncthreads_count(r + CTHREADS < n_rows && keep[r + CTHREADS] != 0);
  if (threadIdx.x == 0) kept[blockIdx.x] = c;
}

// The sum of v over the block (every thread gets it); red: a word a warp.
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < CTHREADS / 32; ++i) s += red[i];
  return s;
}

__global__ void __launch_bounds__(CTHREADS)
compact_rows(const int4* __restrict__ rows,
             const unsigned char* __restrict__ keep,
             const int* __restrict__ kept_of, int4* __restrict__ out,
             int* __restrict__ total, int n_rows) {
  __shared__ int slot[CROWS];  // the block's kept rows, by rank
  __shared__ int red[CTHREADS / 32];
  const int r0 = blockIdx.x * CROWS;
  const int n_here = min(CROWS, n_rows - r0);
  // This thread's two rows and their ranks in the block.
  const int i0 = 2 * threadIdx.x;
  const bool k0 = i0 < n_here && keep[r0 + i0] != 0;
  const bool k1 = i0 + 1 < n_here && keep[r0 + i0 + 1] != 0;
  const int c = (int)k0 + (int)k1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int rank = inc - c, kept = 0;
#pragma unroll
  for (int w = 0; w < CTHREADS / 32; ++w) {
    const int v = red[w];
    rank += w < warp ? v : 0;
    kept += v;
  }
  if (k0) slot[rank++] = i0;
  if (k1) slot[rank] = i0 + 1;
  // The kept rows of the blocks before this one: compact_count's.
  wait_prior();
  int p = 0;
  for (int i = threadIdx.x; i < blockIdx.x; i += CTHREADS) p += kept_of[i];
  __syncthreads();  // slot is complete, red free again
  const int prefix = block_sum(p, red);
  const int4* src = rows + (size_t)r0 * ROW_VEC;
  int4* dst = out + (size_t)prefix * ROW_VEC;
  for (int i = threadIdx.x; i < kept * ROW_VEC; i += CTHREADS) {
    const int k = i / ROW_VEC;
    dst[i] = src[slot[k] * ROW_VEC + (i - k * ROW_VEC)];
  }
  const int dead = n_here - kept;
  int4* zeros = out + (size_t)(n_rows - (r0 - prefix) - dead) * ROW_VEC;
  for (int i = threadIdx.x; i < dead * ROW_VEC; i += CTHREADS)
    zeros[i] = make_int4(0, 0, 0, 0);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    *total = prefix + kept;
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

// rows and out (n_rows, 20) int32, 16-byte aligned; keep (n_rows,) bytes,
// nonzero = kept; scratch ceil(n_rows / 512) + 1 int32: the blocks' kept
// counts, then the live total.
extern "C" int piet_compact_rows(const void* rows, const void* keep,
                                 void* scratch, void* out, int n_rows,
                                 cudaStream_t stream) {
  int* kept = static_cast<int*>(scratch);
  if (n_rows < 0 || (long long)n_rows * ROW_VEC * 4 >= 0x7FFFFFFFLL ||
      ((reinterpret_cast<size_t>(rows) | reinterpret_cast<size_t>(out)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaMemsetAsync(kept, 0, sizeof(int), stream);
  const int nb = (n_rows + CROWS - 1) / CROWS;
  const auto* k = static_cast<const unsigned char*>(keep);
  compact_count<<<nb, CTHREADS, 0, stream>>>(k, n_rows, kept);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Behind compact_count with programmatic stream serialization.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(CTHREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, compact_rows,
                           static_cast<const int4*>(rows), k,
                           static_cast<const int*>(kept),
                           static_cast<int4*>(out), kept + nb, n_rows);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
