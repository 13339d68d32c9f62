// The coarse pass's entries tail: the sorted entry stream -> each entry's
// W_RUN run word, and each tile's first live entry, live entries, live
// commands and bail colour.  One launch, one block a tile.
//
// Replaces no TPU kernel: the JAX package computes this tail with XLA ops
// (piet_tpu/ops/coarse.py, the entries output), and the port's plain
// version is ops/entries_tail.py::entries_tail_plain, which runs for CPU
// tensors.  Run on the card, that version is ~130 device ops a frame: two
// flips and a cummin for the run words, a searchsorted for the tile
// ranges, a global cumsum of the command counts, two cummax scans for the
// last opaque and the last clearing entry, and the gathers, selects and
// concatenations between them (0.63 ms of the 4K tiger's 1.20 ms entries
// frame).
//
// Bound on the H100: the bytes.  Each live entry's two tag words and meta
// word are read (words 0, 8 and 14: both 32-byte sectors of its row) and
// its run word written (one sector), each dead entry's run word written,
// the tiles read and four words a tile written: 5.1 MB at the 4K tiger
// (57,856 rows, 45,892 live, 2,040 tiles), 0.0015 ms at 3.35 TB/s.  What
// the design does about it: one pass, no scratch, no global scan, no
// atomics.  The sort leaves each tile's entries one contiguous run (e_tile
// is non-decreasing, the dead entries last at tile n_tiles), so a block
// finds its tile's run by two warp searches and does the rest alone:
//
// - the run words (unpaired streams only; a paired stream keeps its
//   words): chunks of 256 entries from the run's end backwards, each
//   entry's class (plain fill, line, other) from its tags, the next class
//   boundary after it by a block suffix minimum, carried from chunk to
//   chunk; streaks never cross a tile, so no block needs another's data;
// - in the same pass, the last opaque and the last clearing entry, by a
//   block maximum of the indices (-1 and -2 where none);
// - the bail (the last clearing entry before the last opaque one; an
//   empty tile bails), the bail colour (the opaque entry's W_BAIL word),
//   and the commands kept: a block sum of the meta words' command counts
//   from the first kept entry (the last opaque one, else the first);
// - the dead rows' run words are zeroed, spread over every block.
//
// The output is word for word the plain version's: its run-word keys,
// class * (n_tiles + 1) + tile in f32, are exact where 3 * (n_tiles + 1)
// <= 2^24 (the wrapper checks it), so its boundaries are the changes of
// (class, tile) that the block finds inside its tile, and a length is at
// most RUN_CAP, exact as f32; its differences of a global int32 cumsum are
// the sums within a tile; and its per-tile chain of selects is written out
// below as it stands (tests/test_torch_entries_tail.py: a numpy model of
// this kernel against the plain version on the CPU, the kernel against
// the plain version on the card).
#include "cmd_math.cuh"
#include "owner_search.cuh"

namespace {

using namespace piet;

constexpr int THREADS = 256;  // also the entries of a run-word chunk
constexpr int WARPS = THREADS / 32;
// layout/entry_stream.py
constexpr int W_BAIL = 13, W_META = 14, W_RUN = 15, RUN_CAP = 4096;
constexpr int META_NCMDS_MASK = 3, META_OPAQUE_BIT = 4;
constexpr int NO_BOUNDARY = 0x7fffffff;

struct TailArgs {
  int* rows;          // (n_entries, 16) sorted entries; W_RUN written
  const int* e_tile;  // (n_entries,) non-decreasing, dead = n_tiles
  int* first;         // (n_tiles,) first live entry, 0 where none
  int* n_live;        // (n_tiles,) live entries
  int* counts;        // (n_tiles,) live commands
  int* solid;         // (n_tiles,) bail colour, -1 bail without one, 0 none
  int n_entries, n_tiles, run_words;
};

// Word w of entry e.  Plain loads: the kernel writes the rows' W_RUN words.
__device__ __forceinline__ int word(const int* rows, int e, int w) {
  return rows[(size_t)e * ENTRY_WORDS + w];
}

// The meta word of entry e: an integer-valued f32, converted as
// .to(int32) converts it.
__device__ __forceinline__ int meta_of(const int* rows, int e) {
  return (int)__int_as_float(word(rows, e, W_META));
}

// Entry e's run class: 1 a plain fill (slot 0 empty, slot 1 a Fill), 2 a
// line (slot 0 a Line, slot 1 empty), 0 any other; f32 compares of the
// tag words, as the plain version makes them.
__device__ __forceinline__ int run_class(const int* rows, int e) {
  const float t0 = __int_as_float(word(rows, e, W_S0_TAG));
  const float t1 = __int_as_float(word(rows, e, W_S1_TAG));
  if (t0 == 0.0f && t1 == (float)CMD_FILL) return 1;
  if (t0 == (float)CMD_LINE && t1 == 0.0f) return 2;
  return 0;
}

// The block's maxima of u and v, in place (every thread gets them).
__device__ void block_max2(int& u, int& v, int (*s_warp2)[WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    u = max(u, __shfl_xor_sync(FULL, u, o));
    v = max(v, __shfl_xor_sync(FULL, v, o));
  }
  if (lane == 0) {
    s_warp2[0][warp] = u;
    s_warp2[1][warp] = v;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    u = max(u, s_warp2[0][w]);
    v = max(v, s_warp2[1][w]);
  }
  __syncthreads();
}

// The block's sum of v (every thread gets it).
__device__ int block_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) v += s_warp[w];
  __syncthreads();
  return v;
}

// The minimum of v over threads [threadIdx.x, THREADS) of the block, and
// in all_min the minimum over the whole block.
__device__ int block_suffix_min(int v, int* s_warp, int& all_min) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v = min(v, y);
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int later = NO_BOUNDARY;
  all_min = NO_BOUNDARY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int s = s_warp[w];
    if (w > warp) later = min(later, s);
    all_min = min(all_min, s);
  }
  __syncthreads();
  return min(v, later);
}

__global__ void __launch_bounds__(THREADS) entries_tail_kernel(
    const TailArgs a) {
  __shared__ int s_bounds[3];
  __shared__ int s_warp[WARPS];
  __shared__ int s_warp2[2][WARPS];
  __shared__ int s_cls[THREADS];
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The tile's entries [first, end): warp 0 finds its first, warp 1 the
  // next tile's, warp 2 the first dead entry's.
  if (warp < 3) {
    const int key = warp == 2 ? a.n_tiles : t + warp;
    const int b = warp_lower_bound(a.e_tile, a.n_entries, key);
    if (lane == 0) s_bounds[warp] = b;
  }
  __syncthreads();
  const int first = s_bounds[0], end = s_bounds[1], dead = s_bounds[2];

  // The dead entries' run words are 0: a grid-strided share of them.
  if (a.run_words) {
    for (int e = dead + t * THREADS + tid; e < a.n_entries;
         e += gridDim.x * THREADS)
      a.rows[(size_t)e * ENTRY_WORDS + W_RUN] = 0;
  }

  // Chunks [lo, hi) from the end backwards.  Carried from the later
  // chunk: the class of its first entry (-1 where the tile ends there)
  // and the first class boundary after that entry.
  int opq = -1, clr = -2;
  int next_cls = -1, next_b = end;
  for (int hi = end; hi > first; hi -= THREADS) {
    const int lo = max(first, hi - THREADS);
    const int e = lo + tid;
    const bool in = e < hi;
    int cls = -1;
    if (in) {
      const int m = meta_of(a.rows, e);
      if (m & META_OPAQUE_BIT) opq = max(opq, e);
      if (m & META_CLEAR_BIT) clr = max(clr, e);
      if (a.run_words) cls = run_class(a.rows, e);
    }
    if (a.run_words) {
      s_cls[tid] = cls;
      __syncthreads();
      // A boundary at e + 1 where the class changes there (the tile's end
      // is one: next_cls -1 differs from every class).
      const int after = e + 1 < hi ? s_cls[tid + 1] : next_cls;
      const int v = in && after != cls ? e + 1 : NO_BOUNDARY;
      int chunk_min;
      const int nb = min(block_suffix_min(v, s_warp, chunk_min), next_b);
      if (in) {
        const int len = min(nb - e, RUN_CAP);
        const float w = cls == 1 ? (float)len : cls == 2 ? -(float)len : 0.0f;
        a.rows[(size_t)e * ENTRY_WORDS + W_RUN] = __float_as_int(w);
      }
      next_b = min(chunk_min, next_b);
      next_cls = s_cls[0];
      __syncthreads();
    }
  }
  block_max2(opq, clr, s_warp2);

  // A tile bails where its last clearing entry comes before its last
  // opaque one (an empty tile too); else it keeps the commands from the
  // last opaque entry on, or all.
  const bool bail = clr < opq;
  int total = 0;
  if (!bail) {
    const int begin = opq >= 0 ? opq : first;
    for (int e = begin + tid; e < end; e += THREADS)
      total += meta_of(a.rows, e) & META_NCMDS_MASK;
    total = block_sum(total, s_warp);
  }
  if (tid == 0) {
    const bool has = end > first;
    // The plain version's first entry: clamped to E - 1 where none.
    int first_live = opq >= 0 ? opq : has ? first : a.n_entries - 1;
    const int n = bail ? 0 : end - first_live;
    if (n <= 0) first_live = 0;
    a.first[t] = first_live;
    a.n_live[t] = n;
    a.counts[t] = bail ? 0 : total;
    a.solid[t] = !bail ? 0 : opq >= 0 ? word(a.rows, opq, W_BAIL) : -1;
  }
}

}  // namespace

// rows (n_entries, 16) int32, the sorted entries with e_tile's order;
// e_tile (n_entries,) int32, non-decreasing, the dead entries at n_tiles;
// first, n_live, counts and solid (n_tiles,) int32, every word written.
// run_words 1 writes every row's W_RUN word in place; 0 (a paired stream)
// leaves the rows as they are.
extern "C" int piet_entries_tail(void* rows, const void* e_tile, void* first,
                                 void* n_live, void* counts, void* solid,
                                 int n_entries, int n_tiles, int run_words,
                                 cudaStream_t stream) {
  if (n_entries <= 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  const TailArgs a = {static_cast<int*>(rows),
                      static_cast<const int*>(e_tile),
                      static_cast<int*>(first),
                      static_cast<int*>(n_live),
                      static_cast<int*>(counts),
                      static_cast<int*>(solid),
                      n_entries,
                      n_tiles,
                      run_words};
  entries_tail_kernel<<<n_tiles, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
