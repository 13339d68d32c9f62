// The coarse pass's dense tail: the sorted entry records -> each tile's
// command list of cap slots, (T, cap) tags and (T, cap * 12) operand words,
// with its command count, overflow and bail colour.  One launch, one block
// a tile.
//
// Replaces no TPU kernel: the JAX package computes this tail with XLA ops
// (piet_tpu/ops/coarse.py, the dense output), and the port's plain version
// is ops/coarse.py::_dense_ptcl, which runs for CPU tensors.  Run on the
// card, that version is ~143 device ops a frame: per-tile f32 index maxima
// by a contended scatter_reduce, a global scan, a zero-filled
// (T * cap + 1, 13) scratch written by two index scatters and copied into
// tags and args by two strided copies.
//
// Bound on the H100: the bytes written.  Every slot is written once, 52
// bytes (a tag and 12 operand words; 81.5 MB on the 4K tiger, 2,040 tiles
// of 768 slots), and each live entry's 64-byte record is read about once:
// 0.026 ms on the tiger at 3.35 TB/s.  What the design does about it: no
// scratch, no copy, no atomics.  The sort leaves each tile's entries one
// contiguous run (e_tile is non-decreasing, the dead entries last at tile
// n_tiles), so a block finds its tile's run by two warp searches and
// reduces, scans and writes it alone:
//
// - the last opaque and the last clearing entry: a block maximum of the
//   indices (the plain version's f32 maxima, -1 and -2 where none);
// - the bail (the last clearing entry before the last opaque one), the
//   bail colour, the first kept entry (the last opaque one, else the
//   first);
// - each kept entry's command position: a block scan of the meta words'
//   command counts from the first kept entry, 256 entries a step; slot 0
//   at the position, slot 1 (a hit record's Fill behind its FillEdge) just
//   after, each dropped at or past cap, three 16-byte stores a slot;
// - then every slot from the tile's count to cap is zeroed, in 16-byte
//   evict-first stores (nothing of the frame reads them).
//
// The output is word for word the plain version's: a record's command
// count (meta bits 0-1) is the number of its valid slots, as kernel B and
// the candidate rows write it, so the kept slots are exactly [0, count)
// (tests/test_torch_dense_tail.py holds these facts on the CPU and the
// kernel against the plain version on the card).
#include "cmd_math.cuh"
#include "owner_search.cuh"

namespace {

using namespace piet;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int W_META = 14;  // layout/entry_stream.py
constexpr int META_NCMDS_MASK = 3, META_OPAQUE_BIT = 4;
constexpr int SLOT_INT4 = 3;  // a slot's 12 operand words

struct TailArgs {
  const int* rows;        // (n_entries, 16) sorted records, dead rows zero
  const int* sorted_idx;  // (n_entries,) source row: < max_hits a hit
  const int* e_tile;      // (n_entries,) non-decreasing, dead = n_tiles
  const int* color_bits;  // candidate c's colour bits at c * color_stride
  int* tags;              // (n_tiles, cap)
  int* args;              // (n_tiles, cap * 12)
  int* counts;            // (n_tiles,) commands kept, at most cap
  int* solid;             // (n_tiles,) bail colour, -1 bail without one
  int* overflow;          // (n_tiles,) commands dropped past cap
  int n_entries, n_tiles, cap, max_hits, color_stride;
};

// The meta word of entry e: an integer-valued f32, converted as
// .to(int32) converts it.
__device__ __forceinline__ int meta_of(const int* rows, int e) {
  return (int)__int_as_float(__ldg(rows + (size_t)e * ENTRY_WORDS + W_META));
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Entry e's commands from slot pos of tile t: slot 0 (its tail command
// or FillEdge/Line, else its Fill) and, for a hit record with both, its
// Fill at pos + 1, each only below cap.
__device__ void write_entry(const TailArgs& a, int t, int e, int pos) {
  const int4* r = reinterpret_cast<const int4*>(a.rows) + (size_t)e * 4;
  const int4 q0 = __ldg(r), q1 = __ldg(r + 1), q2 = __ldg(r + 2),
             q3 = __ldg(r + 3);  // words 0-3, 4-7, 8-11, 12-15
  const bool hit = __ldg(a.sorted_idx + e) < a.max_hits;
  const int tag0 = (int)__int_as_float(q0.x);
  const bool s0 = tag0 != 0;
  const bool s1 = hit && __int_as_float(q2.x) == (float)CMD_FILL;
  const int4 z = make_int4(0, 0, 0, 0);
  // Slot 1's Fill: words 9-13.
  const int4 f0 = make_int4(q2.y, q2.z, q2.w, q3.x);
  const int4 f1 = make_int4(q3.y, 0, 0, 0);
  const size_t slot = (size_t)t * a.cap + pos;
  int4* dst = reinterpret_cast<int4*>(a.args) + slot * SLOT_INT4;
  if (s0) {
    // Words 1-12; a hit record's slot 0 has 7 operand words.
    a.tags[slot] = tag0;
    dst[0] = make_int4(q0.y, q0.z, q0.w, q1.x);
    dst[1] = make_int4(q1.y, q1.z, q1.w, hit ? 0 : q2.x);
    dst[2] = hit ? z : make_int4(q2.y, q2.z, q2.w, q3.x);
    if (s1 && pos + 1 < a.cap) {
      a.tags[slot + 1] = CMD_FILL;
      dst[3] = f0;
      dst[4] = f1;
      dst[5] = z;
    }
  } else if (s1) {
    a.tags[slot] = CMD_FILL;
    dst[0] = f0;
    dst[1] = f1;
    dst[2] = z;
  }
}

// The commands of tile t's entries [begin, end), at the positions a scan
// of their command counts gives; returns the commands there.
__device__ int write_commands(const TailArgs& a, int t, int begin, int end,
                              int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = begin; base < end; base += THREADS) {
    const int e = base + threadIdx.x;
    const int n = e < end ? (meta_of(a.rows, e) & META_NCMDS_MASK) : 0;
    int x = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int s = warp_sums[w];
      before += w < warp ? s : 0;
      chunk += s;
    }
    __syncthreads();
    const int pos = carry + before + x - n;
    carry += chunk;
    if (n > 0 && pos < a.cap) write_entry(a, t, e, pos);
  }
  return carry;
}

__global__ void __launch_bounds__(THREADS) dense_tail_kernel(
    const TailArgs a) {
  __shared__ int s_bounds[2];
  __shared__ int s_red[2][WARPS];
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The tile's entries [first, end): warp 0 finds its first, warp 1 the
  // next tile's.
  if (warp < 2) {
    const int b = warp_lower_bound(a.e_tile, a.n_entries, t + warp);
    if (lane == 0) s_bounds[warp] = b;
  }
  __syncthreads();
  const int first = s_bounds[0], end = s_bounds[1];

  // Its last opaque and last clearing entries (-1, -2: none).
  int opq = -1, clr = -2;
  for (int e = first + tid; e < end; e += THREADS) {
    const int m = meta_of(a.rows, e);
    if (m & META_OPAQUE_BIT) opq = e;
    if (m & META_CLEAR_BIT) clr = e;
  }
  opq = warp_max(opq);
  clr = warp_max(clr);
  if (lane == 0) {
    s_red[0][warp] = opq;
    s_red[1][warp] = clr;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    opq = max(opq, s_red[0][w]);
    clr = max(clr, s_red[1][w]);
  }
  __syncthreads();

  // A tile bails where its last clearing entry comes before its last
  // opaque one (an empty tile too); else it keeps the commands from the
  // last opaque entry on, or all.
  const bool bail = clr < opq;
  const int total =
      bail ? 0 : write_commands(a, t, opq >= 0 ? opq : first, end, s_red[0]);
  const int count = min(total, a.cap);
  int* trow = a.tags + (size_t)t * a.cap;
  for (int i = count + tid; i < a.cap; i += THREADS) __stcs(trow + i, 0);
  int4* arow = reinterpret_cast<int4*>(a.args) + (size_t)t * a.cap * SLOT_INT4;
  const int4 z = make_int4(0, 0, 0, 0);
  for (int i = count * SLOT_INT4 + tid; i < a.cap * SLOT_INT4; i += THREADS)
    __stcs(arow + i, z);
  if (tid == 0) {
    int colour = 0;
    if (bail && opq >= 0) {
      const int c = max(__ldg(a.sorted_idx + opq) - a.max_hits, 0);
      colour = __ldg(a.color_bits + (size_t)c * a.color_stride);
    } else if (bail) {
      colour = -1;
    }
    a.counts[t] = count;
    a.overflow[t] = max(total - a.cap, 0);
    a.solid[t] = colour;
  }
}

}  // namespace

// rows (n_entries, 16) int32, 16-byte aligned; sorted_idx and e_tile
// (n_entries,) int32; color_bits the candidates' colour bits, color_stride
// words apart (a column of the candidate rows); tags
// (n_tiles, cap) and args (n_tiles, cap * 12) int32, args 16-byte aligned;
// counts, solid and overflow (n_tiles,) int32.  Every output word is
// written.
extern "C" int piet_dense_tail(const void* rows, const void* sorted_idx,
                               const void* e_tile, const void* color_bits,
                               void* tags, void* args, void* counts,
                               void* solid, void* overflow, int n_entries,
                               int n_tiles, int cap, int max_hits,
                               int color_stride, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (n_entries <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const TailArgs a = {static_cast<const int*>(rows),
                      static_cast<const int*>(sorted_idx),
                      static_cast<const int*>(e_tile),
                      static_cast<const int*>(color_bits),
                      static_cast<int*>(tags),
                      static_cast<int*>(args),
                      static_cast<int*>(counts),
                      static_cast<int*>(solid),
                      static_cast<int*>(overflow),
                      n_entries,
                      n_tiles,
                      cap,
                      max_hits,
                      color_stride};
  dense_tail_kernel<<<n_tiles, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
