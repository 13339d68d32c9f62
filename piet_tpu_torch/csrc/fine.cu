// Kernel D: the entry-stream fine rasterizer.
//
// Replaces piet_tpu/ops/fine.py::_fine_entries_kernel (behind
// fine_rasterize_entries).  Tile t owns the sorted entries
// [first[t], first[t] + n[t]) of the (E, 16) f32 stream; each entry is
// applied to every pixel of the tile in stream order, in the order of the
// JAX kernel's accum_entry: slot-0 line (squared distance min), slot-0
// fill edge, slot-1 fill, then the resolve classes (circle, stroke, draw
// fill, solid) and the clip/layer group, gradient and wind commands.  An
// empty tile writes its present colour (the bail solid's bytes, or
// white), then the polynomial sRGB encode packs RGBA8.
//
// Bound on the H100: per-pixel f32 work, ~15-40 operations per entry and
// pixel, each rounded on its own (-fmad=false), sequential along the entry
// list (painter's order is a data dependency).  Beside them a fill runs
// about as many compares, selects and min/max on the ALU pipe, which runs
// at half the f32 rate and is what bounds the kernel on the tiger (by the
// SASS opcode counts in PERF.md); cmd_math.cuh gives the NaN-propagating
// clamps one instruction each where that is exact.  The design spends as
// little as it can on anything else:
//
// - A block is a band of a tile, each thread R neighbouring pixels of one
//   row (fine_common.cuh: R = 8 on tiles 64 pixels wide or more, 4 below;
//   at 128 x 32 tiles 16 x 8 threads, a 128 x 8 band, four blocks per
//   tile), all R pixels' state (r, g, b, squared distance field, area) in
//   registers.  Each entry's tag and operands are read and dispatched once
//   per R pixels, and every term that depends on the row alone is computed
//   once for them: a fill's clamped row span and its slope terms, about a
//   third of its operations, and all of a fill edge's.  A tile's bands run
//   on several SMs at once; one 512-thread block per tile, which would
//   read the entries once, measured slower (PERF.md): a dense tile then
//   holds one SM alone.
// - Entries are staged through shared memory in chunks of 32 x 64 B with
//   cp.async, double-buffered, so the next chunk lands while the current
//   one is interpreted; a thread reads an entry as four 16-byte words.
// - No stacks until needed: the block interprets its entries on a state
//   without stacks, all in registers, and without the clip-coverage
//   multiply until it meets its first begin/end clip or layer (tags
//   10-13; the tiger has none).  There it copies the state into one with
//   the stacks (coverage 1, saved planes 1, as the JAX kernel starts
//   them; in local memory, since a stack is indexed by its depth) and
//   goes on with the stack path from that entry.  Before a group command
//   the coverage is cov[0] == 1, and alpha * 1 == alpha on every f32, so
//   both paths give the same bits.  fine_dense.cu does the same; one
//   state type with the stacks from the start kept the whole state in
//   local memory there (PERF.md).
// - Run dispatch: the W_RUN word of a plain-fill or line entry holds the
//   remaining length of its streak of same-class entries in the tile;
//   the streak runs in a loop without tag checks, in stream order.
// - Dense tiles first (fine_common.cuh's tile_order, a second launch).
//
// The paired instantiation (kPaired, ``paired`` != 0) reads a paired
// stream (ops/pairing.py), which carries no W_RUN words.  It finds its
// streaks from the staged tags instead, as fine_dense.cu does: a run of
// fill entries (slot 0 empty or a fill, slot 1 a fill) or of line
// entries (slot 0 a line, slot 1 empty or a line) runs in a tight loop
// that reads only the next entry's two tag words from shared memory and
// only the operand words its class uses.  An all-zero hole entry matches
// no class and changes nothing, so it joins either streak and costs its
// two tag reads.  (Four other loops measured no better, PERF.md: the
// next entry's tags read ahead of the current entry's work, 0-2% slower;
// one bit an entry and class per chunk from a warp's tag reads, the
// streak run over its bits: holes 1-5% cheaper, compact streams 2-3%
// slower at 127 registers a thread, the same as this loop at 96 under a
// 5-block bound; those bits walked in order, slower still; runs of F2
// or L2 entries from such bits as counted loops, 3-13% slower at 127
// registers.)  An F2 entry (a fill in each slot) applies its slot-0
// fill before its slot-1 fill, the oracle's order of the area adds; an
// L2 entry's slot-1 line holds [sx, sy, ex, ey, inv_denom] in slot-1
// words 0-4 and is read with word 5 taken from word 4.  Every other
// entry (fill edges, resolves, group commands) is dispatched on its tags
// by apply_entry.  Pairing only merges entries of one tile, so a tile's
// range never starts inside a pair.
#include "fine_common.cuh"

namespace {

using namespace piet;

constexpr int CHUNK = 32;                   // entries per stage
constexpr int ENTRY_VEC = ENTRY_WORDS / 4;  // 16-byte words per entry
constexpr int W_RUN = 15;

// One entry on the thread's R pixels; w holds its 16 words.  kCov: with
// the clip-coverage multiply (after a group command, on the stack
// state).  kPaired: an entry of a paired stream (F2 and L2 entries).
template <bool kCov, bool kPaired, int R, class State>
__device__ __forceinline__ void apply_entry(State (&s)[R],
                                            const float (&w)[ENTRY_WORDS]) {
  const float* a0 = w + W_S0_ARG;  // slot-0 operand words 0..11
  const float* a1 = w + W_S1_ARG;  // slot-1 operand words 0..4
  const int tag0 = (int)w[W_S0_TAG];
  if (tag0 == CMD_LINE) {
#pragma unroll
    for (int k = 0; k < R; ++k) s[k].line(a0);
    if (kPaired && w[W_S1_TAG] == (float)CMD_LINE) {
      // line_field_sq reads words 0-3 and 5 (inv_denom).
      const float l1[6] = {a1[0], a1[1], a1[2], a1[3], a1[4], a1[4]};
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].line(l1);
    }
  } else if (tag0 == CMD_FILL_EDGE) {
#pragma unroll
    for (int k = 0; k < R; ++k) s[k].fill_edge(a0);
  }
  if (w[W_S1_TAG] == (float)CMD_FILL) {
    if (kPaired && tag0 == CMD_FILL) {
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].fill(a0);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) s[k].fill(a1);
  }
  switch (tag0) {
    case CMD_CIRCLE:
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].template circle<kCov>(a0);
      break;
    case CMD_STROKE:
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].template stroke<kCov>(a0);
      break;
    case CMD_DRAW_FILL:
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].template draw_fill<kCov>(a0);
      break;
    case CMD_SOLID:
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].template solid<kCov>(a0);
      break;
    case CMD_DRAW_LIN_GRAD:
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].template gradient<kCov>(a0, false);
      break;
    case CMD_DRAW_RAD_GRAD:
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].template gradient<kCov>(a0, true);
      break;
    case CMD_WIND:
#pragma unroll
      for (int k = 0; k < R; ++k) s[k].wind(a0);
      break;
    default:
      if constexpr (kCov) {  // group commands: only on the stack state
        switch (tag0) {
          case CMD_BEGIN_CLIP:
#pragma unroll
            for (int k = 0; k < R; ++k) s[k].begin_clip(a0);
            break;
          case CMD_END_CLIP:
#pragma unroll
            for (int k = 0; k < R; ++k) s[k].end_clip();
            break;
          case CMD_BEGIN_LAYER:
#pragma unroll
            for (int k = 0; k < R; ++k) s[k].begin_layer();
            break;
          case CMD_END_LAYER:
#pragma unroll
            for (int k = 0; k < R; ++k) s[k].end_layer(a0);
            break;
          default:
            break;
        }
      }
      break;
  }
}

// Staged entry e's 16 words into registers.
__device__ __forceinline__ void load_entry(const float4* __restrict__ q,
                                           float (&w)[ENTRY_WORDS]) {
#pragma unroll
  for (int v = 0; v < ENTRY_VEC; ++v) {
    const float4 x = q[v];
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }
}

__device__ __forceinline__ bool is_group(int tag0) {
  return tag0 >= CMD_BEGIN_CLIP && tag0 <= CMD_END_LAYER;
}

// Run dispatch: entries [e, cnt) of a staged chunk of an unpaired
// stream.  Without the coverage multiply (kCov = false) it stops at the
// first group command and returns its index; otherwise it returns cnt.
template <bool kCov, int R, class State>
__device__ __forceinline__ int run_chunk(State (&s)[R],
                                         const float4* __restrict__ ents,
                                         int e, int cnt) {
  while (e < cnt) {
    const float4* q = ents + e * ENTRY_VEC;
    float w[ENTRY_WORDS];
    load_entry(q, w);
    if (!kCov && is_group((int)w[W_S0_TAG])) return e;
    const float run = w[W_RUN];
    if (run != 0.f) {
      const int len = min((int)fabsf(run), cnt - e);
      if (run > 0.f) {  // slot-1 fills only: words 9..13
        for (int j = 0; j < len; ++j) {
          const float4 x = q[j * ENTRY_VEC + 2], y = q[j * ENTRY_VEC + 3];
          const float a1[5] = {x.y, x.z, x.w, y.x, y.y};
#pragma unroll
          for (int k = 0; k < R; ++k) s[k].fill(a1);
        }
      } else {  // slot-0 lines only: words 1..6
        for (int j = 0; j < len; ++j) {
          const float4 x = q[j * ENTRY_VEC], y = q[j * ENTRY_VEC + 1];
          const float a0[6] = {x.y, x.z, x.w, y.x, y.y, y.z};
#pragma unroll
          for (int k = 0; k < R; ++k) s[k].line(a0);
        }
      }
      e += len;
      continue;
    }
    apply_entry<kCov, false, R>(s, w);
    ++e;
  }
  return cnt;
}

// The streak classes of a paired entry, from its two tag words.  A hole
// (both 0) joins either streak.
__device__ __forceinline__ bool fill_or_hole(float t0, float t1) {
  return (t0 == 0.f && (t1 == 0.f || t1 == (float)CMD_FILL)) ||
         (t0 == (float)CMD_FILL && t1 == (float)CMD_FILL);
}
__device__ __forceinline__ bool line_or_hole(float t0, float t1) {
  return (t0 == 0.f && t1 == 0.f) ||
         (t0 == (float)CMD_LINE && (t1 == 0.f || t1 == (float)CMD_LINE));
}

// Streak dispatch: entries [e, cnt) of a staged chunk of a paired
// stream, with run_chunk's contract.  tw: the chunk's words.
template <bool kCov, int R, class State>
__device__ __forceinline__ int run_chunk_paired(
    State (&s)[R], const float4* __restrict__ ents, int e, int cnt) {
  const float* tw = reinterpret_cast<const float*>(ents);
  if (e >= cnt) return cnt;
  float t0 = tw[e * ENTRY_WORDS + W_S0_TAG];
  float t1 = tw[e * ENTRY_WORDS + W_S1_TAG];
  for (;;) {
    if (fill_or_hole(t0, t1)) {
      do {  // F1 and F2 entries: slot 0 (F2) before slot 1
        const float4* q = ents + e * ENTRY_VEC;
        if (t0 != 0.f) {  // words 1..5
          const float4 x = q[0], y = q[1];
          const float a0[5] = {x.y, x.z, x.w, y.x, y.y};
#pragma unroll
          for (int k = 0; k < R; ++k) s[k].fill(a0);
        }
        if (t1 != 0.f) {  // words 9..13
          const float4 x = q[2], y = q[3];
          const float a1[5] = {x.y, x.z, x.w, y.x, y.y};
#pragma unroll
          for (int k = 0; k < R; ++k) s[k].fill(a1);
        }
        if (++e == cnt) return cnt;
        t0 = tw[e * ENTRY_WORDS + W_S0_TAG];
        t1 = tw[e * ENTRY_WORDS + W_S1_TAG];
      } while (fill_or_hole(t0, t1));
    } else if (line_or_hole(t0, t1)) {
      do {  // L1 and L2 entries
        const float4* q = ents + e * ENTRY_VEC;
        if (t0 != 0.f) {  // words 1..6
          const float4 x = q[0], y = q[1];
          const float a0[6] = {x.y, x.z, x.w, y.x, y.y, y.z};
#pragma unroll
          for (int k = 0; k < R; ++k) s[k].line(a0);
        }
        if (t1 != 0.f) {  // words 9..13, inv_denom (word 13) as word 5
          const float4 x = q[2], y = q[3];
          const float a1[6] = {x.y, x.z, x.w, y.x, y.y, y.y};
#pragma unroll
          for (int k = 0; k < R; ++k) s[k].line(a1);
        }
        if (++e == cnt) return cnt;
        t0 = tw[e * ENTRY_WORDS + W_S0_TAG];
        t1 = tw[e * ENTRY_WORDS + W_S1_TAG];
      } while (line_or_hole(t0, t1));
    } else {
      if (!kCov && is_group((int)t0)) return e;
      float w[ENTRY_WORDS];
      load_entry(ents + e * ENTRY_VEC, w);
      apply_entry<kCov, true, R>(s, w);
      if (++e == cnt) return cnt;
      t0 = tw[e * ENTRY_WORDS + W_S0_TAG];
      t1 = tw[e * ENTRY_WORDS + W_S1_TAG];
    }
  }
}

template <bool kCov, bool kPaired, int R, class State>
__device__ __forceinline__ int run(State (&s)[R],
                                   const float4* __restrict__ ents, int e,
                                   int cnt) {
  if constexpr (kPaired)
    return run_chunk_paired<kCov, R>(s, ents, e, cnt);
  else
    return run_chunk<kCov, R>(s, ents, e, cnt);
}

// The packed pixels of the thread's R pixels (columns past the tile's
// edge and rows past its height are not written).
template <int R, class State>
__device__ __forceinline__ void store(const State (&s)[R],
                                      unsigned* __restrict__ out, size_t o,
                                      int c0, int tile_w, bool row_live) {
  if (!row_live) return;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (c0 + k < tile_w) out[o + k] = pack_rgba8(s[k].r, s[k].g, s[k].b);
}

// Block i: band (i % per_tile) of tile order[i / per_tile].
template <bool kPaired, int R>
__global__ void __launch_bounds__(THREADS)
fine_entries_kernel(const int* __restrict__ first,
                    const int* __restrict__ n_entries,
                    const unsigned* __restrict__ present,
                    const float4* __restrict__ stream,
                    const int* __restrict__ order,
                    unsigned* __restrict__ out, int tiles_x, int tile_w,
                    int tile_h, int row0, int col_groups, int per_tile) {
  __shared__ float4 ents[2][CHUNK * ENTRY_VEC];
  // This thread's pixels: columns c0 .. c0 + R - 1 of tile row ``row``.
  const BandPos bp = band_pos<R>(order, col_groups, per_tile);
  const int t = bp.t, c0 = bp.c0, row = bp.row;
  const bool row_live = row < tile_h;
  const int ty_local = t / tiles_x;
  const int tx = t % tiles_x;
  const size_t o = (size_t)(ty_local * tile_h + row) * (tiles_x * tile_w) +
                   (size_t)tx * tile_w + c0;
  const int n = n_entries[t];
  if (n == 0) {
    const unsigned sol = present[t];
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (row_live && c0 + k < tile_w)
        out[o + k] = sol == 0u ? 0xFFFFFFFFu : sol;
    return;
  }
  const float Y = (float)((row0 + ty_local) * tile_h) + (float)row;
  // The state without stacks (in registers): r, g, b, df2, area at
  // their start.
  PixelState<false> s[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    s[k].X = (float)(tx * tile_w) + (float)(c0 + k);
    s[k].Y = Y;
  }

  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const float4* src = stream + (size_t)first[t] * ENTRY_VEC;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const auto count = [&](int c) { return min(CHUNK, n - c * CHUNK); };
  const auto stage = [&](int c) {
    const float4* g = src + (size_t)c * CHUNK * ENTRY_VEC;
    float4* d = ents[c & 1];
    for (int i = tid; i < count(c) * ENTRY_VEC; i += nthreads)
      cp_async16(d + i, g + i);
  };
  // Chunk c in shared memory, chunk c + 1 in flight.
  const auto land = [&](int c) {
    if (c + 1 < n_chunks) stage(c + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
  };
  stage(0);
  cp_async_commit();
  int c = 0, e = 0;
  for (; c < n_chunks; ++c) {
    land(c);
    e = run<false, kPaired, R>(s, ents[c & 1], 0, count(c));
    if (e < count(c)) break;  // the tile's first group command
    __syncthreads();          // buffer c & 1 is free for chunk c + 2
  }
  if (c < n_chunks) {  // the first group command: entry e of chunk c
    PixelState<true> g[R];  // with the stacks (in local memory)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      g[k].r = s[k].r;
      g[k].g = s[k].g;
      g[k].b = s[k].b;
      g[k].df2 = s[k].df2;
      g[k].area = s[k].area;
      g[k].X = s[k].X;
      g[k].Y = s[k].Y;
      g[k].init_stacks(1.f);
    }
    for (;;) {
      run<true, kPaired, R>(g, ents[c & 1], e, count(c));
      __syncthreads();
      if (++c == n_chunks) break;
      land(c);
      e = 0;
    }
    store<R>(g, out, o, c0, tile_w, row_live);
    return;
  }
  store<R>(s, out, o, c0, tile_w, row_live);
}

}  // namespace

// order: n_tiles ints of scratch for the dense-first tile order.
// paired: nonzero for a paired stream (the paired instantiation).
extern "C" int piet_fine_entries(const void* first, const void* n_entries,
                                 const void* present, const void* stream_p,
                                 void* order, void* out, int n_tiles,
                                 int tiles_x, int tile_w, int tile_h,
                                 int row0, int paired, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (tile_w <= 0 || tile_h <= 0 || tile_w > 1024 || order == nullptr)
    return (int)cudaErrorInvalidValue;
  const Bands b = band_layout(tile_w, tile_h);
  if ((long long)n_tiles * b.per_tile > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  int* ord = static_cast<int*>(order);
  const int* ne = static_cast<const int*>(n_entries);
  const cudaError_t err = launch_tile_order(ne, n_tiles, 0x7FFFFFFF, ord,
                                            stream);
  if (err != cudaSuccess) return (int)err;
  const auto kernel =
      paired ? (b.r == 8 ? fine_entries_kernel<true, 8>
                         : fine_entries_kernel<true, 4>)
             : (b.r == 8 ? fine_entries_kernel<false, 8>
                         : fine_entries_kernel<false, 4>);
  kernel<<<n_tiles * b.per_tile, dim3(b.bx, b.ny), 0, stream>>>(
      static_cast<const int*>(first), ne,
      static_cast<const unsigned*>(present),
      static_cast<const float4*>(stream_p), ord,
      static_cast<unsigned*>(out), tiles_x, tile_w, tile_h, row0,
      b.col_groups, b.per_tile);
  return (int)cudaGetLastError();
}
