// The dense PTCL interpreter: the fine pass of the dense route.
//
// Replaces piet_tpu/ops/fine.py::_fine_kernel (behind fine_rasterize) and
// serves the JAX package's pure-XLA interpreter, ops/fine_xla.py::
// fine_rasterize_xla, with the same code.  Tile t interprets commands
// [0, counts[t]) of its row of the (T, CAP) int32 tags and (T, CAP, 12)
// f32 operands, in order, on every pixel of the tile; pixels sit at
// absolute coordinates (tile row row0 + t / tiles_x).  The start state is
// white with an empty distance field and no winding; the output is the
// packed RGBA8 word of every pixel, untiled, (tiles_y * th, tiles_x * tw).
// Counts above CAP are read as CAP.
//
// Two instantiations of one template, mapping the tag to a branch as
// their JAX counterparts do:
//   kGroups = false (_fine_kernel): clip(tag - 2, 0, 8) -> the seven
//     commands of make_commands, no-op (tag 9), debug magenta (tags >= 10);
//     no coverage stack.
//   kGroups = true (fine_xla): clip(tag - 2, 0, 14) -> the seven commands,
//     no-op, begin/end clip, begin/end layer, linear and radial gradient,
//     wind; the clip-coverage and saved-rgb stacks.
// A tag below 2 maps to the first branch (Circle), as the clip does;
// slots past a tile's count are never read.
//
// Bound on the H100: operations -- ~10-60 dependent f32 operations per
// command and pixel (a line's distance field, a fill's trapezoid area, a
// resolve's blend), each rounded on its own (-fmad=false), sequential
// along the command list (painter's order is a data dependency), with
// about as many compares, selects and min/max on the ALU pipe beside them
// (kernel D's limiter, PERF.md).  The PTCL bytes are read once per block.
// The design is kernel D's (fine.cu), which interprets the same work:
//
// - Bands (fine_common.cuh): each thread R neighbouring pixels of a row
//   (8 on tiles 64 pixels wide or more, else 4), blocks of at most 128
//   threads.  A command's tag and operands are read and dispatched once
//   per R pixels, and its terms that depend on the row alone (a fill's
//   clamped row span and slope terms, all of a fill edge) are computed
//   once for them.
// - Staging: the block copies its tile's commands into shared memory in
//   chunks of 128 (128 int32 tags and 128 x 3 16-byte operand words, as
//   they lie in device memory; a tag never passes a float register) with
//   cp.async, double-buffered, so the next chunk lands while the current
//   one is interpreted.  cmd_capacity % 128 == 0 keeps both rows of a
//   chunk 16-byte aligned.
// - Streaks: a run of consecutive Fill (tag 4) or Line (tag 3) commands in
//   a chunk runs in a tight loop that reads only the next tag from shared
//   memory, with no other dispatch (the dense PTCL has no run word).
// - Lazy stacks (group instantiation): the block interprets on a state
//   without stacks, all in registers, and without the clip-coverage
//   multiply until its first begin/end clip or layer (tags 10-13; the
//   tiger has none).  There it copies the state into one with the stacks
//   (coverage 1, saved planes 0, as fine_rasterize_xla starts them; in
//   local memory, since a stack is indexed by its depth) and goes on with
//   the stack path from that command.  Before it the coverage is
//   cov[0] == 1, and alpha * 1 == alpha on every f32, so both paths give
//   the same bits.  Gradients and wind need no stack.  (One state type
//   with the stacks from the start kept the whole state in local memory:
//   48 registers a thread, 0.395 ms on the tiger against the non-group
//   instantiation's 0.207; PERF.md.)
// - Dense tiles first: tile_order (a second launch) sorts the tiles by
//   the bit length of min(count, CAP), and the grid takes them in that
//   order.
#include "fine_common.cuh"

namespace {

using namespace piet;

constexpr int CHUNK = 128;  // commands per stage
constexpr int ARG_VEC = 3;  // 16-byte words per command's 12 operands

// Commands [j, cnt) of a staged chunk on the thread's R pixels.  kCov:
// with the clip-coverage multiply, on states with stacks.  Without it,
// the group instantiation stops at the first begin/end clip or layer and
// returns its index; otherwise it returns cnt.
template <bool kGroups, bool kCov, int R, class State>
__device__ __forceinline__ int run_chunk(State (&s)[R],
                                         const int* __restrict__ tg,
                                         const float4* __restrict__ av,
                                         int j, int cnt) {
  constexpr int kTop = kGroups ? 14 : 8;
  while (j < cnt) {
    const int tag = tg[j];
    if (tag == CMD_FILL) {  // operand words 0..4
      do {
        const float4 x = av[j * ARG_VEC], y = av[j * ARG_VEC + 1];
        const float a[5] = {x.x, x.y, x.z, x.w, y.x};
#pragma unroll
        for (int k = 0; k < R; ++k) s[k].fill(a);
      } while (++j < cnt && tg[j] == CMD_FILL);
      continue;
    }
    if (tag == CMD_LINE) {  // operand words 0..3 and 5
      do {
        const float4 x = av[j * ARG_VEC], y = av[j * ARG_VEC + 1];
        const float a[6] = {x.x, x.y, x.z, x.w, y.x, y.y};
#pragma unroll
        for (int k = 0; k < R; ++k) s[k].line(a);
      } while (++j < cnt && tg[j] == CMD_LINE);
      continue;
    }
    const int idx = min(max(wrap_add(tag, -2), 0), kTop);
    if (kGroups && !kCov && idx >= 8 && idx <= 11) return j;
    float a[12];
#pragma unroll
    for (int v = 0; v < ARG_VEC; ++v) {
      const float4 x = av[j * ARG_VEC + v];
      a[4 * v] = x.x;
      a[4 * v + 1] = x.y;
      a[4 * v + 2] = x.z;
      a[4 * v + 3] = x.w;
    }
    switch (idx) {  // 1 (Line) and 2 (Fill) ran above
      case 0:
#pragma unroll
        for (int k = 0; k < R; ++k) s[k].template circle<kCov>(a);
        break;
      case 3:
#pragma unroll
        for (int k = 0; k < R; ++k) s[k].template stroke<kCov>(a);
        break;
      case 4:
#pragma unroll
        for (int k = 0; k < R; ++k) s[k].fill_edge(a);
        break;
      case 5:
#pragma unroll
        for (int k = 0; k < R; ++k) s[k].template draw_fill<kCov>(a);
        break;
      case 6:
#pragma unroll
        for (int k = 0; k < R; ++k) s[k].template solid<kCov>(a);
        break;
      case 7:
        break;  // Bail: the present composite owns bailed tiles
      default:
        if constexpr (kGroups) {
          switch (idx) {  // 8-11 only with kCov (returned above otherwise)
            case 8:
              if constexpr (kCov) {
#pragma unroll
                for (int k = 0; k < R; ++k) s[k].begin_clip(a);
              }
              break;
            case 9:
              if constexpr (kCov) {
#pragma unroll
                for (int k = 0; k < R; ++k) s[k].end_clip();
              }
              break;
            case 10:
              if constexpr (kCov) {
#pragma unroll
                for (int k = 0; k < R; ++k) s[k].begin_layer();
              }
              break;
            case 11:
              if constexpr (kCov) {
#pragma unroll
                for (int k = 0; k < R; ++k) s[k].end_layer(a);
              }
              break;
            case 12:
#pragma unroll
              for (int k = 0; k < R; ++k)
                s[k].template gradient<kCov>(a, false);
              break;
            case 13:
#pragma unroll
              for (int k = 0; k < R; ++k)
                s[k].template gradient<kCov>(a, true);
              break;
            default:
#pragma unroll
              for (int k = 0; k < R; ++k) s[k].wind(a);
              break;
          }
        } else {  // an unknown tag: the reference's debug magenta
#pragma unroll
          for (int k = 0; k < R; ++k) {
            s[k].r = 1.f;
            s[k].g = 0.f;
            s[k].b = 1.f;
          }
        }
        break;
    }
    ++j;
  }
  return cnt;
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
template <bool kGroups, int R>
__global__ void __launch_bounds__(THREADS)
fine_dense_kernel(const int* __restrict__ counts,
                  const int4* __restrict__ tags,
                  const float4* __restrict__ args,
                  const int* __restrict__ order, unsigned* __restrict__ out,
                  int tiles_x, int tile_w, int tile_h, int cap, int row0,
                  int col_groups, int per_tile) {
  __shared__ int4 s_tag[2][CHUNK / 4];
  __shared__ float4 s_arg[2][CHUNK * ARG_VEC];
  // This thread's pixels: columns c0 .. c0 + R - 1 of tile row ``row``.
  const BandPos bp = band_pos<R>(order, col_groups, per_tile);
  const int t = bp.t, c0 = bp.c0, row = bp.row;
  const int ty_local = t / tiles_x;
  const int tx = t % tiles_x;
  const size_t o = (size_t)(ty_local * tile_h + row) * (tiles_x * tile_w) +
                   (size_t)tx * tile_w + c0;
  const int n = min(counts[t], cap);
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
  const int4* trow = tags + (size_t)t * (cap / 4);
  const float4* arow = args + (size_t)t * cap * ARG_VEC;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const auto count = [&](int c) { return min(CHUNK, n - c * CHUNK); };
  const auto stage = [&](int c) {
    const int4* gt = trow + c * (CHUNK / 4);
    const float4* ga = arow + (size_t)c * CHUNK * ARG_VEC;
    for (int i = tid; i < (count(c) + 3) / 4; i += nthreads)
      cp_async16(&s_tag[c & 1][i], gt + i);
    for (int i = tid; i < count(c) * ARG_VEC; i += nthreads)
      cp_async16(&s_arg[c & 1][i], ga + i);
  };
  // Chunk c in shared memory, chunk c + 1 in flight.
  const auto land = [&](int c) {
    if (c + 1 < n_chunks) stage(c + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
  };
  const auto tg = [&](int c) {
    return reinterpret_cast<const int*>(s_tag[c & 1]);
  };
  if (n_chunks > 0) stage(0);
  cp_async_commit();
  int c = 0, j = 0;
  for (; c < n_chunks; ++c) {
    land(c);
    j = run_chunk<kGroups, false, R>(s, tg(c), s_arg[c & 1], 0, count(c));
    if (j < count(c)) break;  // a group command (group instantiation only)
    __syncthreads();          // buffer c & 1 is free for chunk c + 2
  }
  if constexpr (kGroups) {
    if (c < n_chunks) {  // the tile's first group command: slot j, chunk c
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
        g[k].init_stacks(0.f);
      }
      for (;;) {
        run_chunk<true, true, R>(g, tg(c), s_arg[c & 1], j, count(c));
        __syncthreads();
        if (++c == n_chunks) break;
        land(c);
        j = 0;
      }
      store<R>(g, out, o, c0, tile_w, row < tile_h);
      return;
    }
  }
  store<R>(s, out, o, c0, tile_w, row < tile_h);
}

template <bool kGroups>
cudaError_t launch(const Bands& b, int n_tiles, const int* counts,
                   const int4* tags, const float4* args, const int* order,
                   unsigned* out, int tiles_x, int tile_w, int tile_h,
                   int cap, int row0, cudaStream_t stream) {
  const auto kernel = b.r == 8 ? fine_dense_kernel<kGroups, 8>
                               : fine_dense_kernel<kGroups, 4>;
  kernel<<<n_tiles * b.per_tile, dim3(b.bx, b.ny), 0, stream>>>(
      counts, tags, args, order, out, tiles_x, tile_w, tile_h, cap, row0,
      b.col_groups, b.per_tile);
  return cudaGetLastError();
}

}  // namespace

// order: n_tiles ints of scratch for the dense-first tile order.
extern "C" int piet_fine_dense(const void* counts, const void* tags,
                               const void* args, void* order, void* out,
                               int n_tiles, int tiles_x, int tile_w,
                               int tile_h, int cap, int row0, int groups,
                               cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (tile_w <= 0 || tile_h <= 0 || tile_w > 1024 || cap % CHUNK ||
      order == nullptr)
    return (int)cudaErrorInvalidValue;
  const Bands b = band_layout(tile_w, tile_h);
  if ((long long)n_tiles * b.per_tile > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int* c = static_cast<const int*>(counts);
  int* ord = static_cast<int*>(order);
  cudaError_t err = launch_tile_order(c, n_tiles, cap, ord, stream);
  if (err != cudaSuccess) return (int)err;
  const int4* tg = static_cast<const int4*>(tags);
  const float4* a = static_cast<const float4*>(args);
  unsigned* o = static_cast<unsigned*>(out);
  err = groups ? launch<true>(b, n_tiles, c, tg, a, ord, o, tiles_x, tile_w,
                              tile_h, cap, row0, stream)
               : launch<false>(b, n_tiles, c, tg, a, ord, o, tiles_x,
                               tile_w, tile_h, cap, row0, stream);
  return (int)err;
}
