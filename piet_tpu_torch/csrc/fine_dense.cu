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
//     wind; the clip-coverage and saved-rgb stacks in registers.
// A tag below 2 maps to the first branch (Circle), as the clip does;
// slots past a tile's count are never read.
//
// Design: kernel D's grid -- one block per (tile, band of 1024 / tile_w
// rows), one thread per pixel, the state in registers (cmd_math.cuh's
// PixelState, the evaluators kernel D runs).  The block copies its tile's
// commands into shared memory in chunks of 128 (128 int32 tags and
// 128 x 12 operand words, 6.5 KB, contiguous in device memory), loaded
// cooperatively and coalesced in 16-byte words and moved as they are (a
// tag never passes a float register); then every thread walks the chunk
// with the operands broadcast from shared memory.  This is what replaces
// the TPU kernel's scalar fetch of each operand from SMEM: one coalesced
// load per chunk and block, instead of one scalar read per command.
//
// Bound on the H100: operations -- ~10-60 dependent f32 operations per
// command and pixel (a line's distance field, a fill's trapezoid area, a
// resolve's blend), sequential along the command list (painter's order is
// a data dependency); the PTCL bytes are read once per block.
#include "cmd_math.cuh"

namespace {

using namespace piet;

constexpr int CHUNK = 128;
constexpr int ARG_WORDS = 12;

template <bool kGroups>
__global__ void __launch_bounds__(1024)
fine_dense_kernel(const int* __restrict__ counts, const int* __restrict__ tags,
                  const int4* __restrict__ args, unsigned* __restrict__ out,
                  int tiles_x, int tile_w, int tile_h, int cap, int row0) {
  __shared__ int s_tag[CHUNK];
  __shared__ int4 s_arg[CHUNK * ARG_WORDS / 4];
  const int t = blockIdx.x;
  const int lx = threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const int ty_local = t / tiles_x;
  const int tx = t % tiles_x;
  const int n = min(counts[t], cap);
  const float X = (float)(tx * tile_w) + (float)lx;
  const float Y = (float)((row0 + ty_local) * tile_h) + (float)row;
  PixelState<kGroups> s(X, Y, 0.f);

  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int* trow = tags + (size_t)t * cap;
  const int4* arow = args + (size_t)t * cap * (ARG_WORDS / 4);
  const float* words = reinterpret_cast<const float*>(s_arg);
  for (int base = 0; base < n; base += CHUNK) {
    const int cnt = min(CHUNK, n - base);
    for (int i = tid; i < cnt; i += nthreads) s_tag[i] = trow[base + i];
    const int4* src = arow + (size_t)base * (ARG_WORDS / 4);
    for (int i = tid; i < cnt * (ARG_WORDS / 4); i += nthreads)
      s_arg[i] = src[i];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float* a = words + j * ARG_WORDS;
      const int idx = min(max(wrap_add(s_tag[j], -2), 0), kGroups ? 14 : 8);
      switch (idx) {
        case 0: s.circle(a); break;
        case 1: s.line(a); break;
        case 2: s.fill(a); break;
        case 3: s.stroke(a); break;
        case 4: s.fill_edge(a); break;
        case 5: s.draw_fill(a); break;
        case 6: s.solid(a); break;
        case 7: break;  // Bail: the present composite owns bailed tiles
        default:
          if constexpr (kGroups) {
            switch (idx) {
              case 8: s.begin_clip(a); break;
              case 9: s.end_clip(); break;
              case 10: s.begin_layer(); break;
              case 11: s.end_layer(a); break;
              case 12: s.gradient(a, false); break;
              case 13: s.gradient(a, true); break;
              default: s.wind(a); break;
            }
          } else {  // an unknown tag: the reference's debug magenta
            s.r = 1.f;
            s.g = 0.f;
            s.b = 1.f;
          }
          break;
      }
    }
    __syncthreads();
  }
  if (row < tile_h) {
    const size_t o = (size_t)(ty_local * tile_h + row) * (tiles_x * tile_w) +
                     (size_t)tx * tile_w + lx;
    out[o] = pack_rgba8(s.r, s.g, s.b);
  }
}

}  // namespace

extern "C" int piet_fine_dense(const void* counts, const void* tags,
                               const void* args, void* out, int n_tiles,
                               int tiles_x, int tile_w, int tile_h, int cap,
                               int row0, int groups, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (tile_w <= 0 || tile_w > 1024 || cap % CHUNK)
    return (int)cudaErrorInvalidValue;
  const int band = min(tile_h, 1024 / tile_w);
  const dim3 block(tile_w, band);
  const dim3 grid(n_tiles, (tile_h + band - 1) / band);
  const int* c = static_cast<const int*>(counts);
  const int* tg = static_cast<const int*>(tags);
  const int4* a = static_cast<const int4*>(args);
  unsigned* o = static_cast<unsigned*>(out);
  if (groups) {
    fine_dense_kernel<true><<<grid, block, 0, stream>>>(
        c, tg, a, o, tiles_x, tile_w, tile_h, cap, row0);
  } else {
    fine_dense_kernel<false><<<grid, block, 0, stream>>>(
        c, tg, a, o, tiles_x, tile_w, tile_h, cap, row0);
  }
  return (int)cudaGetLastError();
}
