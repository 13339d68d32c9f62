// Kernel D: the entry-stream fine rasterizer.
//
// Replaces piet_tpu/ops/fine.py::_fine_entries_kernel (behind
// fine_rasterize_entries).  Tile t owns the sorted entries
// [first[t], first[t] + n[t]) of the (E, 16) f32 stream; each entry is
// applied to every pixel of the tile in stream order, in the order of the
// JAX kernel's accum_entry: slot-0 line (squared distance min), slot-0
// fill edge, slot-1 fill, then the resolve classes (circle, stroke, draw
// fill, solid) and the clip/layer group, gradient and wind commands.  The
// W_RUN word is ignored: run dispatch is a TPU dispatch device and does
// not change pixels.  An empty tile writes its present colour (the bail
// solid's bytes, or white), then the polynomial sRGB encode packs RGBA8.
//
// Design: one block per (tile, band of 1024 / tile_w rows), one thread per
// pixel, all per-pixel state in registers (cmd_math.cuh's PixelState: r,
// g, b, squared df, area, clip-coverage stack, saved-rgb layer stack;
// the same evaluators as the dense kernel, fine_dense.cu).  The block
// stages its
// tile's entries through shared memory in chunks of 256 x 64 B, loaded
// cooperatively and coalesced, so every entry word is read from device
// memory once per block instead of once per thread.
//
// Bound on the H100: per-pixel f32 work, ~20-60 dependent operations per
// entry and pixel, sequential along the entry list (painter's order is a
// data dependency).  The TPU kernel looped over entries with the whole
// tile as vector state and a scalar core fetching operands; here the
// entry loop runs in every thread with operands broadcast from shared
// memory.  Blocks are independent, so the 4 x 676 blocks of the 1664^2
// tiger spread over all 132 SMs.
#include "cmd_math.cuh"

namespace {

using namespace piet;

constexpr int CHUNK = 256;

__global__ void __launch_bounds__(1024)
fine_entries_kernel(const int* __restrict__ first,
                    const int* __restrict__ n_entries,
                    const unsigned* __restrict__ present,
                    const float* __restrict__ stream,
                    unsigned* __restrict__ out, int tiles_x, int tile_w,
                    int tile_h, int row0) {
  __shared__ float ents[CHUNK][ENTRY_WORDS];
  const int t = blockIdx.x;
  const int lx = threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool px_live = row < tile_h;
  const int ty_local = t / tiles_x;
  const int tx = t % tiles_x;
  const int width = tiles_x * tile_w;
  const size_t o = (size_t)(ty_local * tile_h + row) * width +
                   (size_t)tx * tile_w + lx;
  const int n = n_entries[t];
  if (n == 0) {
    const unsigned sol = present[t];
    if (px_live) out[o] = sol == 0u ? 0xFFFFFFFFu : sol;
    return;
  }
  const int fe = first[t];
  const float X = (float)(tx * tile_w) + (float)lx;
  const float Y = (float)((row0 + ty_local) * tile_h) + (float)row;

  PixelState<true> s(X, Y, 1.f);

  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int base = 0; base < n; base += CHUNK) {
    const int cnt = min(CHUNK, n - base);
    const float* src = stream + (size_t)(fe + base) * ENTRY_WORDS;
    float* dst = &ents[0][0];
    for (int w = tid; w < cnt * ENTRY_WORDS; w += nthreads) dst[w] = src[w];
    __syncthreads();
    for (int e = 0; e < cnt; ++e) {
      const float* ent = ents[e];
      const float* a0 = ent + W_S0_ARG;   // slot-0 operand words 0..11
      const float* a1 = ent + W_S1_ARG;   // slot-1 operand words 0..4
      const int tag0 = (int)ent[W_S0_TAG];
      if (tag0 == CMD_LINE) {
        s.line(a0);
      } else if (tag0 == CMD_FILL_EDGE) {
        s.fill_edge(a0);
      }
      if (ent[W_S1_TAG] == (float)CMD_FILL) s.fill(a1);
      switch (tag0) {
        case CMD_CIRCLE: s.circle(a0); break;
        case CMD_STROKE: s.stroke(a0); break;
        case CMD_DRAW_FILL: s.draw_fill(a0); break;
        case CMD_SOLID: s.solid(a0); break;
        case CMD_BEGIN_CLIP: s.begin_clip(a0); break;
        case CMD_END_CLIP: s.end_clip(); break;
        case CMD_BEGIN_LAYER: s.begin_layer(); break;
        case CMD_END_LAYER: s.end_layer(a0); break;
        case CMD_DRAW_LIN_GRAD: s.gradient(a0, false); break;
        case CMD_DRAW_RAD_GRAD: s.gradient(a0, true); break;
        case CMD_WIND: s.wind(a0); break;
        default: break;
      }
    }
    __syncthreads();
  }
  if (px_live) out[o] = pack_rgba8(s.r, s.g, s.b);
}

}  // namespace

extern "C" int piet_fine_entries(const void* first, const void* n_entries,
                                 const void* present, const void* stream_p,
                                 void* out, int n_tiles, int tiles_x,
                                 int tile_w, int tile_h, int row0,
                                 cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (tile_w <= 0 || tile_w > 1024) return (int)cudaErrorInvalidValue;
  const int band = min(tile_h, 1024 / tile_w);
  const dim3 block(tile_w, band);
  const dim3 grid(n_tiles, (tile_h + band - 1) / band);
  fine_entries_kernel<<<grid, block, 0, stream>>>(
      static_cast<const int*>(first), static_cast<const int*>(n_entries),
      static_cast<const unsigned*>(present),
      static_cast<const float*>(stream_p), static_cast<unsigned*>(out),
      tiles_x, tile_w, tile_h, row0);
  return (int)cudaGetLastError();
}
