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
// pixel, all per-pixel state in registers (r, g, b, squared df, area,
// clip-coverage stack, saved-rgb layer stack).  The block stages its
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

  float r = 1.f, g = 1.f, b = 1.f, df2 = DF2_INIT, area = 0.f;
  float cov[MAX_GROUP_DEPTH + 1];
  float svr[MAX_GROUP_DEPTH], svg[MAX_GROUP_DEPTH], svb[MAX_GROUP_DEPTH];
  cov[0] = 1.f;
#pragma unroll
  for (int d = 0; d < MAX_GROUP_DEPTH; ++d) {
    cov[d + 1] = 1.f;
    svr[d] = svg[d] = svb[d] = 1.f;
  }
  int dclip = 0, dlayer = 0;

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
        df2 = tmin(df2, line_field_sq(a0, X, Y));
      } else if (tag0 == CMD_FILL_EDGE) {
        area = area + edge_delta(a0, Y);
      }
      if (ent[W_S1_TAG] == (float)CMD_FILL) {
        float d;
        if (fill_delta(a1, X, Y, &d)) area = area + d;
      }
      switch (tag0) {
        case CMD_CIRCLE: {
          const float cx = a0[0] + 0.5f * (a0[2] - a0[0]);
          const float cy = a0[1] + 0.5f * (a0[3] - a0[1]);
          const float dx = X - cx, dy = Y - cy;
          const float rad = ieee_sqrt((dx * dx) + (dy * dy));
          const float circle_r = tmin(cx - a0[0], cy - a0[1]);
          float alpha = sat(circle_r - rad);
          alpha = alpha * clip_cov(a0, X, Y);
          alpha = alpha * cov[dclip];
          const float keep = 1.f - alpha;
          r = r * keep; g = g * keep; b = b * keep;
          break;
        }
        case CMD_STROKE: {
          const float df = ieee_sqrt(df2);
          float alpha = sat(a0[0] + 0.5f - df);
          alpha = alpha * clip_cov(a0, X, Y);
          alpha = alpha * cov[dclip];
          const float w = a0[4] * alpha;
          r = r + (a0[1] - r) * w;
          g = g + (a0[2] - g) * w;
          b = b + (a0[3] - b) * w;
          df2 = DF2_INIT;
          break;
        }
        case CMD_DRAW_FILL: {
          const float x = area + a0[0];
          float alpha = clip_alpha(x, a0[5]);
          alpha = alpha * clip_cov(a0, X, Y);
          alpha = alpha * cov[dclip];
          const float w = a0[4] * alpha;
          r = r + (a0[1] - r) * w;
          g = g + (a0[2] - g) * w;
          b = b + (a0[3] - b) * w;
          area = 0.f;
          break;
        }
        case CMD_SOLID: {
          float alpha = 1.f * clip_cov(a0, X, Y);
          alpha = alpha * cov[dclip];
          const float w = a0[3] * alpha;
          r = r + (a0[0] - r) * w;
          g = g + (a0[1] - g) * w;
          b = b + (a0[2] - b) * w;
          break;
        }
        case CMD_BEGIN_CLIP: {
          const float x = area + a0[0];
          const float ca = clip_alpha(x, a0[1]);
          const int nd = min(dclip + 1, MAX_GROUP_DEPTH);
          cov[nd] = cov[dclip] * ca;
          dclip = nd;
          area = 0.f;
          break;
        }
        case CMD_END_CLIP:
          dclip = max(dclip - 1, 0);
          break;
        case CMD_BEGIN_LAYER: {
          const int ld = min(dlayer, MAX_GROUP_DEPTH - 1);
          svr[ld] = r; svg[ld] = g; svb[ld] = b;
          dlayer = ld + 1;
          break;
        }
        case CMD_END_LAYER: {
          const float alpha = a0[0];
          const int ld = max(dlayer - 1, 0);
          r = svr[ld] + (r - svr[ld]) * alpha;
          g = svg[ld] + (g - svg[ld]) * alpha;
          b = svb[ld] + (b - svb[ld]) * alpha;
          dlayer = ld;
          break;
        }
        case CMD_DRAW_LIN_GRAD:
        case CMD_DRAW_RAD_GRAD: {
          float tg;
          if (tag0 == CMD_DRAW_RAD_GRAD) {
            const float dx = X - a0[1], dy = Y - a0[2];
            tg = sat(ieee_sqrt((dx * dx) + (dy * dy)) * a0[3]);
          } else {
            tg = sat((a0[1] * X) + (a0[2] * Y) + a0[3]);
          }
          const float fr = a0[4] + (a0[8] - a0[4]) * tg;
          const float fg = a0[5] + (a0[9] - a0[5]) * tg;
          const float fb = a0[6] + (a0[10] - a0[6]) * tg;
          const float fa = a0[7] + (a0[11] - a0[7]) * tg;
          const float x = area + a0[0];
          float alpha = tmin(fabsf(x), 1.f);
          alpha = alpha * cov[dclip];
          const float w = fa * alpha;
          r = r + (fr - r) * w;
          g = g + (fg - g) * w;
          b = b + (fb - b) * w;
          area = 0.f;
          break;
        }
        case CMD_WIND:
          area = area + a0[0];
          break;
        default:
          break;
      }
    }
    __syncthreads();
  }
  if (px_live) out[o] = pack_rgba8(r, g, b);
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
