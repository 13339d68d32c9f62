// The device segment stage's rows: each segment slot's (S, 27) row, its hit
// count, the exclusive scan of the counts and their total, from the
// expanded item rows and the two endpoints.  One thread a segment slot.
//
// Replaces no TPU kernel: the JAX package computes these words with XLA
// ops (piet_tpu/ops/coarse.py:379-587, after the endpoint gather), and the
// port's plain version is ops/seg_rows.py::seg_rows_plain, which runs for
// CPU tensors.  Run on the card, that version is ~750 device ops a derived
// frame (the line equations and bounds, the fill solve, the stroke ranges
// with their one-tile probes, the bbox clip, the column widening, the
// scan, three div_det calls of 7 candidates each, the row's assembly).
//
// Bound on the H100: the bytes moved, about 190 a slot: the item row (14
// words) and the endpoints (4) read, the row (27 words), the count and the
// offset written; ~3 us at the 4K tiger's 64k slots at 3.35 TB/s, so a
// frame's call is bound by its launches and their latency.  What the design
// does about it: one pass, every word read and written once.
//
// - A block of 256 slots loads its span of item rows into shared memory as
//   16-byte words, each thread its endpoints as 8-byte words; every word
//   of the slot is computed by the plain version's expressions in its
//   order (kernels.py builds with -fmad=false and IEEE division and
//   denormals; float -> int32 conversions saturate and give 0 for NaN, as
//   PyTorch's conversion does on the card), dead slots included.
// - The hit counts' exclusive scan crosses blocks in at most two launches:
//   where there is more than one block, seg_count writes each block's sum
//   of counts, and seg_rows is a programmatic dependent launch behind it:
//   its blocks load and compute their slots while seg_count runs, then
//   wait for it and add up the sums of the blocks before them (no atomics,
//   no scratch but the sums, nothing to zero).
// - The block's rows are staged in shared memory and leave as one
//   contiguous run of 16-byte stores: a thread storing its own 108-byte row
//   would touch 27 lines a warp store.
#include "cmd_math.cuh"

namespace {

using namespace piet;

constexpr int THREADS = 256;  // slots a block, one a thread
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ITEM_WORDS = 14;  // ops/coarse.py::derive_seg_stage's rows
constexpr int SEG_WORDS = 27;
// scene/scene.py's tags.
constexpr int TAG_LINE = 2, TAG_FILL = 3, TAG_POLY = 4, TAG_CLIP = 5;

struct SegArgs {
  const int* sitem;    // (n_slots, 14) expanded item rows
  const float2* p0;    // (n_slots,) first endpoints
  const float2* p1;    // (n_slots,) second endpoints
  const int* n_segs;   // (1,) live segments
  unsigned* sums;      // (blocks,) each block's sum of hit counts
  int* rows;           // (n_slots, 27)
  int* hit_counts;     // (n_slots,)
  int* hit_excl;       // (n_slots,)
  int* n_hits;         // (1,)
  int n_slots;
  float tile_w, tile_h, inv_w, inv_h;  // inv_*: 1 / tile_* in f32
};

// Programmatic dependent launch (Hopper), as in sort.cu.
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// torch.minimum / torch.maximum of floats on the card: a NaN operand is
// returned, else ::min / ::max.
__device__ __forceinline__ float torch_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float torch_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// A slot's tile range on one axis for a stroke: the rect of the inflated
// segment [lo_v, hi_v], each end probed one tile further with the
// per-record cull's f32 expressions.
__device__ __forceinline__ void stroke_range(float mn, float mx, float hw,
                                             float step, float inv, int* lo,
                                             int* hi) {
  int l = f2i_sat(floorf((mn - hw) * inv));
  int h = wrap_sub(f2i_sat(ceilf((mx + hw) * inv)), 1);
  const int lm = wrap_sub(l, 1), hp = wrap_add(h, 1);
  const float ol = (float)lm * step, oh = (float)hp * step;
  if ((mx > ol - hw) && (mn < (ol + step) + hw)) l = lm;
  if ((mx > oh - hw) && (mn < (oh + step) + hw)) h = hp;
  *lo = l;
  *hi = h;
}

// Slot s's row words 0-25 (word 26, its offset, comes from the scan) and
// its hit count, from its item row r and endpoints.
__device__ __forceinline__ int derive(const SegArgs& g, int s, int n_segs,
                                      const int* r, float2 q0, float2 q1,
                                      int* w) {
  const int tag = r[0], bx0 = r[4], by0 = r[5], bx1 = r[6], by1 = r[7];
  const bool valid = s < n_segs;
  const float sx = q0.x, sy = q0.y, ex = q1.x, ey = q1.y;
  const float a = ey - sy;
  const float b = sx - ex;
  const float c = -((a * sx) + (b * sy));
  const float mnx = torch_min(sx, ex), mny = torch_min(sy, ey);
  const float mxx = torch_max(sx, ex), mxy = torch_max(sy, ey);
  const float hw = 0.5f * __int_as_float(r[9]) + 0.5f;
  const bool fill_tag = tag == TAG_FILL || tag == TAG_CLIP;
  const bool fill = valid && fill_tag;
  const bool stroke = valid && (tag == TAG_POLY || tag == TAG_LINE);
  const bool line_item = tag == TAG_LINE;

  // Fill: the exact solve (tile dims are powers of two); stroke: the
  // probed ranges; a line item: its bbox rect.
  const int fx_lo = f2i_sat(floorf(mnx * g.inv_w));
  const int fx_hi = wrap_sub(f2i_sat(ceilf(mxx * g.inv_w)), 1);
  const int fy_lo = f2i_sat(floorf(mny * g.inv_h));
  const int fy_hi = f2i_sat(floorf(mxy * g.inv_h));
  int sx_lo, sx_hi, sy_lo, sy_hi;
  stroke_range(mnx, mxx, hw, g.tile_w, g.inv_w, &sx_lo, &sx_hi);
  stroke_range(mny, mxy, hw, g.tile_h, g.inv_h, &sy_lo, &sy_hi);
  int x_lo = fill ? fx_lo : (line_item ? bx0 : sx_lo);
  int x_hi = fill ? fx_hi : (line_item ? bx1 : sx_hi);
  int y_lo = fill ? fy_lo : (line_item ? by0 : sy_lo);
  int y_hi = fill ? fy_hi : (line_item ? by1 : sy_hi);
  // The item's bbox rect clips it.
  x_lo = max(x_lo, bx0);
  x_hi = min(x_hi, bx1);
  y_lo = max(y_lo, by0);
  y_hi = min(y_hi, by1);
  int rw = max(wrap_add(wrap_sub(x_hi, x_lo), 1), 0);
  const int rh = max(wrap_add(wrap_sub(y_hi, y_lo), 1), 0);
  // A fill segment with winding rows but no column keeps one column.
  if (fill && a != 0.f && rw == 0 && rh > 0 && bx0 <= bx1) {
    x_lo = min(max(fx_lo, bx0), bx1);
    rw = 1;
  }

  // The division-free fine math's constants.
  const float lvx = ex - sx, lvy = ey - sy;
  const float invd = div_det(1.f, dot2_det(lvx, lvy));
  float m = div_det(lvx, lvy);
  float k = div_det(-lvy, fabsf(lvx));
  m = fabsf(m) < INFINITY ? m : 0.f;
  k = fabsf(k) < INFINITY ? k : 0.f;

  const float f[12] = {sx, sy, ex, ey, a, b, c, mnx, mny, mxx, mxy, hw};
#pragma unroll
  for (int j = 0; j < 12; ++j) w[j] = __float_as_int(f[j]);
  w[12] = (int)fill | ((int)stroke << 1) | ((int)line_item << 2);
  w[13] = x_lo;
  w[14] = y_lo;
  w[15] = max(rw, 1);
  w[16] = r[11];  // the item
  w[17] = r[3];   // its first candidate slot
  w[18] = by0;
  w[19] = max(r[8], 1);  // its bbox width in tiles
  w[20] = bx0;
  w[21] = by1;
  w[22] = bx1;
  w[23] = __float_as_int(invd);
  w[24] = __float_as_int(m);
  w[25] = __float_as_int(k);
  return valid ? wrap_mul(rw, rh) : 0;
}

// The block's sum of v (wrapping), in every thread.  sh holds WARPS words.
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // sh is free
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned t = 0;
#pragma unroll
  for (int j = 0; j < WARPS; ++j) t += sh[j];
  return t;
}

// The exclusive scan of v over the block (wrapping).  sh holds WARPS
// words.
__device__ __forceinline__ unsigned block_excl(unsigned v, unsigned* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // sh is free
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  unsigned before = 0;
#pragma unroll
  for (int j = 0; j < WARPS; ++j) before += j < warp ? sh[j] : 0u;
  return before + x - v;
}

// Slot s's item row, read directly (the count pass reads 7 of its words).
__device__ __forceinline__ void load_item(const SegArgs& g, int s, int* r) {
  const int2* p = reinterpret_cast<const int2*>(g.sitem + (size_t)s *
                                                ITEM_WORDS);
#pragma unroll
  for (int j = 0; j < ITEM_WORDS / 2; ++j) {
    const int2 v = __ldg(p + j);
    r[2 * j] = v.x;
    r[2 * j + 1] = v.y;
  }
}

// Each block's sum of hit counts, for the blocks after it.
__global__ void __launch_bounds__(THREADS) seg_count(const SegArgs g) {
  let_next_start();
  __shared__ unsigned sh[WARPS];
  const int s = blockIdx.x * THREADS + threadIdx.x;
  unsigned n = 0;
  if (s < g.n_slots) {
    int r[ITEM_WORDS], w[SEG_WORDS];
    load_item(g, s, r);
    n = (unsigned)derive(g, s, *g.n_segs, r, __ldg(g.p0 + s),
                         __ldg(g.p1 + s), w);
  }
  const unsigned t = block_sum(n, sh);
  if (threadIdx.x == 0) g.sums[blockIdx.x] = t;
}

__global__ void __launch_bounds__(THREADS) seg_rows(const SegArgs g) {
  // The block's item rows in, then its rows out, as 16-byte words.
  __shared__ int4 stage[THREADS * SEG_WORDS / 4];
  __shared__ unsigned sh[WARPS];
  int* words = reinterpret_cast<int*>(stage);
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * THREADS;
  const int n_rows = min(THREADS, g.n_slots - s0);
  const int s = s0 + tid;
  const bool mine = tid < n_rows;
  const float2 q0 = mine ? __ldg(g.p0 + s) : make_float2(0.f, 0.f);
  const float2 q1 = mine ? __ldg(g.p1 + s) : make_float2(0.f, 0.f);
  const int n_segs = *g.n_segs;
  {
    // The span starts 16-byte aligned (THREADS rows of 14 words); a ragged
    // last block's odd word goes alone.
    const int n_words = n_rows * ITEM_WORDS;
    const int4* src =
        reinterpret_cast<const int4*>(g.sitem + (size_t)s0 * ITEM_WORDS);
    for (int j = tid; j < n_words / 4; j += THREADS) stage[j] = __ldg(src + j);
    for (int j = (n_words / 4) * 4 + tid; j < n_words; j += THREADS)
      words[j] = __ldg(g.sitem + (size_t)s0 * ITEM_WORDS + j);
  }
  __syncthreads();
  int r[ITEM_WORDS], w[SEG_WORDS];
#pragma unroll
  for (int j = 0; j < ITEM_WORDS; ++j)
    r[j] = mine ? words[tid * ITEM_WORDS + j] : 0;
  const unsigned n = mine ? (unsigned)derive(g, s, n_segs, r, q0, q1, w) : 0u;

  // The counts of the slots before this block: seg_count's sums.
  unsigned before = 0;
  if (blockIdx.x > 0) {
    wait_prior();
    for (int j = tid; j < (int)blockIdx.x; j += THREADS) before += g.sums[j];
  }
  const unsigned base = block_sum(before, sh);
  const unsigned excl = base + block_excl(n, sh);
  w[26] = (int)excl;
  if (mine) {
    g.hit_counts[s] = (int)n;
    g.hit_excl[s] = (int)excl;
    if (s == g.n_slots - 1) *g.n_hits = (int)(excl + n);
  }
  // Every thread read its item row before block_sum's barriers.
  if (mine) {
#pragma unroll
    for (int j = 0; j < SEG_WORDS; ++j) words[tid * SEG_WORDS + j] = w[j];
  }
  __syncthreads();
  const int n_words = n_rows * SEG_WORDS;
  int4* dst = reinterpret_cast<int4*>(g.rows + (size_t)s0 * SEG_WORDS);
  for (int j = tid; j < n_words / 4; j += THREADS) dst[j] = stage[j];
  for (int j = (n_words / 4) * 4 + tid; j < n_words; j += THREADS)
    g.rows[(size_t)s0 * SEG_WORDS + j] = words[j];
}

// launch with programmatic stream serialization (behind the kernel before
// it on the stream) where `dependent`, else as a plain launch.
int launch(void (*kernel)(SegArgs), int blocks, bool dependent,
           cudaStream_t stream, const SegArgs& g) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, g);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// sitem (n_slots, 14) int32 and rows (n_slots, 27) int32, both 16-byte
// aligned; p0 and p1 (n_slots, 2) f32, 8-byte aligned; n_segs and n_hits
// (1,) int32; hit_counts and hit_excl (n_slots,) int32; sums
// (ceil(n_slots / 256),) int32 scratch.  tile_w and tile_h in pixels.
extern "C" int piet_seg_rows(const void* sitem, const void* p0,
                             const void* p1, const void* n_segs, void* sums,
                             void* rows, void* hit_counts, void* hit_excl,
                             void* n_hits, int n_slots, int tile_w,
                             int tile_h, cudaStream_t stream) {
  if (n_slots <= 0 || tile_w <= 0 || tile_h <= 0 ||
      ((reinterpret_cast<size_t>(sitem) | reinterpret_cast<size_t>(rows)) &
       15) != 0 ||
      ((reinterpret_cast<size_t>(p0) | reinterpret_cast<size_t>(p1)) & 7) !=
          0)
    return (int)cudaErrorInvalidValue;
  const float tw = (float)tile_w, th = (float)tile_h;
  const SegArgs g = {static_cast<const int*>(sitem),
                     static_cast<const float2*>(p0),
                     static_cast<const float2*>(p1),
                     static_cast<const int*>(n_segs),
                     static_cast<unsigned*>(sums),
                     static_cast<int*>(rows),
                     static_cast<int*>(hit_counts),
                     static_cast<int*>(hit_excl),
                     static_cast<int*>(n_hits),
                     n_slots,
                     tw,
                     th,
                     1.f / tw,
                     1.f / th};
  const int blocks = (n_slots + THREADS - 1) / THREADS;
  int err = 0;
  if (blocks > 1) err = launch(seg_count, blocks, false, stream, g);
  if (err == 0) err = launch(seg_rows, blocks, blocks > 1, stream, g);
  return err;
}
