// Kernel B: hit-record expansion with the exact per-tile tests.
//
// Replaces piet_tpu/ops/hitfuse.py::_hitfuse_kernel (behind
// hit_records_fused).  Record p finds its segment by binary search over
// the segments' inclusive hit cumsum, reads the 27-word segment row as raw
// uint32 (integer words stay integers: their f32 patterns are denormals,
// which a flush would destroy), decodes its tile with the exact f32
// divmod, and evaluates the reference's fill and stroke sign tests, the
// FillEdge intercept through div_det, the two command slots, the meta
// word, the sort key and the folded winding delta -- expression for
// expression as ops/hitfuse.py:189-353 (and piet_tpu_torch/ops/hitfuse.py,
// its plain version).  It writes 24 f32 words per record: 0-15 the entry
// words, then key, h_cand, n_cmds, cexcl, cand_end, d_val, d_cand, tile.
// The key is tile * stride + item * 2: the packed key for stride > 0, the
// second key of the unpacked two-key sort (item * 2) for stride == 0;
// word 23 is the tile, the unpacked sort's first key.  Both are +inf on a
// record without commands.  Records at or past the live total are all
// zero with key = tile = +inf.
//
// Bound on the H100: bytes -- 96 bytes written per record over the fitted
// capacity (~90k records, 8.6 MB at the 1664^2 tiger), against ~200
// dependent f32 operations per live record (div_det's seven candidates
// dominate) that a wave of 128-record blocks hides.  The TPU kernel
// expanded rows through the MXU in quarter-byte planes and received a
// lower bound of each block's segments by scalar prefetch; here:
//
// - A block of 128 records finds the segment of its first and of its last
//   live record once, each by a one-warp 32-way search (32 probes a step,
//   a ballot picks the next range; about four dependent loads over 2^16
//   segments; owner_search.cuh, shared with expand.cu).  Each thread then binary-searches only the segments its
//   block spans, a few, in lines the block has in L1.
// - A thread writes its 24 words into the block's rows in shared memory
//   (12 KB), and the block writes them out as one contiguous span of
//   16-byte words, so every warp store fills whole 32-byte sectors (a
//   thread's own scalar stores 96 bytes apart used 4 bytes of each).
// - Blocks wholly past the live total write the dead records' constant
//   pattern the same coalesced way, with no search and no segment read.
#include "cmd_math.cuh"
#include "owner_search.cuh"

namespace {

constexpr int SEG_WORDS = 27;
constexpr int OUT_WORDS = 24;
constexpr int OUT_VEC = OUT_WORDS / 4;  // 16-byte words per record
constexpr int K_KEY = 16;
constexpr int K_TILE = 23;
constexpr int BLOCK = 128;              // records per block

__device__ __forceinline__ float i2f(int v) { return __int_as_float(v); }

// Word k of a dead record: zero, key = tile = +inf.
__device__ __forceinline__ float dead_word(int k) {
  return (k == K_KEY || k == K_TILE) ? INFINITY : 0.f;
}

// Record p of segment row ``row`` (27 words): its 24 words into w.
__device__ __forceinline__ void hit_record(const int* __restrict__ row,
                                           int p, float (&w)[OUT_WORDS],
                                           int tile_w, int tile_h,
                                           int tiles_x, int stride,
                                           int row0) {
  using namespace piet;
  const float h_sx = i2f(row[0]), h_sy = i2f(row[1]), h_ex = i2f(row[2]),
              h_ey = i2f(row[3]);
  const float h_a = i2f(row[4]), h_b = i2f(row[5]), h_c = i2f(row[6]);
  const float xmn_x = i2f(row[7]), xmn_y = i2f(row[8]);
  const float xmx_x = i2f(row[9]), xmx_y = i2f(row[10]);
  const float h_hw = i2f(row[11]);
  const int h_flags = row[12];
  const int rxlo = row[13], rylo = row[14], rw = row[15];
  const int h_item = row[16], cexcl = row[17];
  const int by0 = row[18], bw = row[19], bx0 = row[20], by1 = row[21],
            bx1 = row[22];
  const float h_invd = i2f(row[23]), h_m = i2f(row[24]), h_K = i2f(row[25]);
  const int hexcl = row[26];

  // ---- tile decode (exact f32 divmod) ----
  int h_dy, h_dx;
  fdivmod(p - hexcl, max(rw, 1), &h_dy, &h_dx);
  const int h_ty = rylo + h_dy;
  const int h_tx = rxlo + h_dx;
  const int h_tile = (h_ty - row0) * tiles_x + h_tx;
  const int h_cand = cexcl + (h_ty - by0) * bw + (h_tx - bx0);
  const int cand_end = cexcl + (by1 - by0 + 1) * bw;

  const float twf = (float)tile_w, thf = (float)tile_h;
  const float x0f = (float)h_tx * twf;
  const float y0f = (float)h_ty * thf;
  const bool h_is_fill = (h_flags & 1) != 0;
  const bool h_is_stroke = (h_flags & 2) != 0;

  // ---- exact fill tests ----
  const bool ycull = (xmx_y >= y0f) && (xmn_y < y0f + thf);
  const float left = h_a * x0f;
  const float right = h_a * (x0f + twf);
  const float ytop = tmax(y0f, xmn_y);
  const float ybot = tmin(y0f + thf, xmx_y);
  const float top = h_b * ytop;
  const float bot = h_b * ybot;
  const float s00 = sgn(top + left + h_c);
  const float s01 = sgn(top + right + h_c);
  const float s10 = sgn(bot + left + h_c);
  const float s11 = sgn(bot + right + h_c);
  const bool four = s00 * s01 + s00 * s10 + s00 * s11 < 3.f;
  const bool crosses_left = (xmn_x < x0f) && (xmx_x > x0f);
  const float t_edge = div_det(h_sx - x0f, h_b);
  const float y_edge = h_sy + ((h_ey - h_sy) * t_edge);
  const bool edge_in = crosses_left && (y_edge >= y0f) && (y_edge < y0f + thf);
  const bool plain = (crosses_left && !edge_in && four) ||
                     (!crosses_left && four && (xmn_x < x0f + twf) &&
                      (xmx_x > x0f));
  const bool fill_emit_edge = h_is_fill && ycull && edge_in;
  const bool fill_emit_plain = h_is_fill && ycull && plain;
  const float clip_sx = h_b > 0.f ? h_sx : x0f;
  const float clip_sy = h_b > 0.f ? h_sy : y_edge;
  const float clip_ey = h_b > 0.f ? y_edge : h_ey;

  // ---- exact stroke tests ----
  bool st_bcull = (xmx_y > y0f - h_hw) && (xmn_y < y0f + thf + h_hw) &&
                  (xmx_x > x0f - h_hw) && (xmn_x < x0f + twf + h_hw);
  st_bcull = ((h_flags & 4) != 0) || st_bcull;
  const float sleft = h_a * (x0f - h_hw);
  const float sright = h_a * (x0f + twf + h_hw);
  const float stop_ = h_b * (y0f - h_hw);
  const float sbot = h_b * (y0f + thf + h_hw);
  const float z00 = sgn(stop_ + sleft + h_c);
  const float z01 = sgn(stop_ + sright + h_c);
  const float z10 = sgn(sbot + sleft + h_c);
  const float z11 = sgn(sbot + sright + h_c);
  const bool st_four = z00 * z01 + z00 * z10 + z00 * z11 < 3.f;
  const bool stroke_emit = h_is_stroke && st_bcull && st_four;

  // ---- command slots + entry words ----
  const bool slot0_valid = fill_emit_edge || stroke_emit;
  const bool slot1_valid = fill_emit_edge || fill_emit_plain;
  const int n_cmds = (slot0_valid ? 1 : 0) + (slot1_valid ? 1 : 0);
  const float tag0 =
      slot0_valid ? (stroke_emit ? (float)CMD_LINE : (float)CMD_FILL_EDGE)
                  : 0.f;
  const float tag1 = slot1_valid ? (float)CMD_FILL : 0.f;
  const float meta = (float)(n_cmds + (stroke_emit ? META_CLEAR_BIT : 0));
  const float key =
      n_cmds > 0 ? (float)(h_tile * stride + h_item * 2) : INFINITY;

  // ---- winding-delta emission: one crossing per (fill segment, row) ----
  const bool del_ok = h_is_fill && (h_a != 0.f) && (h_dx == 0) &&
                      (xmn_y <= y0f) && (xmx_y >= y0f) && (bx0 <= bx1);
  const float x_cross = -((h_b * y0f) + h_c) / h_a;
  const int tx_guess = wrap_add(f2i_sat(floorf(x_cross / twf)), 1);
  const float sign_a = sgn(h_a);
  auto dprobe = [&](int dtx) {
    const float x0p = (float)wrap_add(tx_guess, dtx) * twf;
    return sgn((h_a * x0p) + (h_b * y0f) + h_c) == sign_a;
  };
  const int tx_c = dprobe(-1) ? wrap_add(tx_guess, -1)
                   : dprobe(0) ? tx_guess
                   : dprobe(1) ? wrap_add(tx_guess, 1)
                               : wrap_add(tx_guess, 2);
  const int tx_eff = max(tx_c, bx0);
  const bool d_ok = del_ok && (tx_eff <= bx1);
  const int d_cand = cexcl + (h_ty - by0) * bw + (tx_eff - bx0);

  w[0] = tag0;
  w[1] = slot0_valid ? (stroke_emit ? h_sx : s00) : 0.f;
  w[2] = slot0_valid ? (stroke_emit ? h_sy : y_edge) : 0.f;
  w[3] = slot0_valid ? (stroke_emit ? h_ex : 0.f) : 0.f;
  w[4] = slot0_valid ? (stroke_emit ? h_ey : 0.f) : 0.f;
  w[5] = slot0_valid ? (stroke_emit ? h_hw : 0.f) : 0.f;
  w[6] = slot0_valid ? (stroke_emit ? h_invd : 0.f) : 0.f;
  w[7] = 0.f;
  w[8] = tag1;
  w[9] = slot1_valid ? (fill_emit_edge ? clip_sx : h_sx) : 0.f;
  w[10] = slot1_valid ? (fill_emit_edge ? clip_sy : h_sy) : 0.f;
  w[11] = slot1_valid ? (fill_emit_edge ? clip_ey : h_ey) : 0.f;
  w[12] = slot1_valid ? h_m : 0.f;
  w[13] = slot1_valid ? h_K : 0.f;
  w[14] = meta;
  w[15] = 0.f;
  w[16] = key;
  w[17] = (float)h_cand;
  w[18] = (float)n_cmds;
  w[19] = (float)cexcl;
  w[20] = (float)cand_end;
  w[21] = d_ok ? -sign_a : 0.f;
  w[22] = d_ok ? (float)d_cand : 0.f;
  w[K_TILE] = n_cmds > 0 ? (float)h_tile : INFINITY;
}

__global__ void __launch_bounds__(BLOCK)
hitfuse_kernel(const int* __restrict__ seg_rows,
               const int* __restrict__ counts,
               const int* __restrict__ excl,
               const int* __restrict__ total_p, float4* __restrict__ out,
               int n_seg, int cap, int tile_w, int tile_h, int tiles_x,
               int stride, int row0) {
  __shared__ float4 rows[BLOCK * OUT_VEC];
  __shared__ int span[2];
  const int p0 = blockIdx.x * BLOCK;
  const int n_rec = min(BLOCK, cap - p0);
  const int total = *total_p;
  float4* dst = out + (size_t)p0 * OUT_VEC;
  if (p0 >= total) {  // wholly dead: the constant pattern, coalesced
    for (int i = threadIdx.x; i < n_rec * OUT_VEC; i += BLOCK) {
      const int k = (i % OUT_VEC) * 4;
      dst[i] = make_float4(dead_word(k), dead_word(k + 1), dead_word(k + 2),
                           dead_word(k + 3));
    }
    return;
  }
  // The segments of the block's first and last live records.
  if (threadIdx.x < 64) {
    const int wp = threadIdx.x < 32 ? p0 : min(p0 + n_rec, total) - 1;
    const int sw = warp_search(counts, excl, n_seg, wp);
    if ((threadIdx.x & 31) == 0) span[threadIdx.x >> 5] = sw;
  }
  __syncthreads();
  const int p = p0 + threadIdx.x;
  if (threadIdx.x < n_rec) {
    float w[OUT_WORDS];
    if (p >= total) {
#pragma unroll
      for (int k = 0; k < OUT_WORDS; ++k) w[k] = dead_word(k);
    } else {
      int lo = span[0], hi = span[1];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (excl[mid] + counts[mid] > p) hi = mid; else lo = mid + 1;
      }
      // Clamped to the last segment (a total above the hit sum), as the
      // plain version's owner.
      lo = max(min(lo, n_seg - 1), 0);
      hit_record(seg_rows + (size_t)lo * SEG_WORDS, p, w, tile_w, tile_h,
                 tiles_x, stride, row0);
    }
#pragma unroll
    for (int v = 0; v < OUT_VEC; ++v)
      rows[threadIdx.x * OUT_VEC + v] =
          make_float4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rec * OUT_VEC; i += BLOCK) dst[i] = rows[i];
}

}  // namespace

extern "C" int piet_hitfuse(const void* seg_rows, const void* counts,
                            const void* excl, const void* total, void* out,
                            int n_seg, int cap, int tile_w, int tile_h,
                            int tiles_x, int stride, int row0,
                            cudaStream_t stream) {
  if (cap <= 0) return 0;
  hitfuse_kernel<<<(cap + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      static_cast<const int*>(seg_rows), static_cast<const int*>(counts),
      static_cast<const int*>(excl), static_cast<const int*>(total),
      static_cast<float4*>(out), n_seg, cap, tile_w, tile_h, tiles_x, stride,
      row0);
  return (int)cudaGetLastError();
}
