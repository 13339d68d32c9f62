// The coarse pass's entry rows and sort keys, before the sort: every hit
// record's 16 entry words and key(s), copied from kernel B's records, and
// every candidate's tail command (tag, operands, clip rect, bail colour,
// meta word) and key(s), derived from kernel A's record, its command count
// and its backdrop.  One launch, one thread an entry slot.
//
// Replaces no TPU kernel: the JAX package computes these words with XLA
// ops (piet_tpu/ops/coarse.py, the candidate tail commands, the row
// assembly and the sort keys), and the port's plain version is
// ops/cand_rows.py::cand_rows_plain, which runs for CPU tensors.  Run on
// the card, that version is ~130 device ops a frame: some 35 masks and 60
// selects over strided columns of the candidate records, a stack and two
// concatenations.
//
// Bound on the H100: the bytes moved.  A hit slot reads its record's first
// 16 words and key word and writes its row and key (136 bytes); a
// candidate slot reads 24 words of its record, its count, backdrop and
// tile and writes its row and key (176 bytes): 8.7 MB at the 4K tiger's
// 37,376 hit and 20,480 candidate slots, 0.0026 ms at 3.35 TB/s.  What the
// design does about it: one pass, every output word written once (rows as
// 16-byte words), no scratch, no concatenation, no atomics.
//
// A candidate's classes are exclusive (one item tag each; the fill classes
// by the CONT and gradient flags, the backdrop and the command count), so
// the thread picks its class once and writes that class's operands: the
// plain version's chain of selects, resolved.  The words are the plain
// version's bit for bit: the operands move as bit patterns, the only
// arithmetic is EndLayer's 2 * alpha, int32 -> f32 conversions round to
// nearest (__int2float_rn, as torch converts on the card), the flags'
// f32 -> int32 conversion saturates with NaN -> 0 (as torch's on the card),
// and "nonzero" is != 0.0f (-0.0 is zero) (tests/test_torch_cand_rows.py:
// a numpy model of this kernel against the plain version on the CPU, the
// kernel against the plain version on the card).
#include "cmd_math.cuh"

namespace {

using namespace piet;

constexpr int THREADS = 256;
constexpr int CAND_WORDS = 32;  // ops/candfuse.py: kernel A's records
constexpr int HIT_WORDS = 24;   // ops/hitfuse.py: kernel B's records
constexpr int K_KEY = 16, K_TILE = 23;
// scene/scene.py's item tags and flags.
constexpr int TAG_CIRCLE = 1, TAG_LINE = 2, TAG_FILL = 3, TAG_POLY = 4,
              TAG_CLIP = 5, TAG_POP = 6, TAG_LAYER = 7;
constexpr int FLAG_IN_GROUP = 2, FLAG_POP_LAYER = 4, FLAG_BRUSH_LINEAR = 8,
              FLAG_BRUSH_RADIAL = 16, FLAG_FILL_CONT = 32,
              FLAG_FILL_FINAL = 64;
constexpr int META_OPAQUE_BIT = 4;  // layout/entry_stream.py

// A candidate's class: the tail command it emits, or none.
enum Cls { NONE, CIRCLE, DRAWFILL, SOLID, STROKE, GRAD, WIND, CLIP, LAYER,
           POP };

struct RowArgs {
  const int4* ca;         // (n_cand_slots, 32) kernel A's candidate records
  const int* emit;        // (n_cand_slots,) hit commands a candidate
  const float* backdrop;  // (n_cand_slots,)
  const int* cand_tile;   // (n_cand_slots,)
  const int* n_cand;      // (1,) live candidates
  const int4* hits;       // (max_hits, 24) kernel B's records
  int4* rows;             // (max_hits + n_cand_slots, 16)
  int* key0;              // (max_hits + n_cand_slots,) f32 bits
  int* key1;              // the same, unpacked keys only; else null
  int max_hits, n_slots, stride;  // stride 0: unpacked keys
};

__device__ __forceinline__ int bits(float v) { return __float_as_int(v); }

// Hit slot s: its record's entry words and key word(s), as they are.
__device__ __forceinline__ void hit_slot(const RowArgs& g, int s) {
  const int4* rec = g.hits + (size_t)s * (HIT_WORDS / 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) g.rows[(size_t)s * 4 + j] = __ldg(rec + j);
  const int* w = reinterpret_cast<const int*>(rec);
  if (g.key1 == nullptr) {
    g.key0[s] = __ldg(w + K_KEY);
  } else {
    g.key0[s] = __ldg(w + K_TILE);
    g.key1[s] = __ldg(w + K_KEY);
  }
}

// Candidate i (slot s): its tail command's row and its key(s).
__device__ __forceinline__ void cand_slot(const RowArgs& g, int s, int i,
                                          int n_cand) {
  // Words 0-15 (colour, bbox, half width, flags, clip rect, item tag) and
  // 24-31 (the item, the gradient words); 16-23 are kernel A's own.
  int r[CAND_WORDS];
  const int4* rec = g.ca + (size_t)i * (CAND_WORDS / 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j == 4 || j == 5) continue;
    const int4 v = __ldg(rec + j);
    r[4 * j] = v.x;
    r[4 * j + 1] = v.y;
    r[4 * j + 2] = v.z;
    r[4 * j + 3] = v.w;
  }
  const int color_bits = r[9], tag_item = r[15], item = r[24];
  float col[4], bbox[4], clip[4], grad[7];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    col[k] = __int_as_float(r[k]);        // linear colour, words 0-3
    bbox[k] = __int_as_float(r[4 + k]);   // circle bbox, words 4-7
    clip[k] = __int_as_float(r[11 + k]);  // clip rect, words 11-14
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) grad[k] = __int_as_float(r[25 + k]);
  const float chw = __int_as_float(r[8]);
  const int flags = f2i_sat(__int_as_float(r[10]));
  const bool any = __ldg(g.emit + i) > 0;
  const float bd = __ldg(g.backdrop + i);
  const bool bd_nz = bd != 0.f;
  const bool valid = i < n_cand;
  const bool ingroup = (flags & FLAG_IN_GROUP) != 0;
  const bool rad = (flags & FLAG_BRUSH_RADIAL) != 0;
  const bool grad_item = (flags & FLAG_BRUSH_LINEAR) != 0 || rad;
  const bool cont = (flags & FLAG_FILL_CONT) != 0;
  const bool fin = (flags & FLAG_FILL_FINAL) != 0;
  const float even_odd = (float)(flags & 1);

  Cls c = NONE;
  if (!valid) {
  } else if (tag_item == TAG_CIRCLE) {
    c = CIRCLE;
  } else if (tag_item == TAG_FILL) {
    if (cont)
      c = bd_nz ? WIND : NONE;
    else if (grad_item)
      c = (any || bd_nz || fin) ? GRAD : NONE;
    else if (any || fin)
      c = DRAWFILL;
    else if (bd_nz)
      c = SOLID;
  } else if (tag_item == TAG_POLY || tag_item == TAG_LINE) {
    c = any ? STROKE : NONE;
  } else if (tag_item == TAG_CLIP) {
    c = CLIP;
  } else if (tag_item == TAG_LAYER) {
    c = LAYER;
  } else if (tag_item == TAG_POP) {
    c = POP;
  }
  const bool pop_layer = c == POP && (flags & FLAG_POP_LAYER) != 0;

  // Operands 0-7 and the rect (words 8-11), +0.0 where a class sets none.
  // No command: the selects' defaults, the colour shifted by one.
  float a[8] = {col[0], col[0], col[1], col[2], col[3], 0.f, 0.f, 0.f};
  float rect[4] = {clip[0], clip[1], clip[2], clip[3]};
  int tag = 0;
  switch (c) {
    case CIRCLE:
      tag = CMD_CIRCLE;
      for (int k = 0; k < 4; ++k) a[k] = bbox[k];
      a[4] = 0.f;
      break;
    case DRAWFILL:  // [backdrop, rgba, even_odd]
      tag = CMD_DRAW_FILL;
      a[0] = bd;
      a[5] = even_odd;
      break;
    case SOLID:  // [rgba]
      tag = CMD_SOLID;
      for (int k = 0; k < 4; ++k) a[k] = col[k];
      a[4] = 0.f;
      break;
    case STROKE:  // [half width, rgba]
      tag = CMD_STROKE;
      a[0] = chw;
      break;
    case GRAD:  // [backdrop, params3, c0 rgba, c1 rgba]
      tag = rad ? CMD_DRAW_RAD_GRAD : CMD_DRAW_LIN_GRAD;
      a[0] = bd;
      for (int k = 0; k < 3; ++k) a[1 + k] = grad[k];
      for (int k = 0; k < 4; ++k) a[4 + k] = col[k];
      for (int k = 0; k < 4; ++k) rect[k] = grad[3 + k];
      break;
    case WIND:  // [backdrop]
    case CLIP:  // [backdrop, even_odd]
    case LAYER:
    case POP:  // EndLayer [alpha]
      tag = c == WIND    ? CMD_WIND
            : c == CLIP  ? CMD_BEGIN_CLIP
            : c == LAYER ? CMD_BEGIN_LAYER
            : pop_layer  ? CMD_END_LAYER
                         : CMD_END_CLIP;
      for (int k = 0; k < 8; ++k) a[k] = 0.f;
      for (int k = 0; k < 4; ++k) rect[k] = 0.f;
      if (c == WIND || c == CLIP) a[0] = bd;
      if (c == CLIP) a[1] = even_odd;
      if (pop_layer) a[0] = 2.0f * chw;
      break;
    case NONE:
      break;
  }

  // A clipped or in-group solid cannot bail the tile.
  const bool unclipped = clip[0] == PIET_F32(-1e9) &&
                         clip[1] == PIET_F32(-1e9) &&
                         clip[2] == PIET_F32(1e9) && clip[3] == PIET_F32(1e9);
  const bool opaque = c == SOLID && (color_bits & 0xFF) == 0xFF &&
                      unclipped && !ingroup;
  const bool clearing = c == CIRCLE || c == DRAWFILL || c == STROKE ||
                        c == GRAD || c == CLIP || c == LAYER || c == POP ||
                        (c == SOLID && !(unclipped && !ingroup));
  const int meta = (int)(c != NONE) | (opaque ? META_OPAQUE_BIT : 0) |
                   (clearing ? META_CLEAR_BIT : 0);

  int4* row = g.rows + (size_t)s * 4;
  row[0] = make_int4(bits(__int2float_rn(tag)), bits(a[0]), bits(a[1]),
                     bits(a[2]));
  row[1] = make_int4(bits(a[3]), bits(a[4]), bits(a[5]), bits(a[6]));
  row[2] = make_int4(bits(a[7]), bits(rect[0]), bits(rect[1]),
                     bits(rect[2]));
  row[3] = make_int4(bits(rect[3]), opaque ? color_bits : 0,
                     bits(__int2float_rn(meta)), 0);

  // The key (tile, item, class 1): packed, or the two words.
  const int tile = __ldg(g.cand_tile + i);
  const int key_item = wrap_add(wrap_mul(item, 2), 1);
  const int inf = bits(INFINITY);
  if (g.key1 == nullptr) {
    const int k = wrap_add(wrap_mul(tile, g.stride), key_item);
    g.key0[s] = c != NONE ? bits(__int2float_rn(k)) : inf;
  } else {
    g.key0[s] = c != NONE ? bits(__int2float_rn(tile)) : inf;
    g.key1[s] = c != NONE ? bits(__int2float_rn(key_item)) : inf;
  }
}

__global__ void __launch_bounds__(THREADS) cand_rows_kernel(const RowArgs g) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= g.n_slots) return;
  if (s < g.max_hits)
    hit_slot(g, s);
  else
    cand_slot(g, s, s - g.max_hits, __ldg(g.n_cand));
}

}  // namespace

// ca (n_cand_slots, 32) and hits (max_hits, 24) int32 records and rows
// (max_hits + n_cand_slots, 16) int32, all 16-byte aligned; emit,
// backdrop (f32) and cand_tile (n_cand_slots,); n_cand (1,) int32; key0
// and, for unpacked keys (stride 0), key1 (max_hits + n_cand_slots,) f32.
// stride: the packed key's tile stride, 2 * (items + 1), or 0.
extern "C" int piet_cand_rows(const void* ca, const void* emit,
                              const void* backdrop, const void* cand_tile,
                              const void* n_cand, const void* hits,
                              void* rows, void* key0, void* key1,
                              int n_cand_slots, int max_hits, int stride,
                              cudaStream_t stream) {
  const size_t aligned = reinterpret_cast<size_t>(ca) |
                         reinterpret_cast<size_t>(hits) |
                         reinterpret_cast<size_t>(rows);
  if (n_cand_slots < 0 || max_hits < 0 || stride < 0 ||
      (aligned & 15) != 0 || (stride == 0) != (key1 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_slots = max_hits + n_cand_slots;
  if (n_slots == 0) return 0;
  const RowArgs g = {static_cast<const int4*>(ca),
                     static_cast<const int*>(emit),
                     static_cast<const float*>(backdrop),
                     static_cast<const int*>(cand_tile),
                     static_cast<const int*>(n_cand),
                     static_cast<const int4*>(hits),
                     static_cast<int4*>(rows),
                     static_cast<int*>(key0),
                     static_cast<int*>(key1),
                     max_hits,
                     n_slots,
                     stride};
  cand_rows_kernel<<<(n_slots + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      g);
  return (int)cudaGetLastError();
}
