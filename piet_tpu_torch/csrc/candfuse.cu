// Kernel A: the items' candidate rows, and their expansion into candidate
// records with exact tile decode.
//
// Replaces piet_tpu/ops/candfuse.py::_candfuse_kernel (the Pallas kernel
// behind cand_records_fused) and the XLA glue that feeds it
// (piet_tpu/ops/coarse.py:324-346: each item's tile rect, its candidate
// count, their exclusive scan and the (NI, 32) item rows).  Three
// kernels, three C entry points (the item rows, the expansion, both):
//
// - cand_prep: from the scene's fields, read in place, each item's tile
//   rect (floor division of the quantized bbox by the tile size, clamped
//   in the plain glue's order and windowed to the slab's tile rows), its
//   count w * h (0 for items at or past n_items, tag 0 or off the slab),
//   the exclusive scan of the counts (int32, wrapping as the cumsum), the
//   live total and the 32-word rows (colours, bbox as f32, half width,
//   colour bits, flags as f32, clip rect, the packed item ints, the item
//   id and the gradient payload).  A block takes 512 consecutive items,
//   one a thread, and scans them in shared memory.  Where there is more
//   than one block, cand_count runs first and writes each block's sum of
//   counts; cand_prep is a programmatic dependent launch behind it, and a
//   block adds up the sums of the blocks before it (NI / 2^18 words a
//   thread), so the scan's work grows linearly with NI and no scratch
//   needs zeroing.  A thread issues every load of its item's row before
//   anything waits on one (one round trip, overlapping cand_count) and
//   stages the row in shared memory (64 KB a block); the block's rows
//   then leave as one contiguous run of 16-byte stores.  Measured by
//   ab_kernels.py --cand-variants: each thread storing its own row (32
//   lines a warp store) took 4.4 us more of the tiger's call; 512 items a
//   block beat 1,024 on the tiger and on beziers_10k.
// - cand_expand: item i owns the row-major run of slots [excl[i],
//   excl[i] + counts[i]); slot p copies its owner's row as raw words (NaN
//   patterns and integer payload words pass untouched) and decodes its
//   tile (ty, tx) with the exact f32 divmod of ops/coarse.py::_fdivmod,
//   residue fixup included.  Slots at or past the live total get an
//   all-zero row and the decode of that zero row (ty = slot, tx = 0), as
//   the staged JAX path does.  As expand (expand.cu) does, after kernel
//   B: a block of 128 slots finds the owners of its first and last live
//   slot once by a one-warp 32-way search (owner_search.cuh), each slot
//   then searches only that span; the block's rows are read and written
//   as 16-byte words, 8 threads a row, one contiguous run of stores.
//   Blocks wholly past the total write zero rows and their decode with no
//   search.  tx is written only by the expansion alone: the coarse pass
//   does not read it.  Behind cand_prep it is a programmatic dependent
//   launch: its blocks start while cand_prep runs and wait for its rows.
//
// Bound on the H100: data movement (the 1664^2 tiger: 304 live items'
// rows, 32 + 3 words out per slot, ~0.47 MB in all), but calls this small
// are bound by latency: two or three launches and a chain of dependent
// loads (the prep's scan, the owner search, the row).  The TPU kernel
// expanded rows with a banded one-hot matmul because its vector core has
// no gather, and left the item rows to XLA: about 30 device ops of glue
// on the card.
#include "cmd_math.cuh"
#include "owner_search.cuh"

namespace {

constexpr int CAND_WORDS = 32;
constexpr int QUADS = CAND_WORDS / 4;   // 16-byte words a row
constexpr int W_CEXCL = 18, W_BX0 = 19, W_BY0 = 20, W_BW = 23;
constexpr int PREP_THREADS = 512;       // items a prep block, one a thread
constexpr int PREP_SMEM = PREP_THREADS * CAND_WORDS * 4;  // staged rows
constexpr int BLOCK = 128;              // slots an expansion block

// The scene's fields, row-major and contiguous; every word read as its
// 32-bit pattern.
struct Scene {
  const int* __restrict__ tags;        // (NI,)
  const int* __restrict__ colors_u32;  // (NI,)
  const int* __restrict__ colors_lin;  // (NI, 4) f32
  const int* __restrict__ widths;      // (NI,) f32
  const int* __restrict__ bboxes;      // (NI, 4)
  const int* __restrict__ pt_offset;   // (NI,)
  const int* __restrict__ n_pts;       // (NI,)
  const int* __restrict__ flags;       // (NI,) uint32 bits
  const int* __restrict__ clips;       // (NI, 4) f32
  const int* __restrict__ grads;       // (NI, 8) f32
  const int* __restrict__ n_items;     // ()
};

struct Grid {
  int tiles_x, tiles_y, tile_w, tile_h, row0;
};

// Programmatic dependent launch (Hopper), as in sort.cu.
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// int32 arithmetic that wraps, as torch's int32 tensors do.
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// torch.div(a, b, rounding_mode="floor") for b > 0 (C's / truncates).
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

struct Rect {
  int tag, x0, y0, x1, y1, w, h;
};

// ops/coarse.py::_item_tile_rect from the item's tag and bbox, clamps in
// its order, and the tag masked to live items.
__device__ __forceinline__ Rect item_rect(int tag, const int* bb, int i,
                                          int n_items, const Grid& g) {
  const bool active = i < n_items && tag > 0;
  Rect r;
  r.tag = active ? tag : 0;
  r.x0 = max(floor_div(bb[0], g.tile_w), 0);
  r.y0 = max(floor_div(bb[1], g.tile_h), g.row0);
  r.x1 = min(floor_div(bb[2], g.tile_w), g.tiles_x - 1);
  r.y1 = min(floor_div(bb[3], g.tile_h), g.row0 + g.tiles_y - 1);
  r.w = active ? max(wadd(wsub(r.x1, r.x0), 1), 0) : 0;
  r.h = active ? max(wadd(wsub(r.y1, r.y0), 1), 0) : 0;
  return r;
}

__device__ __forceinline__ unsigned item_count(const Scene& s, int i,
                                               int n_items, const Grid& g) {
  const int* bbp = s.bboxes + (size_t)i * 4;
  const int bb[4] = {bbp[0], bbp[1], bbp[2], bbp[3]};
  const Rect r = item_rect(s.tags[i], bb, i, n_items, g);
  return (unsigned)r.w * (unsigned)r.h;
}

// Exclusive scan of v over the block (PREP_THREADS threads, wrapping
// unsigned sums); *sum gets the block's total.  sh holds 32 words.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* sh,
                                               unsigned* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();  // sh is free (a previous scan's readers are done)
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  constexpr int WARPS = PREP_THREADS / 32;
  if (warp == 0) {
    unsigned t = lane < WARPS ? sh[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    sh[lane] = t;
  }
  __syncthreads();
  *sum = sh[WARPS - 1];
  return (warp ? sh[warp - 1] : 0u) + x - v;
}

__device__ __forceinline__ int i2f_bits(int x) {
  return __float_as_int(__int2float_rn(x));
}

// Each prep block's sum of counts, for the blocks after it.
__global__ void __launch_bounds__(PREP_THREADS)
cand_count(Scene s, Grid g, int ni, unsigned* __restrict__ sums) {
  let_next_start();
  __shared__ unsigned scan_sh[32];
  const int i = blockIdx.x * PREP_THREADS + threadIdx.x;
  const int n_items = *s.n_items;
  const unsigned count = i < ni ? item_count(s, i, n_items, g) : 0u;
  unsigned sum;
  block_scan(count, scan_sh, &sum);
  if (threadIdx.x == 0) sums[blockIdx.x] = sum;
}

__global__ void __launch_bounds__(PREP_THREADS)
cand_prep(Scene s, Grid g, int ni, const unsigned* __restrict__ sums,
          int4* __restrict__ cand_pack, int* __restrict__ counts,
          int* __restrict__ excl, int* __restrict__ total) {
  let_next_start();
  extern __shared__ int4 rows_sh[];  // PREP_THREADS rows of QUADS
  __shared__ unsigned scan_sh[32];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * PREP_THREADS;
  const int i = i0 + tid;
  const bool mine = i < ni;
  const int it = mine ? i : ni - 1;
  // Every word of this thread's item row is loaded before anything waits
  // on a load: one round trip.
  const int n_items = *s.n_items;
  const int tag = s.tags[it];
  int bb[4], col[4], clip[4], grad[7];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bb[k] = s.bboxes[(size_t)it * 4 + k];
    col[k] = s.colors_lin[(size_t)it * 4 + k];
    clip[k] = s.clips[(size_t)it * 4 + k];
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) grad[k] = s.grads[(size_t)it * 8 + k];
  const int width = s.widths[it], colour = s.colors_u32[it];
  const int flags = s.flags[it], n_pts = s.n_pts[it];
  const int pt_offset = s.pt_offset[it];
  // The counts of the items before this block: cand_count's sums of the
  // blocks before it.
  unsigned before = 0;
  if (blockIdx.x > 0) {
    wait_prior();
    for (int j = tid; j < (int)blockIdx.x; j += PREP_THREADS)
      before += sums[j];
  }
  unsigned base;
  block_scan(before, scan_sh, &base);
  // This block's items, one a thread.
  const Rect r = item_rect(tag, bb, i, n_items, g);
  const unsigned count = mine ? (unsigned)r.w * (unsigned)r.h : 0u;
  unsigned block_sum;
  const int e = (int)(base + block_scan(count, scan_sh, &block_sum));
  if (mine) {
    counts[i] = (int)count;
    excl[i] = e;
    if (i == ni - 1) *total = wadd(e, (int)count);
    // The row: colours 0-3, bbox 4-7, half width 8, colour bits 9, flags
    // 10, clip 11-14, item ints 15-23, item id 24, gradient payload 25-31;
    // staged with its 16-byte words swizzled by row (conflict-free both
    // ways).
    int4* st = rows_sh + tid * QUADS;
    const int sw = tid & (QUADS - 1);
    st[0 ^ sw] = make_int4(col[0], col[1], col[2], col[3]);
    st[1 ^ sw] = make_int4(i2f_bits(bb[0]), i2f_bits(bb[1]),
                           i2f_bits(bb[2]), i2f_bits(bb[3]));
    st[2 ^ sw] = make_int4(
        __float_as_int(__fmul_rn(0.5f, __int_as_float(width))), colour,
        i2f_bits(flags), clip[0]);
    st[3 ^ sw] = make_int4(clip[1], clip[2], clip[3], r.tag);
    st[4 ^ sw] = make_int4(n_pts, pt_offset, e, r.x0);
    st[5 ^ sw] = make_int4(r.y0, r.x1, r.y1, r.w);
    st[6 ^ sw] = make_int4(i, grad[0], grad[1], grad[2]);
    st[7 ^ sw] = make_int4(grad[3], grad[4], grad[5], grad[6]);
  }
  __syncthreads();
  // The block's rows leave as one contiguous run of 16-byte stores.
  const int n_quads = min(PREP_THREADS, ni - i0) * QUADS;
  int4* dst = cand_pack + (size_t)i0 * QUADS;
  for (int k = tid; k < n_quads; k += PREP_THREADS) {
    const int row = k / QUADS;
    dst[k] = rows_sh[row * QUADS + ((k % QUADS) ^ (row & (QUADS - 1)))];
  }
}

// Slot p's tile from its row's words (all zero past the total).
__device__ __forceinline__ void decode(int p, int cexcl, int bx0, int by0,
                                       int bw, const Grid& g,
                                       int* __restrict__ tile,
                                       int* __restrict__ ty,
                                       int* __restrict__ tx) {
  int dy, dx;
  piet::fdivmod(wsub(p, cexcl), max(bw, 1), &dy, &dx);
  const int cty = wadd(by0, dy), ctx = wadd(bx0, dx);
  ty[p] = cty;
  if (tx) tx[p] = ctx;
  tile[p] = wadd(wmul(wsub(cty, g.row0), g.tiles_x), ctx);
}

__global__ void __launch_bounds__(BLOCK)
cand_expand(const int4* __restrict__ cand_pack,
            const int* __restrict__ counts, const int* __restrict__ excl,
            const int* __restrict__ total_p, int4* __restrict__ ca,
            int* __restrict__ tile, int* __restrict__ ty,
            int* __restrict__ tx, int ni, int cap, Grid g) {
  __shared__ int own[BLOCK];   // each slot's owner, -1 past the total
  __shared__ int span[2];
  wait_prior();
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * BLOCK;
  const int n_slot = min(BLOCK, cap - p0);
  const int total = *total_p;
  int4* dst = ca + (size_t)p0 * QUADS;
  if (p0 >= total) {  // wholly dead: zero rows and their decode
    for (int k = tid; k < n_slot * QUADS; k += BLOCK)
      dst[k] = make_int4(0, 0, 0, 0);
    if (tid < n_slot) decode(p0 + tid, 0, 0, 0, 0, g, tile, ty, tx);
    return;
  }
  // The owners of the block's first and last live slots.
  if (tid < 64) {
    const int wp = tid < 32 ? p0 : min(p0 + n_slot, total) - 1;
    const int o = warp_search(counts, excl, ni, wp);
    if ((tid & 31) == 0) span[tid >> 5] = o;
  }
  __syncthreads();
  if (tid < n_slot) {
    const int p = p0 + tid;
    int lo = -1;
    if (p < total) {
      lo = span[0];
      int hi = span[1];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (excl[mid] + counts[mid] > p) hi = mid; else lo = mid + 1;
      }
      // Clamped to the last item, as the plain version's owner.
      lo = min(lo, ni - 1);
    }
    own[tid] = lo;
  }
  __syncthreads();
  for (int k = tid; k < n_slot * QUADS; k += BLOCK) {
    const int o = own[k / QUADS];
    dst[k] = o >= 0 ? cand_pack[(size_t)o * QUADS + k % QUADS]
                    : make_int4(0, 0, 0, 0);
  }
  if (tid < n_slot) {
    const int o = own[tid];
    int cexcl = 0, bx0 = 0, by0 = 0, bw = 0;
    if (o >= 0) {
      const int* w = reinterpret_cast<const int*>(cand_pack + (size_t)o *
                                                              QUADS);
      cexcl = w[W_CEXCL];
      bx0 = w[W_BX0];
      by0 = w[W_BY0];
      bw = w[W_BW];
    }
    decode(p0 + tid, cexcl, bx0, by0, bw, g, tile, ty, tx);
  }
}

int set_prep_smem() {
  return (int)cudaFuncSetAttribute(
      cand_prep, cudaFuncAttributeMaxDynamicSharedMemorySize, PREP_SMEM);
}

// launch with programmatic stream serialization (behind the kernel before
// it on the stream) where `dependent`, else as a plain launch.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, int smem,
           bool dependent, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// cand_count (more than one block) and cand_prep behind it.
int launch_prep(const Scene& s, const Grid& g, int ni, void* sums,
                void* cand_pack, void* counts, void* excl, void* total,
                cudaStream_t stream) {
  if (ni <= 0 || g.tile_w <= 0 || g.tile_h <= 0 ||
      (reinterpret_cast<size_t>(cand_pack) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (ni + PREP_THREADS - 1) / PREP_THREADS;
  unsigned* u = static_cast<unsigned*>(sums);
  int err = set_prep_smem();
  if (err == 0 && blocks > 1)
    err = launch(cand_count, dim3(blocks), PREP_THREADS, 0, false, stream, s,
                 g, ni, u);
  if (err == 0)
    err = launch(cand_prep, dim3(blocks), PREP_THREADS, PREP_SMEM,
                 blocks > 1, stream, s, g, ni, (const unsigned*)u,
                 static_cast<int4*>(cand_pack), static_cast<int*>(counts),
                 static_cast<int*>(excl), static_cast<int*>(total));
  return err;
}

int launch_expand(const Grid& g, int ni, int cap, const void* cand_pack,
                  const void* counts, const void* excl, const void* total,
                  void* ca, void* tile, void* ty, void* tx, bool dependent,
                  cudaStream_t stream) {
  if (ni <= 0 || ((reinterpret_cast<size_t>(cand_pack) |
                   reinterpret_cast<size_t>(ca)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (cap <= 0) return 0;
  return launch(cand_expand, dim3((cap + BLOCK - 1) / BLOCK), BLOCK, 0,
                dependent, stream, static_cast<const int4*>(cand_pack),
                static_cast<const int*>(counts),
                static_cast<const int*>(excl),
                static_cast<const int*>(total), static_cast<int4*>(ca),
                static_cast<int*>(tile), static_cast<int*>(ty),
                static_cast<int*>(tx), ni, cap, g);
}

}  // namespace

// The scene's fields, in candfuse.py's SCENE_FIELDS order, then n_items.
#define PIET_SCENE_PARAMS                                               \
  const void* tags, const void* colors_u32, const void* colors_lin,     \
      const void* widths, const void* bboxes, const void* pt_offset,    \
      const void* n_pts, const void* flags, const void* clips,          \
      const void* grads, const void* n_items
#define PIET_SCENE                                                      \
  Scene {                                                               \
    static_cast<const int*>(tags), static_cast<const int*>(colors_u32), \
        static_cast<const int*>(colors_lin),                            \
        static_cast<const int*>(widths), static_cast<const int*>(bboxes), \
        static_cast<const int*>(pt_offset), static_cast<const int*>(n_pts), \
        static_cast<const int*>(flags), static_cast<const int*>(clips), \
        static_cast<const int*>(grads), static_cast<const int*>(n_items) \
  }

// The item rows: from the scene's fields (ni items, contiguous int32/f32),
// cand_pack (ni, 32) int32 (16-byte aligned), counts and excl (ni,) and
// total (1,).  sums: (ceil(ni / 512),) int32 scratch.
extern "C" int piet_cand_prep(PIET_SCENE_PARAMS, void* sums, void* cand_pack,
                              void* counts, void* excl, void* total, int ni,
                              int tiles_x, int tiles_y, int tile_w,
                              int tile_h, int row0, cudaStream_t stream) {
  const Grid g = {tiles_x, tiles_y, tile_w, tile_h, row0};
  return launch_prep(PIET_SCENE, g, ni, sums, cand_pack, counts, excl, total,
                     stream);
}

// The expansion alone: cand_pack (ni, 32), counts, excl (ni,) and total
// (1,) into ca (cap, 32) int32 (16-byte aligned), tile, ty and tx (cap,).
extern "C" int piet_cand_expand(const void* cand_pack, const void* counts,
                                const void* excl, const void* total,
                                void* ca, void* tile, void* ty, void* tx,
                                int ni, int cap, int tiles_x, int row0,
                                cudaStream_t stream) {
  const Grid g = {tiles_x, 0, 0, 0, row0};
  return launch_expand(g, ni, cap, cand_pack, counts, excl, total, ca, tile,
                       ty, tx, false, stream);
}

// Both, as the coarse pass calls them: piet_cand_prep's outputs, then
// their expansion into ca, tile and ty (no tx) as a programmatic
// dependent launch behind them.
extern "C" int piet_cand_stage(PIET_SCENE_PARAMS, void* sums,
                               void* cand_pack, void* counts, void* excl,
                               void* total, void* ca, void* tile, void* ty,
                               int ni, int cap, int tiles_x, int tiles_y,
                               int tile_w, int tile_h, int row0,
                               cudaStream_t stream) {
  const Grid g = {tiles_x, tiles_y, tile_w, tile_h, row0};
  const int err = launch_prep(PIET_SCENE, g, ni, sums, cand_pack, counts,
                              excl, total, stream);
  if (err != 0) return err;
  return launch_expand(g, ni, cap, cand_pack, counts, excl, total, ca, tile,
                       ty, nullptr, true, stream);
}
