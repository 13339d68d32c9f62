// The numerics probes and microbenchmarks of the tools (the port's
// piet_tpu_torch/tools/): three kernels, each with its own C entry point.
//
// - probe_numerics replaces tools/mosaic_numerics_probe.py::run_pallas
//   (one Pallas kernel per fine-math op and shape) and
//   tools/div_probe.py::mosaic_div (out = a / b, its OP_DIV).  One kernel
//   templated on the op, elementwise; the ops are written as the fine
//   kernels write them: ieee_sqrt, srgb_encode and sat of cmd_math.cuh,
//   and the tool's fill_delta_chain expression (kernel D's fill_delta,
//   cmd_math.cuh, no longer evaluates it: its coverage is the difference
//   of two fill_F terms, whose sat and min1 the saturate_sub op runs).
//   Under the build's -prec-div=true the quotient is IEEE's, which is
//   what the division probe asks of the card.  Bound by bytes: each
//   thread takes 4 consecutive words, every operand read and the result
//   written as one 16-byte access with the streaming hints (the wrapper
//   checks the alignment); the last thread of a ragged n takes its 1-3
//   words one by one.
// - probe_halfmix replaces tools/half_experiment.py::run (the tool's
//   "~24-op" state chain of one fine entry, 16 f32 operations a step,
//   N_ITER times over a tile).  One block a tile, eight elements of a
//   row a thread (kernel D's band layout), the state in registers;
//   templated on the state's type: f32,
//   __nv_bfloat16, and __nv_bfloat162 (two bf16 to a 32-bit lane, which
//   Hopper's ALU runs as one instruction and the TPU's VPU does not
//   pack).  The compare is made in f32 in every type, as the tool makes
//   it.  Bound by operations; one tile leaves all but one SM idle, so
//   the tools also run 676 tiles (the 1664^2 tiger's count).
// - probe_delivery replaces tools/arg_delivery_bench.py::run (nine
//   kernels that deliver a fine entry's operands to the line_field_sq
//   chain in different ways).  One block a tile of 8, 16 or 32 rows of
//   128, every tile the same (the tool's grid is one tile, which fills a
//   TPU core's vector unit and 1/132 of the card: the tool also runs 676
//   tiles); per entry the chain over every pixel of the tile (or of its
//   row window), min-accumulated into a register state.  The TPU's
//   delivery mechanisms map to: SMEM scalars -> uniform loads from
//   device memory (every thread the same address, __ldg), entry j + 1's
//   words fetched while entry j's chain runs, as the TPU's scalar unit
//   has them ready ahead of the vector work; VMEM splats -> the entry
//   rows staged in shared memory a chunk at a time (cp.async,
//   double-buffered) and read as 16-byte broadcasts; sublane batches of
//   8 -> 8 staged entries an iteration, min-reduced before the state.
//   Bound by operations.  The kernels write the whole state (the tool
//   returns rows 0-7), so no row's work is dead code, and each tile's
//   count of (entry, row) chain updates: a minimum is idempotent, so the
//   state alone cannot show how many passes ran.
//
// The state of probe_halfmix starts from an input (the tool's 1, 2 and 0
// planes) read per element: every element of a tile holds the same
// values, and a state built from one scalar would let the compiler merge
// the eight chains of a thread into one.
#include <cuda_bf16.h>

#include "fine_common.cuh"

namespace {

constexpr int TILE_W = 128;                   // lanes of the tools' tiles
constexpr int PX = 8;                         // elements of a row a thread
constexpr int ROW_THREADS = TILE_W / PX;      // threads across a row
constexpr int ELEM_THREADS = 256;             // elementwise kernels
constexpr int VEC = 4;                        // words a thread, elementwise
constexpr int ENTRY_WORDS = 16;               // the tool's (N, 16) rows
constexpr int CHUNK = 128;                    // staged entries a buffer
constexpr float STATE_INIT = PIET_F32(1e18);  // the tool's st init

// ---- probe_numerics ----------------------------------------------------

// The tool's ops, in its order (mosaic_numerics_probe.OPS).
enum NumOp {
  OP_DIV, OP_SQRT, OP_MULADD2, OP_LERP, OP_FILL_DELTA_CHAIN, OP_SRGB_CHAIN,
  OP_IEEE_SQRT, OP_SATURATE_SUB, N_OPS
};

__host__ __device__ constexpr int num_inputs(int op) {
  return op == OP_MULADD2 ? 4
         : op == OP_LERP ? 3
         : op == OP_FILL_DELTA_CHAIN ? 5
         : (op == OP_DIV || op == OP_SATURATE_SUB) ? 2
                                                   : 1;
}

struct NumInputs {
  const float* p[5];
};

// The op on one word's operands v[0 .. num_inputs(OP)).
template <int OP>
__device__ __forceinline__ float num_op(const float* v) {
  const float a = v[0];
  if constexpr (OP == OP_DIV) {
    return a / v[1];
  } else if constexpr (OP == OP_SQRT) {
    return sqrtf(a);
  } else if constexpr (OP == OP_MULADD2) {
    return (a * v[1]) + (v[2] * v[3]);
  } else if constexpr (OP == OP_LERP) {
    return a + ((v[1] - a) * v[2]);
  } else if constexpr (OP == OP_FILL_DELTA_CHAIN) {
    const float t = (v[1] * v[1]) - (v[2] * v[2]);
    return ((a + (0.5f * t)) - v[3]) / (v[4] - v[3]);
  } else if constexpr (OP == OP_SRGB_CHAIN) {
    return (float)piet::srgb_encode(a);
  } else if constexpr (OP == OP_IEEE_SQRT) {
    return piet::ieee_sqrt(a);
  } else {
    // a - b is an arithmetic result, as sat requires.
    return piet::sat(a - v[1]);
  }
}

__device__ __forceinline__ float lane(const float4& f, int c) {
  return c == 0 ? f.x : c == 1 ? f.y : c == 2 ? f.z : f.w;
}

// Thread t: words 4t .. 4t + 3, each operand one 16-byte load and the
// result one 16-byte store, marked evict-first (__ldcs, __stcs: every
// word is touched once); where fewer than 4 words are left, those words
// one by one.
template <int OP>
__global__ void __launch_bounds__(ELEM_THREADS)
probe_numerics(NumInputs in, float* __restrict__ out, int n) {
  constexpr int K = num_inputs(OP);
  const int i = (blockIdx.x * ELEM_THREADS + threadIdx.x) * VEC;
  if (i + VEC <= n) {
    float4 x[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      x[k] = __ldcs(reinterpret_cast<const float4*>(in.p[k] + i));
    float r[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = lane(x[k], c);
      r[c] = num_op<OP>(v);
    }
    __stcs(reinterpret_cast<float4*>(out + i),
           make_float4(r[0], r[1], r[2], r[3]));
  } else {
    for (int j = i; j < n; ++j) {
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = in.p[k][j];
      out[j] = num_op<OP>(v);
    }
  }
}

// ---- probe_halfmix -----------------------------------------------------

// The state's type: T holds LANES elements.  Every op rounds once to the
// type (the _rn forms are never contracted into an FMA); min and max
// propagate a NaN, as jnp.minimum/maximum do.
struct MixF32 {
  using T = float;
  static constexpr int LANES = 1;
  static __device__ __forceinline__ T load(const float* p) { return p[0]; }
  static __device__ __forceinline__ void store(float* p, T v) { p[0] = v; }
  static __device__ __forceinline__ T splat(float c) { return c; }
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ T neg(T a) { return -a; }
  // The state never holds a zero (the chain keeps st0 = 1, st1 = 2 and a
  // = 3.25), so min.NaN's choice between zeros of opposite signs cannot
  // show.
  static __device__ __forceinline__ T vmin(T a, T b) {
    return piet::min_nan(a, b);
  }
  static __device__ __forceinline__ T vmax(T a, T b) {
    return piet::max_nan(a, b);
  }
  // yes where b > s in f32, else no.
  static __device__ __forceinline__ T gt_select(T b, T s, T yes, T no) {
    return b > s ? yes : no;
  }
};

struct MixBF16 {
  using T = __nv_bfloat16;
  static constexpr int LANES = 1;
  static __device__ __forceinline__ T load(const float* p) {
    return __float2bfloat16_rn(p[0]);
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    p[0] = __bfloat162float(v);
  }
  static __device__ __forceinline__ T splat(float c) {
    return __float2bfloat16_rn(c);
  }
  static __device__ __forceinline__ T mul(T a, T b) { return __hmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __hadd_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __hsub_rn(a, b); }
  static __device__ __forceinline__ T neg(T a) { return __hneg(a); }
  static __device__ __forceinline__ T vmin(T a, T b) {
    return __hmin_nan(a, b);
  }
  static __device__ __forceinline__ T vmax(T a, T b) {
    return __hmax_nan(a, b);
  }
  static __device__ __forceinline__ T gt_select(T b, T s, T yes, T no) {
    return __bfloat162float(b) > __bfloat162float(s) ? yes : no;
  }
};

struct MixBF16x2 {
  using T = __nv_bfloat162;
  static constexpr int LANES = 2;
  static __device__ __forceinline__ T load(const float* p) {
    return __floats2bfloat162_rn(p[0], p[1]);
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    const float2 f = __bfloat1622float2(v);
    p[0] = f.x;
    p[1] = f.y;
  }
  static __device__ __forceinline__ T splat(float c) {
    return __float2bfloat162_rn(c);
  }
  static __device__ __forceinline__ T mul(T a, T b) {
    return __hmul2_rn(a, b);
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return __hadd2_rn(a, b);
  }
  static __device__ __forceinline__ T sub(T a, T b) {
    return __hsub2_rn(a, b);
  }
  static __device__ __forceinline__ T neg(T a) { return __hneg2(a); }
  static __device__ __forceinline__ T vmin(T a, T b) {
    return __hmin2_nan(a, b);
  }
  static __device__ __forceinline__ T vmax(T a, T b) {
    return __hmax2_nan(a, b);
  }
  static __device__ __forceinline__ T gt_select(T b, T s, T yes, T no) {
    const float2 bf = __bfloat1622float2(b), sf = __bfloat1622float2(s);
    return __halves2bfloat162(
        bf.x > sf.x ? __low2bfloat16(yes) : __low2bfloat16(no),
        bf.y > sf.y ? __high2bfloat16(yes) : __high2bfloat16(no));
  }
};

// init: (3, rows, 128) f32, the st0/st1/st2 planes of one tile; out:
// (tiles, rows, 128) f32, st2 of every tile after n_iter steps.  Block =
// one tile, rows * 16 threads.
template <class M>
__global__ void __launch_bounds__(1024)
probe_halfmix(const float* __restrict__ init, float* __restrict__ out,
              int rows, int n_iter) {
  using T = typename M::T;
  constexpr int K = PX / M::LANES;
  const int tile = rows * TILE_W;
  const int px = threadIdx.x * PX;
  T s0[K], s1[K], s2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s0[k] = M::load(init + px + k * M::LANES);
    s1[k] = M::load(init + tile + px + k * M::LANES);
    s2[k] = M::load(init + 2 * tile + px + k * M::LANES);
  }
  const T c125 = M::splat(1.25f), c8 = M::splat(8.f), c05 = M::splat(0.5f),
          c0125 = M::splat(0.125f);
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T a = M::add(M::mul(s0[k], c125), s1[k]);
      const T b = M::vmax(M::vmin(a, c8), M::neg(a));
      const T c = M::gt_select(b, s2[k], M::add(M::mul(b, c05), s1[k]),
                               s2[k]);
      const T d = M::vmin(s0[k], M::add(M::mul(c, c), b));
      const T e = M::add(s2[k], M::mul(M::sub(d, b), c0125));
      s0[k] = M::vmin(s0[k], d);
      s1[k] = M::vmax(s1[k], e);
      s2[k] = e;
    }
  }
  float* o = out + (size_t)blockIdx.x * tile + px;
#pragma unroll
  for (int k = 0; k < K; ++k) M::store(o + k * M::LANES, s2[k]);
}

// ---- probe_delivery ----------------------------------------------------

// The tool's nine variants (arg_delivery_bench.main), in its order.
enum Variant {
  V_SMEM, V_VMEM, V_BATCH8, V_SMEM16, V_SMEM_WIN, V_BATCH8_16, V_SMEM32,
  V_SMEMW32, V_DISP16, N_VARIANTS
};
// How a variant's entries reach the chain.
enum Delivery { GLOBAL, STAGED, BATCH8, WINDOW, DISPATCH };

// The line_field_sq chain of one entry at one pixel, the per-entry terms
// (lvx, lvy, denom) given; min-accumulated into st.  dotp / denom is
// taken only where denom > 0, as the tool's select keeps it.
__device__ __forceinline__ float chain(float sx, float sy, float lvx,
                                       float lvy, float denom, float X,
                                       float Y, float st) {
  const float dpx = X - sx, dpy = Y - sy;
  const float dotp = (lvx * dpx) + (lvy * dpy);
  const float t = denom > 0.f ? piet::sat(dotp / denom) : 0.f;
  const float fx = (lvx * t) - dpx;
  const float fy = (lvy * t) - dpy;
  // The field is >= +0 and never a NaN; st is 1e18, a field, or (after a
  // dispatch multiply) +inf.
  return piet::min_nan(st, (fx * fx) + (fy * fy));
}

struct Entry {
  float sx, sy, lvx, lvy, denom;
};

__device__ __forceinline__ Entry entry_terms(float sx, float sy, float ex,
                                             float ey) {
  Entry e;
  e.sx = sx;
  e.sy = sy;
  e.lvx = ex - sx;
  e.lvy = ey - sy;
  e.denom = (e.lvx * e.lvx) + (e.lvy * e.lvy);
  return e;
}

__device__ __forceinline__ void update(float* st, const Entry& e,
                                       float x0, float Y) {
#pragma unroll
  for (int k = 0; k < PX; ++k)
    st[k] = chain(e.sx, e.sy, e.lvx, e.lvy, e.denom, x0 + (float)k, Y, st[k]);
}

// Start the cp.async copies of chunk c's entry rows into buf.
__device__ __forceinline__ void stage_chunk(float4* buf,
                                            const float4* __restrict__ src,
                                            int c) {
  constexpr int PIECES = CHUNK * ENTRY_WORDS / 4;
  for (int i = threadIdx.x; i < PIECES; i += blockDim.x)
    cp_async16(&buf[i], &src[(size_t)c * PIECES + i]);
}

// data: (n, 16) f32 entry rows, 16-byte aligned; out: (tiles, ROWS, 128)
// f32, each tile's state; passes: (tiles,) int32, each tile's chain
// updates, one per (entry pass, row).  One block a tile, ROWS * 16
// threads; thread (row, c0): 8 pixels of one row.
template <int ROWS, Delivery D>
__global__ void __launch_bounds__(ROWS * ROW_THREADS)
probe_delivery(const float* __restrict__ data, float* __restrict__ out,
               int* __restrict__ passes, int n, int reps) {
  const int row = threadIdx.x / ROW_THREADS;
  const float x0 = (float)((threadIdx.x % ROW_THREADS) * PX);
  const float Y = (float)row;
  const float4* rows4 = reinterpret_cast<const float4*>(data);
  float st[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) st[k] = STATE_INIT;
  int count = 0;  // this thread's chain updates

  if constexpr (D == STAGED || D == BATCH8) {
    __shared__ __align__(16) float4 stage[2][CHUNK * ENTRY_WORDS / 4];
    const int n_chunks = n / CHUNK;
    const int total = n_chunks * reps;
    stage_chunk(stage[0], rows4, 0);
    cp_async_commit();
    for (int q = 0; q < total; ++q) {
      if (q + 1 < total)
        stage_chunk(stage[(q + 1) & 1], rows4, (q + 1) % n_chunks);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      // Entry j's words 0-3 are float4 4j of the chunk: one broadcast.
      const float4* s = stage[q & 1];
      if constexpr (D == STAGED) {
        for (int j = 0; j < CHUNK; ++j) {
          const float4 e = s[j * (ENTRY_WORDS / 4)];
          update(st, entry_terms(e.x, e.y, e.z, e.w), x0, Y);
          ++count;
        }
      } else {
        for (int j = 0; j < CHUNK; j += 8) {
          float red[PX];
#pragma unroll
          for (int k = 0; k < PX; ++k) red[k] = STATE_INIT;
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const float4 e = s[(j + m) * (ENTRY_WORDS / 4)];
            update(red, entry_terms(e.x, e.y, e.z, e.w), x0, Y);
          }
          count += 8;
#pragma unroll
          for (int k = 0; k < PX; ++k) st[k] = piet::min_nan(st[k], red[k]);
        }
      }
      __syncthreads();
    }
  } else {
    // Words 0-3 (sx, sy, ex, ey) and, where the variant reads them, words
    // 4-7 (thr; the tag, the slot-1 tag): one 16-byte uniform load each,
    // entry j + 1's issued before entry j's chain.
    constexpr bool WIDE = D != GLOBAL;
    float4 a = __ldg(rows4), b = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (WIDE) b = __ldg(rows4 + 1);
    for (int r = 0; r < reps; ++r) {
      for (int j = 0; j < n; ++j) {
        const int next = (j + 1 < n ? j + 1 : 0) * (ENTRY_WORDS / 4);
        const float4 an = __ldg(rows4 + next);
        float4 bn = b;
        if constexpr (WIDE) bn = __ldg(rows4 + next + 1);
        const float sx = a.x, sy = a.y, ex = a.z, ey = a.w;
        if constexpr (D == GLOBAL) {
          update(st, entry_terms(sx, sy, ex, ey), x0, Y);
          ++count;
        } else if constexpr (D == WINDOW) {
          // The row window of the fine kernel's line_one: 8 rows from
          // rs when the line's band fits in them, else the whole tile.
          const float thr = b.x;
          const float lo = piet::tmin(sy, ey) - thr;
          const float hi = piet::tmax(sy, ey) + thr;
          const int rs = min(max((int)floorf(lo), 0), ROWS - 8);
          const bool fits = ((int)ceilf(hi) - rs) <= 8;
          if (!fits || (row >= rs && row < rs + 8)) {
            update(st, entry_terms(sx, sy, ex, ey), x0, Y);
            ++count;
          }
        } else {
          // The dispatch shape: a tag word, four class branches in the
          // tool's order (at most the first, second and last taken).
          const int tag = (int)b.y;
          if (tag == 3) {
            update(st, entry_terms(sx, sy, ex, ey), x0, Y);
            ++count;
          }
          if (tag == 6) {
#pragma unroll
            for (int k = 0; k < PX; ++k) st[k] = st[k] + sx;
          }
          if (b.z == 4.f) {
#pragma unroll
            for (int k = 0; k < PX; ++k) st[k] = piet::tmin(st[k], sy);
          }
          if (tag >= 5) {
#pragma unroll
            for (int k = 0; k < PX; ++k) st[k] = st[k] * ex;
          }
        }
        a = an;
        b = bn;
      }
    }
  }
  float* o = out + ((size_t)blockIdx.x * ROWS + row) * TILE_W +
             (threadIdx.x % ROW_THREADS) * PX;
#pragma unroll
  for (int k = 0; k < PX; ++k) o[k] = st[k];

  // The tile's count: per row the least of its 16 threads' counts (a
  // thread that skipped an update lowers it), summed over the rows.
#pragma unroll
  for (int off = ROW_THREADS / 2; off > 0; off >>= 1)
    count = min(count, __shfl_xor_sync(0xffffffffu, count, off));
  __shared__ int tile_count;
  if (threadIdx.x == 0) tile_count = 0;
  __syncthreads();
  if (threadIdx.x % ROW_THREADS == 0) atomicAdd(&tile_count, count);
  __syncthreads();
  if (threadIdx.x == 0) passes[blockIdx.x] = tile_count;
}

template <int ROWS, Delivery D>
int launch_delivery(const float* data, float* out, int* passes, int n,
                    int reps, int tiles, cudaStream_t stream) {
  probe_delivery<ROWS, D><<<tiles, ROWS * ROW_THREADS, 0, stream>>>(
      data, out, passes, n, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// op: NumOp; in0..in4: (n,) f32 operands, 16-byte aligned (those the op
// does not read may be any pointer); out: (n,) f32, 16-byte aligned.
extern "C" int piet_probe_numerics(int op, const void* in0, const void* in1,
                                   const void* in2, const void* in3,
                                   const void* in4, void* out, int n,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const NumInputs in{{static_cast<const float*>(in0),
                      static_cast<const float*>(in1),
                      static_cast<const float*>(in2),
                      static_cast<const float*>(in3),
                      static_cast<const float*>(in4)}};
  float* o = static_cast<float*>(out);
  const int grid = (n + ELEM_THREADS * VEC - 1) / (ELEM_THREADS * VEC);
  switch (op) {
#define PIET_NUM_CASE(OP)                                               \
  case OP:                                                              \
    probe_numerics<OP><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n);    \
    break;
    PIET_NUM_CASE(OP_DIV)
    PIET_NUM_CASE(OP_SQRT)
    PIET_NUM_CASE(OP_MULADD2)
    PIET_NUM_CASE(OP_LERP)
    PIET_NUM_CASE(OP_FILL_DELTA_CHAIN)
    PIET_NUM_CASE(OP_SRGB_CHAIN)
    PIET_NUM_CASE(OP_IEEE_SQRT)
    PIET_NUM_CASE(OP_SATURATE_SUB)
#undef PIET_NUM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// kind: 0 f32, 1 bf16, 2 packed bf16x2; init: (3, rows, 128) f32; out:
// (tiles, rows, 128) f32.  rows in [1, 64].
extern "C" int piet_probe_halfmix(const void* init, void* out, int kind,
                                  int rows, int tiles, int n_iter,
                                  cudaStream_t stream) {
  if (tiles <= 0) return 0;
  if (rows < 1 || rows * ROW_THREADS > 1024) return (int)cudaErrorInvalidValue;
  const float* i = static_cast<const float*>(init);
  float* o = static_cast<float*>(out);
  const int threads = rows * ROW_THREADS;
  switch (kind) {
    case 0: probe_halfmix<MixF32><<<tiles, threads, 0, stream>>>(i, o, rows, n_iter); break;
    case 1: probe_halfmix<MixBF16><<<tiles, threads, 0, stream>>>(i, o, rows, n_iter); break;
    case 2: probe_halfmix<MixBF16x2><<<tiles, threads, 0, stream>>>(i, o, rows, n_iter); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// variant: Variant; data: (n, 16) f32, n >= 1, 16-byte aligned, n a
// multiple of 128 for the staged variants; out: (tiles, rows of the
// variant, 128) f32; passes: (tiles,) int32.
extern "C" int piet_probe_delivery(const void* data, void* out, void* passes,
                                   int variant, int n, int reps, int tiles,
                                   cudaStream_t stream) {
  if (tiles <= 0) return 0;
  const float* d = static_cast<const float*>(data);
  float* o = static_cast<float*>(out);
  int* c = static_cast<int*>(passes);
  switch (variant) {
#define PIET_DELIVERY_CASE(V, ROWS, D) \
  case V: return launch_delivery<ROWS, D>(d, o, c, n, reps, tiles, stream);
    PIET_DELIVERY_CASE(V_SMEM, 8, GLOBAL)
    PIET_DELIVERY_CASE(V_VMEM, 8, STAGED)
    PIET_DELIVERY_CASE(V_BATCH8, 8, BATCH8)
    PIET_DELIVERY_CASE(V_SMEM16, 16, GLOBAL)
    PIET_DELIVERY_CASE(V_SMEM_WIN, 16, WINDOW)
    PIET_DELIVERY_CASE(V_BATCH8_16, 16, BATCH8)
    PIET_DELIVERY_CASE(V_SMEM32, 32, GLOBAL)
    PIET_DELIVERY_CASE(V_SMEMW32, 32, WINDOW)
    PIET_DELIVERY_CASE(V_DISP16, 16, DISPATCH)
#undef PIET_DELIVERY_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
