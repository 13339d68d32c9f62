// The numerics probes and microbenchmarks of the tools (the port's
// piet_tpu_torch/tools/): four kernels, each with its own C entry point.
//
// - probe_div replaces tools/div_probe.py::mosaic_div (the Pallas kernel
//   out = a / b).  Elementwise, one thread a word; bound by bytes (two
//   words read, one written).  Under the build's -prec-div=true the
//   quotient is IEEE's, which is what the probe asks of the card.
// - probe_numerics replaces tools/mosaic_numerics_probe.py::run_pallas
//   (one Pallas kernel per fine-math op and shape).  One kernel templated
//   on the op, elementwise; the ops are written as the fine kernels
//   write them: ieee_sqrt, srgb_encode and sat of cmd_math.cuh, and the
//   tool's fill_delta_chain expression (kernel D's fill_delta,
//   cmd_math.cuh, no longer evaluates it: its coverage is the difference
//   of two fill_F terms, whose sat and min1 the saturate_sub op runs).
//   Bound by bytes.
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
//   chain in different ways).  One block, the tool's grid of one tile of
//   8, 16 or 32 rows of 128; per entry the chain over every pixel of the
//   tile (or of its row window), min-accumulated into a register state.
//   The TPU's delivery mechanisms map to: SMEM scalars -> uniform loads
//   from device memory (every thread the same address, __ldg); VMEM
//   splats -> the entry rows staged in shared memory a chunk at a time
//   (cp.async, double-buffered) and read as broadcasts; sublane batches
//   of 8 -> 8 staged entries an iteration, min-reduced before the state.
//   Bound by operations.  The kernels write the whole state (the tool
//   returns rows 0-7), so no row's work is dead code.
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
constexpr int ENTRY_WORDS = 16;               // the tool's (N, 16) rows
constexpr int CHUNK = 128;                    // staged entries a buffer
constexpr float STATE_INIT = PIET_F32(1e18);  // the tool's st init

// ---- probe_div -------------------------------------------------------

__global__ void __launch_bounds__(ELEM_THREADS)
probe_div(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out, int n) {
  const int i = blockIdx.x * ELEM_THREADS + threadIdx.x;
  if (i < n) out[i] = a[i] / b[i];
}

// ---- probe_numerics ----------------------------------------------------

// The tool's ops, in its order (mosaic_numerics_probe.OPS).
enum NumOp {
  OP_DIV, OP_SQRT, OP_MULADD2, OP_LERP, OP_FILL_DELTA_CHAIN, OP_SRGB_CHAIN,
  OP_IEEE_SQRT, OP_SATURATE_SUB, N_OPS
};

struct NumInputs {
  const float* p[5];
};

template <int OP>
__global__ void __launch_bounds__(ELEM_THREADS)
probe_numerics(NumInputs in, float* __restrict__ out, int n) {
  const int i = blockIdx.x * ELEM_THREADS + threadIdx.x;
  if (i >= n) return;
  const float a = in.p[0][i];
  float r;
  if constexpr (OP == OP_DIV) {
    r = a / in.p[1][i];
  } else if constexpr (OP == OP_SQRT) {
    r = sqrtf(a);
  } else if constexpr (OP == OP_MULADD2) {
    r = (a * in.p[1][i]) + (in.p[2][i] * in.p[3][i]);
  } else if constexpr (OP == OP_LERP) {
    const float f = in.p[1][i], w = in.p[2][i];
    r = a + ((f - a) * w);
  } else if constexpr (OP == OP_FILL_DELTA_CHAIN) {
    const float dq = in.p[1][i], cq = in.p[2][i], xmin = in.p[3][i],
                xmax = in.p[4][i];
    const float t = (dq * dq) - (cq * cq);
    r = ((a + (0.5f * t)) - xmin) / (xmax - xmin);
  } else if constexpr (OP == OP_SRGB_CHAIN) {
    r = (float)piet::srgb_encode(a);
  } else if constexpr (OP == OP_IEEE_SQRT) {
    r = piet::ieee_sqrt(a);
  } else {
    // a - b is an arithmetic result, as sat requires.
    r = piet::sat(a - in.p[1][i]);
  }
  out[i] = r;
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

// data: (n, 16) f32 entry rows; out: (ROWS, 128) f32, the state.  One
// block of ROWS * 16 threads; thread (row, c0): 8 pixels of one row.
template <int ROWS, Delivery D>
__global__ void __launch_bounds__(ROWS * ROW_THREADS)
probe_delivery(const float* __restrict__ data, float* __restrict__ out,
               int n, int reps) {
  __shared__ __align__(16) float4 stage[2][CHUNK * ENTRY_WORDS / 4];
  const int row = threadIdx.x / ROW_THREADS;
  const float x0 = (float)((threadIdx.x % ROW_THREADS) * PX);
  const float Y = (float)row;
  float st[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) st[k] = STATE_INIT;

  if constexpr (D == STAGED || D == BATCH8) {
    const float4* src = reinterpret_cast<const float4*>(data);
    const int n_chunks = n / CHUNK;
    const int total = n_chunks * reps;
    stage_chunk(stage[0], src, 0);
    cp_async_commit();
    for (int q = 0; q < total; ++q) {
      if (q + 1 < total) stage_chunk(stage[(q + 1) & 1], src, (q + 1) % n_chunks);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const float* s = reinterpret_cast<const float*>(stage[q & 1]);
      if constexpr (D == STAGED) {
        for (int j = 0; j < CHUNK; ++j) {
          const float* e = s + j * ENTRY_WORDS;
          update(st, entry_terms(e[0], e[1], e[2], e[3]), x0, Y);
        }
      } else {
        for (int j = 0; j < CHUNK; j += 8) {
          float red[PX];
#pragma unroll
          for (int k = 0; k < PX; ++k) red[k] = STATE_INIT;
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const float* e = s + (j + m) * ENTRY_WORDS;
            update(red, entry_terms(e[0], e[1], e[2], e[3]), x0, Y);
          }
#pragma unroll
          for (int k = 0; k < PX; ++k) st[k] = piet::min_nan(st[k], red[k]);
        }
      }
      __syncthreads();
    }
  } else {
    for (int r = 0; r < reps; ++r) {
      for (int j = 0; j < n; ++j) {
        const float* e = data + (size_t)j * ENTRY_WORDS;
        const float sx = __ldg(e), sy = __ldg(e + 1), ex = __ldg(e + 2),
                    ey = __ldg(e + 3);
        if constexpr (D == GLOBAL) {
          update(st, entry_terms(sx, sy, ex, ey), x0, Y);
        } else if constexpr (D == WINDOW) {
          // The row window of the fine kernel's line_one: 8 rows from
          // rs when the line's band fits in them, else the whole tile.
          const float thr = __ldg(e + 4);
          const float lo = piet::tmin(sy, ey) - thr;
          const float hi = piet::tmax(sy, ey) + thr;
          const int rs = min(max((int)floorf(lo), 0), ROWS - 8);
          const bool fits = ((int)ceilf(hi) - rs) <= 8;
          if (!fits || (row >= rs && row < rs + 8))
            update(st, entry_terms(sx, sy, ex, ey), x0, Y);
        } else {
          // The dispatch shape: a tag word, four class branches in the
          // tool's order (at most the first, second and last taken).
          const int tag = (int)__ldg(e + 5);
          if (tag == 3) update(st, entry_terms(sx, sy, ex, ey), x0, Y);
          if (tag == 6) {
#pragma unroll
            for (int k = 0; k < PX; ++k) st[k] = st[k] + sx;
          }
          if (__ldg(e + 6) == 4.f) {
#pragma unroll
            for (int k = 0; k < PX; ++k) st[k] = piet::tmin(st[k], sy);
          }
          if (tag >= 5) {
#pragma unroll
            for (int k = 0; k < PX; ++k) st[k] = st[k] * ex;
          }
        }
      }
    }
  }
  float* o = out + row * TILE_W + (threadIdx.x % ROW_THREADS) * PX;
#pragma unroll
  for (int k = 0; k < PX; ++k) o[k] = st[k];
}

template <int ROWS, Delivery D>
int launch_delivery(const float* data, float* out, int n, int reps,
                    cudaStream_t stream) {
  probe_delivery<ROWS, D><<<1, ROWS * ROW_THREADS, 0, stream>>>(data, out, n,
                                                                reps);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: (n,) f32.
extern "C" int piet_probe_div(const void* a, const void* b, void* out, int n,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  probe_div<<<(n + ELEM_THREADS - 1) / ELEM_THREADS, ELEM_THREADS, 0,
              stream>>>(static_cast<const float*>(a),
                        static_cast<const float*>(b),
                        static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// op: NumOp; in0..in4: (n,) f32 operands (those the op does not read may
// be any pointer); out: (n,) f32.
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
  const int grid = (n + ELEM_THREADS - 1) / ELEM_THREADS;
  switch (op) {
    case OP_DIV: probe_numerics<OP_DIV><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n); break;
    case OP_SQRT: probe_numerics<OP_SQRT><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n); break;
    case OP_MULADD2: probe_numerics<OP_MULADD2><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n); break;
    case OP_LERP: probe_numerics<OP_LERP><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n); break;
    case OP_FILL_DELTA_CHAIN: probe_numerics<OP_FILL_DELTA_CHAIN><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n); break;
    case OP_SRGB_CHAIN: probe_numerics<OP_SRGB_CHAIN><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n); break;
    case OP_IEEE_SQRT: probe_numerics<OP_IEEE_SQRT><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n); break;
    case OP_SATURATE_SUB: probe_numerics<OP_SATURATE_SUB><<<grid, ELEM_THREADS, 0, stream>>>(in, o, n); break;
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

// variant: Variant; data: (n, 16) f32, 16-byte aligned, n a multiple of
// 128 for the staged variants; out: (rows of the variant, 128) f32.
extern "C" int piet_probe_delivery(const void* data, void* out, int variant,
                                   int n, int reps, cudaStream_t stream) {
  const float* d = static_cast<const float*>(data);
  float* o = static_cast<float*>(out);
  switch (variant) {
    case V_SMEM: return launch_delivery<8, GLOBAL>(d, o, n, reps, stream);
    case V_VMEM: return launch_delivery<8, STAGED>(d, o, n, reps, stream);
    case V_BATCH8: return launch_delivery<8, BATCH8>(d, o, n, reps, stream);
    case V_SMEM16: return launch_delivery<16, GLOBAL>(d, o, n, reps, stream);
    case V_SMEM_WIN: return launch_delivery<16, WINDOW>(d, o, n, reps, stream);
    case V_BATCH8_16: return launch_delivery<16, BATCH8>(d, o, n, reps, stream);
    case V_SMEM32: return launch_delivery<32, GLOBAL>(d, o, n, reps, stream);
    case V_SMEMW32: return launch_delivery<32, WINDOW>(d, o, n, reps, stream);
    case V_DISP16: return launch_delivery<16, DISPATCH>(d, o, n, reps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
