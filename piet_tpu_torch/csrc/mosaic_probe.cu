// The access-pattern probes of tools/mosaic_probe.py (the port's
// piet_tpu_torch/tools/mosaic_probe.py): two kernels, each with its own C
// entry point.
//
// - probe_mosaic replaces tools/mosaic_probe.py::_compile, which compiles
//   one small Pallas kernel per probe: grid (4,) run in order on one core,
//   a (16, 128) f32 input in VMEM, an (8, 128) f32 output whose block is
//   (0, 0) at every step (resident, so the result is what step 3 left),
//   and the probe's scratch, whose contents carry from step to step.  Here
//   one __global__ template is instantiated once per probe (the
//   counterpart of one Pallas kernel per probe).  One block of 128
//   threads, one a lane, runs the four steps in order; the input is
//   staged in shared memory (a probe reads other lanes' words), the
//   scratch is shared memory of the shape the tool's SCRATCH declares,
//   filled with the caller's fill word before step 0 (the interpreter's
//   default 0x7fc00000, or 0), and __syncthreads() stands wherever a step
//   writes scratch that another lane then reads, and after every step.
//   The output rows of a lane live in registers and are stored after
//   step 3.  Each probe computes what its Pallas body computes, op for op
//   (under the build's -fmad=false no multiply and add contract).
//   Launch-latency bound: one block, 12 KiB of traffic.
// - probe_dma16 replaces tools/mosaic_probe.py::_compile_dma16 and its
//   kernel _dma16_kernel: at each of the four steps an async copy of 512
//   rows x 16 lanes from device memory into slot 1 of a (4, 512, 16) f32
//   scratch, a wait on its DMA semaphore, then a splat of t[1, i, 3].  On
//   Hopper the copy is a bulk async copy (TMA's 1-D cp.async.bulk, 32 KiB,
//   16-byte aligned) that completes on an mbarrier, and the wait is the
//   mbarrier's phase.  The scratch is 128 KiB of dynamic shared memory, an
//   opt-in above 48 KiB (cudaFuncAttributeMaxDynamicSharedMemorySize); a
//   refused attribute or launch returns its error.  Launch-latency bound.
//
// NaN words.  Scratch a probe reads before writing holds the fill word,
// so with the NaN fill some results are NaNs.  The CPU (and the Pallas
// interpreter on it) gives an arithmetic op's NaN result the bits of its
// first NaN operand, quieted; Hopper's ALU returns the canonical
// 0x7fffffff.  The ops below (add, mul, vmin) give the CPU's words, so the
// kernel's output equals its plain version's (ops/probes.py) bit for bit
// at either fill.  Opposite-sign zero pairs never reach vmin here (the
// probes' inputs are random normals and the zero fill is +0).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LANES = 128;     // lanes of the input and output
constexpr int IN_ROWS = 16;    // the input's sublanes
constexpr int OUT_ROWS = 8;    // the output's sublanes
constexpr int STEPS = 4;       // the tool's grid
constexpr unsigned QUIET = 0x00400000u;
constexpr unsigned CPU_DEFAULT_NAN = 0xffc00000u;

// The tool's probes, in PROBES order (dma_16lane is probe_dma16).
enum Probe {
  LANE_SLICE_COMPUTED, LANE_SLICE_REF, LANE_SLICE_REF_DYN, ROLL_DYNAMIC,
  SUBLANE_DYN_LOAD, STACK_SCALARS, TRANSPOSE_BLOCK, BCAST_AND_REDUCE,
  RMW_DYN_ROW, MAJOR_DYN_SCRATCH, PAIR_ROWS_BCAST, DYNSUB_STATLANE, SPLAT11,
  GROUPED_SUM_RESHAPE, ROLL_TREE_SUM, REPEAT_SUB, CONCAT0_41, SPLAT11_CHAIN,
  SPLAT11_MUL, SPLAT11_CONCAT, SPLAT11_REPEAT, DYN2_READ, N_PROBES
};

// Words of a probe's scratch (the tool's SCRATCH): (4, 16, 128) and
// (8, 8, 128) f32, a (128, 16) transpose target, a (32, 128)
// accumulator, or 8 SMEM scalars.
__host__ __device__ constexpr int scratch_words(int p) {
  return p == DYN2_READ || p == MAJOR_DYN_SCRATCH ? 8192
         : p == RMW_DYN_ROW                       ? 4096
         : p == SPLAT11_CONCAT || p == SPLAT11_REPEAT || p == SPLAT11_MUL ||
                 p == SPLAT11_CHAIN || p == DYNSUB_STATLANE ||
                 p == SPLAT11 || p == TRANSPOSE_BLOCK
             ? LANES * IN_ROWS
         : p == STACK_SCALARS ? 8
                              : 0;
}

__device__ __forceinline__ float quiet(float a) {
  return __uint_as_float(__float_as_uint(a) | QUIET);
}

// r, the result of an op on a and b, with the CPU's NaN word.
__device__ __forceinline__ float cpu_nan(float r, float a, float b) {
  if (!isnan(r)) return r;
  return isnan(a) ? quiet(a)
         : isnan(b) ? quiet(b)
                    : __uint_as_float(CPU_DEFAULT_NAN);
}

__device__ __forceinline__ float add(float a, float b) {
  return cpu_nan(a + b, a, b);
}

__device__ __forceinline__ float mul(float a, float b) {
  return cpu_nan(a * b, a, b);
}

// jnp.minimum: a NaN operand gives a NaN (fminf would drop it).
__device__ __forceinline__ float vmin(float a, float b) {
  return isnan(a) ? quiet(a) : isnan(b) ? quiet(b) : fminf(a, b);
}

// xs: the input staged as (16, 128); t: the probe's scratch; o: this
// lane's 8 output rows.  Step i of probe P at lane c.
template <int P>
__device__ __forceinline__ void step(int i, int c, const float* xs, float* t,
                                     float (&o)[OUT_ROWS]) {
  auto x = [xs](int r, int l) { return xs[r * LANES + l]; };
  // t[:] = x.T, a (128, 16) scratch.
  auto transpose = [&]() {
#pragma unroll
    for (int k = 0; k < IN_ROWS; ++k) t[c * IN_ROWS + k] = x(k, c);
    __syncthreads();
  };
  if constexpr (P == LANE_SLICE_COMPUTED) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(0.f, mul(x(r, 3), 2.f));
  } else if constexpr (P == LANE_SLICE_REF) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(0.f, x(r, 3));
  } else if constexpr (P == LANE_SLICE_REF_DYN) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(0.f, x(r, i));
  } else if constexpr (P == ROLL_DYNAMIC) {
    // pltpu.roll(v, 16 i, 1) = np.roll: lane c takes lane c - 16 i.
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = x(r, (c - 16 * i) & (LANES - 1));
  } else if constexpr (P == SUBLANE_DYN_LOAD) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = x(i + (r & 3), c);
  } else if constexpr (P == STACK_SCALARS) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(0.f, t[r]);
  } else if constexpr (P == TRANSPOSE_BLOCK) {
    transpose();
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(0.f, t[0]);
  } else if constexpr (P == BCAST_AND_REDUCE) {
    // f = a * xs + a, a = x[0:8, 0:1], xs = x[0:1, :]; min over sublanes.
    const float xs0 = x(0, c);
    float red = add(mul(x(0, 0), xs0), x(0, 0));
#pragma unroll
    for (int r = 1; r < OUT_ROWS; ++r)
      red = vmin(red, add(mul(x(r, 0), xs0), x(r, 0)));
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(0.f, red);
  } else if constexpr (P == RMW_DYN_ROW) {
    // acc[i] = min(acc[i], x[0]); out = acc[0:8].  A lane touches only
    // its own column.
    t[i * LANES + c] = vmin(t[i * LANES + c], x(0, c));
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = t[r * LANES + c];
  } else if constexpr (P == MAJOR_DYN_SCRATCH) {
    // g[0] = x[0:8]; out = g[i, :, 2:3] splat.
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) t[r * LANES + c] = x(r, c);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r)
      o[r] = add(0.f, t[(i * OUT_ROWS + r) * LANES + 2]);
  } else if constexpr (P == PAIR_ROWS_BCAST || P == REPEAT_SUB) {
    // [a0, a0, a1, a1, a2, a2, a3, a3], a = x[0:4, 0:1].
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(0.f, x(r >> 1, 0));
  } else if constexpr (P == DYNSUB_STATLANE) {
    transpose();
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r)
      o[r] = add(0.f, t[(4 * i + (r & 3)) * IN_ROWS + 2]);
  } else if constexpr (P == SPLAT11 || P == SPLAT11_CHAIN ||
                       P == SPLAT11_MUL) {
    // x[0:8] * a + b with a = t[i, 2], b = t[i, 3] (times a (8, 1) of
    // ones for splat11_mul).
    transpose();
    float a = t[i * IN_ROWS + 2], b = t[i * IN_ROWS + 3];
    if constexpr (P == SPLAT11_MUL) {
      a = mul(a, 1.f);
      b = mul(b, 1.f);
    }
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(mul(x(r, c), a), b);
  } else if constexpr (P == GROUPED_SUM_RESHAPE) {
    // Sums of rows 0-3 and 4-7, in order; out = [s0, s1] * 4.
    float s[2];
#pragma unroll
    for (int g = 0; g < 2; ++g)
      s[g] = add(add(add(x(4 * g, c), x(4 * g + 1, c)), x(4 * g + 2, c)),
                 x(4 * g + 3, c));
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = s[r & 1];
  } else if constexpr (P == ROLL_TREE_SUM) {
    // s += roll(s, k, 0) for k = 4, 2, 1 (np.roll: row r takes r - k).
    float s[OUT_ROWS], u[OUT_ROWS];
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) s[r] = x(r, c);
#pragma unroll
    for (int k = 4; k >= 1; k >>= 1) {
#pragma unroll
      for (int r = 0; r < OUT_ROWS; ++r) u[r] = add(s[r], s[(r - k) & 7]);
#pragma unroll
      for (int r = 0; r < OUT_ROWS; ++r) s[r] = u[r];
    }
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = s[r];
  } else if constexpr (P == CONCAT0_41) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = add(0.f, x(r & 3, 0));
  } else if constexpr (P == SPLAT11_CONCAT || P == SPLAT11_REPEAT) {
    transpose();
    const float a = t[i * IN_ROWS + 2];
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = mul(x(r, c), a);
  } else if constexpr (P == DYN2_READ) {
    // g[0] = x; out = g[i, 2 i, 2] splat.
#pragma unroll
    for (int r = 0; r < IN_ROWS; ++r) t[r * LANES + c] = x(r, c);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r)
      o[r] = add(0.f, t[(i * IN_ROWS + 2 * i) * LANES + 2]);
  }
}

// x: (16, 128) f32; out: (8, 128) f32.  One block of 128 threads.
template <int P>
__global__ void __launch_bounds__(LANES)
probe_mosaic(const float* __restrict__ x, float* __restrict__ out,
             unsigned fill) {
  constexpr int SW = scratch_words(P) > 0 ? scratch_words(P) : 1;
  __shared__ float xs[IN_ROWS * LANES];
  __shared__ float t[SW];
  const int c = threadIdx.x;
#pragma unroll
  for (int r = 0; r < IN_ROWS; ++r) xs[r * LANES + c] = x[r * LANES + c];
  const float fw = __uint_as_float(fill);
  for (int k = c; k < SW; k += LANES) t[k] = fw;
  __syncthreads();
  float o[OUT_ROWS];
  for (int i = 0; i < STEPS; ++i) {
    step<P>(i, c, xs, t, o);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) out[r * LANES + c] = o[r];
}

template <int P>
int launch_mosaic(const float* x, float* out, unsigned fill,
                  cudaStream_t stream) {
  probe_mosaic<P><<<1, LANES, 0, stream>>>(x, out, fill);
  return (int)cudaGetLastError();
}

// ---- probe_dma16 ---------------------------------------------------------

constexpr int DMA_SLOTS = 4;
constexpr int DMA_ROWS = 512;            // rows a copy moves
constexpr int DMA_LANES = 16;            // the input's row width
constexpr int DMA_STRIDE = 128;          // rows between two steps' copies
constexpr int DMA_SLOT = 1;              // the slot the copies fill
constexpr int DMA_LANE = 3;              // the lane the splat reads
constexpr unsigned DMA_BYTES = DMA_ROWS * DMA_LANES * 4;  // 32 KiB
constexpr int DMA_SMEM = DMA_SLOTS * DMA_ROWS * DMA_LANES * 4;  // 128 KiB

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// in: (>= 896, 16) f32, 16-byte aligned; out: (8, 128) f32.  One block of
// 128 threads, DMA_SMEM bytes of dynamic shared memory.
__global__ void __launch_bounds__(LANES)
probe_dma16(const float* __restrict__ in, float* __restrict__ out,
            unsigned fill) {
  extern __shared__ __align__(128) float t[];  // (4, 512, 16)
  __shared__ __align__(8) uint64_t bar;
  const int c = threadIdx.x;
  const float fw = __uint_as_float(fill);
  for (int k = c; k < DMA_SMEM / 4; k += LANES) t[k] = fw;
  const unsigned b = smem_addr(&bar);
  if (c == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float o = 0.f;
  float* slot = t + DMA_SLOT * DMA_ROWS * DMA_LANES;
  for (int i = 0; i < STEPS; ++i) {
    if (c == 0) {
      // Every lane's generic reads and writes of the slot (the fill, the
      // last step's splat) come before the async proxy's writes.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(DMA_BYTES)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot)),
          "l"(in + (size_t)i * DMA_STRIDE * DMA_LANES), "r"(DMA_BYTES), "r"(b)
          : "memory");
    }
    // Step i completes the barrier's phase i: wait on its parity.
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b), "r"((unsigned)(i & 1))
          : "memory");
    }
    o = add(0.f, slot[i * DMA_LANES + DMA_LANE]);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) out[r * LANES + c] = o;
}

}  // namespace

// probe: Probe; x: (16, 128) f32; out: (8, 128) f32; fill: the scratch's
// word before step 0.
extern "C" int piet_probe_mosaic(int probe, const void* x, void* out,
                                 int fill, cudaStream_t stream) {
  const float* i = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const unsigned f = (unsigned)fill;
  switch (probe) {
#define PIET_PROBE_CASE(P) \
  case P: return launch_mosaic<P>(i, o, f, stream);
    PIET_PROBE_CASE(LANE_SLICE_COMPUTED)
    PIET_PROBE_CASE(LANE_SLICE_REF)
    PIET_PROBE_CASE(LANE_SLICE_REF_DYN)
    PIET_PROBE_CASE(ROLL_DYNAMIC)
    PIET_PROBE_CASE(SUBLANE_DYN_LOAD)
    PIET_PROBE_CASE(STACK_SCALARS)
    PIET_PROBE_CASE(TRANSPOSE_BLOCK)
    PIET_PROBE_CASE(BCAST_AND_REDUCE)
    PIET_PROBE_CASE(RMW_DYN_ROW)
    PIET_PROBE_CASE(MAJOR_DYN_SCRATCH)
    PIET_PROBE_CASE(PAIR_ROWS_BCAST)
    PIET_PROBE_CASE(DYNSUB_STATLANE)
    PIET_PROBE_CASE(SPLAT11)
    PIET_PROBE_CASE(GROUPED_SUM_RESHAPE)
    PIET_PROBE_CASE(ROLL_TREE_SUM)
    PIET_PROBE_CASE(REPEAT_SUB)
    PIET_PROBE_CASE(CONCAT0_41)
    PIET_PROBE_CASE(SPLAT11_CHAIN)
    PIET_PROBE_CASE(SPLAT11_MUL)
    PIET_PROBE_CASE(SPLAT11_CONCAT)
    PIET_PROBE_CASE(SPLAT11_REPEAT)
    PIET_PROBE_CASE(DYN2_READ)
#undef PIET_PROBE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// in: (rows >= 896, 16) f32, 16-byte aligned; out: (8, 128) f32; fill:
// the scratch's word before step 0.
extern "C" int piet_probe_dma16(const void* in, void* out, int fill,
                                cudaStream_t stream) {
  // The opt-in is an attribute of the function on each device: once a
  // device, on its first launch there.
  static unsigned long long opted_in = 0;
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (cur & 63);
  if (!(opted_in & bit)) {
    e = cudaFuncSetAttribute(probe_dma16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DMA_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in |= bit;
  }
  probe_dma16<<<1, LANES, DMA_SMEM, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      (unsigned)fill);
  return (int)cudaGetLastError();
}
