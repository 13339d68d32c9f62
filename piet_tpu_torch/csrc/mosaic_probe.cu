// The access-pattern probes of tools/mosaic_probe.py (the port's
// piet_tpu_torch/tools/mosaic_probe.py): two kernels, each with its own C
// entry point.
//
// - probe_mosaic replaces tools/mosaic_probe.py::_compile, which compiles
//   one small Pallas kernel per probe: grid (4,) run in order on one core,
//   a (16, 128) f32 input in VMEM, an (8, 128) f32 output whose block is
//   (0, 0) at every step (resident, so the result is what step 3 left),
//   and the probe's scratch, whose contents carry from step to step.  Here
//   one launch runs every requested probe at every requested fill: block
//   (b, f) runs the b-th probe of the caller's mask at fill f, through a
//   switch on the probe to that probe's own instantiation of the step<P>
//   template (the counterpart of one Pallas kernel per probe).  A block of
//   128 threads, one a lane, runs the four steps in order; the input is
//   staged in shared memory with 16-byte loads (a probe reads other lanes'
//   words), the scratch is shared memory of the shape the tool's SCRATCH
//   declares, and __syncthreads() stands wherever a step writes scratch
//   that another lane then reads, and after every step.  The output rows
//   of a lane live in registers and are stored after step 3.  Each probe
//   computes what its Pallas body computes, op for op (under the build's
//   -fmad=false no multiply and add contract).
//   What bounds it: the launch and its slowest block.  A probe moves 12
//   KiB, a 3.7 ns share of device memory's rate, against a launch of
//   about 2 us; one launch a probe and fill made the tool's 44 runs 44
//   launches in series.  So the 44 are one grid of 44 blocks, one wave on
//   132 SMs, and the launch ends with its slowest block, whose time is its
//   chain of dependent ops, each checked for the CPU's NaN word.
//   The shared memory is one static buffer sized for the largest scratch
//   (8,192 words) plus the 8 KiB input, 40 KiB in all, under the 48 KiB
//   that needs no opt-in; each instantiation addresses the same buffer.
//   The (128, 16) transpose target has a row stride of 17 words, so the
//   32 lanes of a warp store a column's 16 words into 32 banks, not 2 (a
//   16-way conflict at a stride of 16); the pad words are never read.
//   Only the probes whose output shows unwritten scratch (stack_scalars,
//   rmw_dyn_row, major_dyn_scratch, dyn2_read) fill it with the caller's
//   word before step 0 (the interpreter's default 0x7fc00000, or 0); the
//   transposing probes write all of theirs before the first read.
// - probe_dma16 replaces tools/mosaic_probe.py::_compile_dma16 and its
//   kernel _dma16_kernel: at each of the four steps an async copy of 512
//   rows x 16 lanes from device memory into slot 1 of a (4, 512, 16) f32
//   scratch, a wait on its DMA semaphore, then a splat of t[1, i, 3].  On
//   Hopper the copy is a bulk async copy (TMA's 1-D cp.async.bulk,
//   16-byte aligned) that completes on an mbarrier, and the wait is the
//   mbarrier's phase.  No word of the scratch is read before a copy has
//   written it: slots 0, 2 and 3 are never touched, and step 0's copy
//   fills slot 1 before the first read.  So the output cannot depend on
//   the fill word (on the TPU scratch starts uninitialized), and the
//   kernel allocates only slot 1, 32 KiB of static shared memory, and
//   fills nothing.  What bounds it: the launch and four copies in series
//   (each step's splat reads what its own copy wrote, and the next copy
//   overwrites it), each a round trip to the L2 or device memory; its 60
//   KiB would take 18 ns at device memory's rate.  Lane 0 arms each
//   step's phase and issues its 32 KiB as one bulk copy: four 8 KiB
//   copies in flight together were no faster, nor the full 128 KiB
//   scratch with its opt-in slower than the slot alone (PERF.md).
//
// NaN words.  Scratch a probe reads before writing holds the fill word,
// so with the NaN fill some results are NaNs.  The CPU (and the Pallas
// interpreter on it) gives an arithmetic op's NaN result the bits of its
// first NaN operand, quieted; Hopper's ALU returns the canonical
// 0x7fffffff.  The checked ops below (cpu_add, cpu_mul, cpu_min) give the
// CPU's words, so the kernel's output equals its plain version's
// (ops/probes.py) bit for bit at either fill; probe_mosaic pays for them
// only where a NaN reaches a block's output (run_probe).  Opposite-sign
// zero pairs never reach a minimum here (the probes' inputs are random
// normals and the zero fill is +0).
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

// The (128, 16) transpose target's row stride: 17 words (16 and a pad),
// so lane c's stores t[c * 17 + k] fall in 32 banks.
constexpr int T_STRIDE = IN_ROWS + 1;

__host__ __device__ constexpr bool transposes(int p) {
  return p == TRANSPOSE_BLOCK || p == DYNSUB_STATLANE || p == SPLAT11 ||
         p == SPLAT11_CHAIN || p == SPLAT11_MUL || p == SPLAT11_CONCAT ||
         p == SPLAT11_REPEAT;
}

// Words of a probe's scratch (the tool's SCRATCH): (4, 16, 128) and
// (8, 8, 128) f32, a (128, 16) transpose target (rows padded to
// T_STRIDE), a (32, 128) accumulator, or 8 SMEM scalars.
__host__ __device__ constexpr int scratch_words(int p) {
  return p == DYN2_READ || p == MAJOR_DYN_SCRATCH ? 8192
         : p == RMW_DYN_ROW                       ? 4096
         : transposes(p)                          ? LANES * T_STRIDE
         : p == STACK_SCALARS                     ? 8
                                                  : 0;
}

// The shared buffer every instantiation addresses: the largest scratch.
constexpr int MAX_SCRATCH = scratch_words(DYN2_READ);

// Probes whose output shows scratch no step has written: their scratch
// starts as the fill word.
__host__ __device__ constexpr bool reads_unwritten(int p) {
  return p == STACK_SCALARS || p == RMW_DYN_ROW || p == MAJOR_DYN_SCRATCH ||
         p == DYN2_READ;
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

__device__ __forceinline__ float cpu_add(float a, float b) {
  return cpu_nan(a + b, a, b);
}

__device__ __forceinline__ float cpu_mul(float a, float b) {
  return cpu_nan(a * b, a, b);
}

// jnp.minimum: a NaN operand gives a NaN (fminf would drop it).
__device__ __forceinline__ float cpu_min(float a, float b) {
  return isnan(a) ? quiet(a) : isnan(b) ? quiet(b) : fminf(a, b);
}

// xs: the input staged as (16, 128); t: the probe's scratch; o: this
// lane's 8 output rows.  Step i of probe P at lane c.
template <int P>
__device__ __forceinline__ void step(int i, int c, const float* xs, float* t,
                                     float (&o)[OUT_ROWS]) {
  auto x = [xs](int r, int l) { return xs[r * LANES + l]; };
  // t[:] = x.T, a (128, 16) scratch with rows T_STRIDE words apart.
  auto transpose = [&]() {
#pragma unroll
    for (int k = 0; k < IN_ROWS; ++k) t[c * T_STRIDE + k] = x(k, c);
    __syncthreads();
  };
  if constexpr (P == LANE_SLICE_COMPUTED) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r)
      o[r] = cpu_add(0.f, cpu_mul(x(r, 3), 2.f));
  } else if constexpr (P == LANE_SLICE_REF) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = cpu_add(0.f, x(r, 3));
  } else if constexpr (P == LANE_SLICE_REF_DYN) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = cpu_add(0.f, x(r, i));
  } else if constexpr (P == ROLL_DYNAMIC) {
    // pltpu.roll(v, 16 i, 1) = np.roll: lane c takes lane c - 16 i.
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = x(r, (c - 16 * i) & (LANES - 1));
  } else if constexpr (P == SUBLANE_DYN_LOAD) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = x(i + (r & 3), c);
  } else if constexpr (P == STACK_SCALARS) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = cpu_add(0.f, t[r]);
  } else if constexpr (P == TRANSPOSE_BLOCK) {
    transpose();
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = cpu_add(0.f, t[0]);
  } else if constexpr (P == BCAST_AND_REDUCE) {
    // f = a * xs + a, a = x[0:8, 0:1], xs = x[0:1, :]; min over sublanes.
    const float xs0 = x(0, c);
    float red = cpu_add(cpu_mul(x(0, 0), xs0), x(0, 0));
#pragma unroll
    for (int r = 1; r < OUT_ROWS; ++r)
      red = cpu_min(red, cpu_add(cpu_mul(x(r, 0), xs0), x(r, 0)));
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = cpu_add(0.f, red);
  } else if constexpr (P == RMW_DYN_ROW) {
    // acc[i] = min(acc[i], x[0]); out = acc[0:8].  A lane touches only
    // its own column.
    t[i * LANES + c] = cpu_min(t[i * LANES + c], x(0, c));
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = t[r * LANES + c];
  } else if constexpr (P == MAJOR_DYN_SCRATCH) {
    // g[0] = x[0:8]; out = g[i, :, 2:3] splat.
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) t[r * LANES + c] = x(r, c);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r)
      o[r] = cpu_add(0.f, t[(i * OUT_ROWS + r) * LANES + 2]);
  } else if constexpr (P == PAIR_ROWS_BCAST || P == REPEAT_SUB) {
    // [a0, a0, a1, a1, a2, a2, a3, a3], a = x[0:4, 0:1].
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = cpu_add(0.f, x(r >> 1, 0));
  } else if constexpr (P == DYNSUB_STATLANE) {
    transpose();
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r)
      o[r] = cpu_add(0.f, t[(4 * i + (r & 3)) * T_STRIDE + 2]);
  } else if constexpr (P == SPLAT11 || P == SPLAT11_CHAIN ||
                       P == SPLAT11_MUL) {
    // x[0:8] * a + b with a = t[i, 2], b = t[i, 3] (times a (8, 1) of
    // ones for splat11_mul).
    transpose();
    float a = t[i * T_STRIDE + 2], b = t[i * T_STRIDE + 3];
    if constexpr (P == SPLAT11_MUL) {
      a = cpu_mul(a, 1.f);
      b = cpu_mul(b, 1.f);
    }
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r)
      o[r] = cpu_add(cpu_mul(x(r, c), a), b);
  } else if constexpr (P == GROUPED_SUM_RESHAPE) {
    // Sums of rows 0-3 and 4-7, in order; out = [s0, s1] * 4.
    float s[2];
#pragma unroll
    for (int g = 0; g < 2; ++g)
      s[g] = cpu_add(
          cpu_add(cpu_add(x(4 * g, c), x(4 * g + 1, c)), x(4 * g + 2, c)),
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
      for (int r = 0; r < OUT_ROWS; ++r)
        u[r] = cpu_add(s[r], s[(r - k) & 7]);
#pragma unroll
      for (int r = 0; r < OUT_ROWS; ++r) s[r] = u[r];
    }
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = s[r];
  } else if constexpr (P == CONCAT0_41) {
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = cpu_add(0.f, x(r & 3, 0));
  } else if constexpr (P == SPLAT11_CONCAT || P == SPLAT11_REPEAT) {
    transpose();
    const float a = t[i * T_STRIDE + 2];
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) o[r] = cpu_mul(x(r, c), a);
  } else if constexpr (P == DYN2_READ) {
    // g[0] = x; out = g[i, 2 i, 2] splat.
#pragma unroll
    for (int r = 0; r < IN_ROWS; ++r) t[r * LANES + c] = x(r, c);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r)
      o[r] = cpu_add(0.f, t[(i * IN_ROWS + 2 * i) * LANES + 2]);
  }
}

// Probe P's four steps at lane c on the staged input xs, its scratch t
// starting as the word fill where P reads it unwritten; o_out: the
// block's (8, 128) output.
template <int P>
__device__ __forceinline__ void run_probe(int c, const float* xs, float* t,
                                          unsigned fill, float* o_out) {
  if constexpr (reads_unwritten(P)) {
    constexpr int SW4 = scratch_words(P) / 4;
    const float fw = __uint_as_float(fill);
    const float4 f4 = make_float4(fw, fw, fw, fw);
    for (int k = c; k < SW4; k += LANES) reinterpret_cast<float4*>(t)[k] = f4;
    __syncthreads();
  }
  float o[OUT_ROWS];
  // Not unrolled: the step stays a runtime value, as the TPU kernel's
  // program_id, so the dynamic slices stay dynamic.
#pragma unroll 1
  for (int i = 0; i < STEPS; ++i) {
    step<P>(i, c, xs, t, o);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) o_out[r * LANES + c] = o[r];
}

// The position of mask's n-th set bit (from 0).
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  for (int k = 0; k < n; ++k) mask &= mask - 1;
  return __ffs(mask) - 1;
}

// x: (16, 128) f32, 16-byte aligned; out: (gridDim.y, gridDim.x, 8, 128)
// f32.  Block (b, f) runs the b-th probe of mask at fill f (fill0, or
// fill1 for f = 1).  128 threads a block.
__global__ void __launch_bounds__(LANES)
probe_mosaic(const float* __restrict__ x, float* __restrict__ out,
             unsigned mask, unsigned fill0, unsigned fill1) {
  __shared__ __align__(16) float xs[IN_ROWS * LANES];
  __shared__ __align__(16) float t[MAX_SCRATCH];
  const int c = threadIdx.x;
#pragma unroll
  for (int k = 0; k < IN_ROWS * LANES / 4; k += LANES)
    reinterpret_cast<float4*>(xs)[k + c] =
        reinterpret_cast<const float4*>(x)[k + c];
  const int probe = nth_set_bit(mask, blockIdx.x);
  const unsigned fill = blockIdx.y ? fill1 : fill0;
  float* o = out + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                       (OUT_ROWS * LANES);
  __syncthreads();
  switch (probe) {
#define PIET_PROBE_CASE(P)           \
  case P:                            \
    run_probe<P>(c, xs, t, fill, o); \
    break;
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
    default: break;
  }
}

// ---- probe_dma16 ---------------------------------------------------------

constexpr int DMA_ROWS = 512;            // rows a copy moves
constexpr int DMA_LANES = 16;            // the input's row width
constexpr int DMA_STRIDE = 128;          // rows between two steps' copies
constexpr int DMA_LANE = 3;              // the lane the splat reads
constexpr int DMA_WORDS = DMA_ROWS * DMA_LANES;
constexpr unsigned DMA_BYTES = DMA_WORDS * 4;  // 32 KiB

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// in: (>= 896, 16) f32, 16-byte aligned; out: (8, 128) f32.  One block of
// 128 threads; slot 1 of the (4, 512, 16) scratch in shared memory.
__global__ void __launch_bounds__(LANES)
probe_dma16(const float* __restrict__ in, float* __restrict__ out) {
  __shared__ __align__(128) float slot[DMA_WORDS];
  __shared__ __align__(8) uint64_t bar;
  const int c = threadIdx.x;
  const unsigned b = smem_addr(&bar);
  if (c == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float o = 0.f;
  for (int i = 0; i < STEPS; ++i) {
    if (c == 0) {
      // Every lane's generic reads of the slot (the last step's splat,
      // ordered by the step's __syncthreads) come before the async
      // proxy's writes.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(DMA_BYTES)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot)),
          "l"(in + (size_t)i * DMA_STRIDE * DMA_LANES), "r"(DMA_BYTES),
          "r"(b)
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
    o = cpu_add(0.f, slot[i * DMA_LANES + DMA_LANE]);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) out[r * LANES + c] = o;
}

}  // namespace

// x: (16, 128) f32, 16-byte aligned; out: (n_fills, popcount(mask), 8,
// 128) f32: every probe of mask (bit p: Probe p) in order, at fill0 and,
// where n_fills is 2, at fill1 (the scratch's word before step 0).  One
// launch.
extern "C" int piet_probe_mosaic(const void* x, void* out, int mask,
                                 int n_fills, int fill0, int fill1,
                                 cudaStream_t stream) {
  const unsigned m = (unsigned)mask;
  if (m == 0 || (m >> N_PROBES) != 0 || n_fills < 1 || n_fills > 2)
    return (int)cudaErrorInvalidValue;
  probe_mosaic<<<dim3(__builtin_popcount(m), n_fills), LANES, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), m,
      (unsigned)fill0, (unsigned)fill1);
  return (int)cudaGetLastError();
}

// in: (rows >= 896, 16) f32, 16-byte aligned; out: (8, 128) f32.
extern "C" int piet_probe_dma16(const void* in, void* out,
                                cudaStream_t stream) {
  probe_dma16<<<1, LANES, 0, stream>>>(static_cast<const float*>(in),
                                       static_cast<float*>(out));
  return (int)cudaGetLastError();
}
