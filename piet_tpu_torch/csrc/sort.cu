// Kernel C: stable LSD radix sort of (f32 key(s), int32 val) pairs.
//
// Replaces piet_tpu/ops/sort.py::_sort_kernel (behind _sort_pallas and
// stable_sort_multi).  The keys are the coarse pass's: integers in
// [0, bound) held in f32 (bound <= 2^24, where f32 stops being exact) or
// +inf for a dead record, one packed key or the unpacked pair (tile,
// item * 2 + class).  Each key's integer value, +inf taken as the bound,
// is sorted digit by digit, least significant first (the second key's
// digits, then the first key's); every pass is a stable counting sort, so
// the result equals successive stable sorts for any val, with no padding
// and no index in the comparison.  ops/sort.py::sort_plan fixes the
// digit passes and the split of the pairs over blocks.
//
// One pass, per block: (1) each warp counts the digits of its contiguous
// run of the block's pairs (one __match_any_sync per 32 pairs, in element
// order); (2) the per-warp counts become exclusive offsets per digit, and
// the block's digit totals are published; (3) the block's global offset
// per digit is the sum of all digits below it plus the same digit in the
// blocks before it; (4) each warp walks its run again and places every
// pair at its offset plus its rank among equal digits in its batch.
//
// Route 1, up to 16 x 12,288 pairs (the tiger's 67,584 records): one
// launch on one thread-block cluster of 16 blocks.  The pairs live in
// the blocks' shared memory (two buffers of 8-byte (key value, index)
// pairs, 192 KB at the most per block) for all passes; the digit totals
// are read across the cluster through distributed shared memory and each
// pair is written straight into the owning block's buffer, with a cluster
// barrier after the totals and after the writes.  The last pass writes the
// outputs, gathering the input key and val words by index.
// Route 2, above that: the same pass over device memory, three launches
// per pass (counts, one-block scan of the digit-major counts, scatter).
//
// Bound on the H100: the pairs must be read and written once, ~1 MB at
// the tiger's size, under a microsecond of HBM time; what the sort spends
// is latency -- the launch, and per pass a few dependent steps and two
// cluster barriers, three passes for the tiger's 20-bit key.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;
constexpr int MAX_PASSES = 8;
constexpr int CHUNK_MAX = 12288;   // pairs per cluster block
constexpr int CLUSTER_MAX = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Sched {
  const float* key[2];
  unsigned bound[2];
  int n_pass;
  int sel[MAX_PASSES], shift[MAX_PASSES], bits[MAX_PASSES];
};

// Shared bytes of a cluster block holding ``chunk`` pairs.
constexpr size_t cluster_smem(int chunk) {
  return (size_t)chunk * 2 * sizeof(uint2) +
         (size_t)(WARPS * BINS + BINS + WARPS) * sizeof(unsigned);
}

// The integer value of a key word: +inf is the key's bound.
__device__ __forceinline__ unsigned key_int(float f, unsigned bound) {
  return f == INFINITY ? bound : (unsigned)f;
}

// This warp's run [lo, hi) of a block's m pairs.
__device__ __forceinline__ void warp_range(int m, int* lo, int* hi) {
  const int per = (m + WARPS - 1) / WARPS;
  *lo = min((int)(threadIdx.x >> 5) * per, m);
  *hi = min(*lo + per, m);
}

// Digit counts of this warp's run into ``row`` (BINS counters).
template <class Get>
__device__ __forceinline__ void warp_count(unsigned* row, int lo, int hi,
                                           Get get, int shift,
                                           unsigned mask) {
  const int lane = threadIdx.x & 31;
  for (int b = lane; b < BINS; b += 32) row[b] = 0u;
  __syncwarp();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool ok = i < hi;
    const unsigned d = ok ? (get(i).x >> shift) & mask : (unsigned)BINS;
    const unsigned peers = __match_any_sync(FULL, d);
    if (ok && lane == __ffs(peers) - 1) row[d] += __popc(peers);
    __syncwarp();
  }
}

// Places this warp's run: ``row`` holds the warp's first position per
// digit; a pair goes to it plus its rank among equal digits of its batch.
// fetch(e) reads what put(pos, e, fetched) needs from device memory; it is
// started before the ranking, so its latency hides behind it.
template <class Get, class Fetch, class Put>
__device__ __forceinline__ void warp_scatter(unsigned* row, int lo, int hi,
                                             Get get, Fetch fetch, Put put,
                                             int shift, unsigned mask) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool ok = i < hi;
    uint2 e = make_uint2(0u, 0u);
    if (ok) e = get(i);
    decltype(fetch(e)) f{};
    if (ok) f = fetch(e);
    const unsigned d = ok ? (e.x >> shift) & mask : (unsigned)BINS;
    const unsigned peers = __match_any_sync(FULL, d);
    unsigned pos = 0u;
    if (ok) pos = row[d] + __popc(peers & lt);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) row[d] += __popc(peers);
    __syncwarp();
    if (ok) put(pos, e, f);
  }
}

// Exclusive prefix sum of v over the block's threads; ``tot`` holds
// WARPS words.  Every thread of the block calls it.
__device__ __forceinline__ unsigned block_excl_scan(unsigned v,
                                                    unsigned* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tot[w] = x;
  __syncthreads();
  if (w == 0) {
    const unsigned t = tot[lane];
    unsigned u = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, u, o);
      if (lane >= o) u += y;
    }
    tot[lane] = u - t;
  }
  __syncthreads();
  const unsigned r = tot[w] + x - v;
  __syncthreads();
  return r;
}

// Per-warp counts -> exclusive offsets per digit (threads < BINS);
// returns the block's total of digit threadIdx.x.
__device__ __forceinline__ unsigned warp_offsets(unsigned* cnt,
                                                 unsigned start) {
  const int d = threadIdx.x;
  unsigned run = start;
  for (int v = 0; v < WARPS; ++v) {
    const unsigned c = cnt[v * BINS + d];
    cnt[v * BINS + d] = run;
    run += c;
  }
  return run - start;
}

// The last pass: each pair's val and key words, read by record index
// (fetch) and written at the pair's place (put).
struct OutWords {
  int v;
  float k0, k1;
};

__device__ __forceinline__ OutWords fetch_out(const Sched& s,
                                              const int* __restrict__ val,
                                              bool two, unsigned idx) {
  return OutWords{val[idx], s.key[0][idx], two ? s.key[1][idx] : 0.f};
}

__device__ __forceinline__ void write_out(float* __restrict__ out0,
                                          float* __restrict__ out1,
                                          int* __restrict__ out_val,
                                          unsigned pos, const OutWords& w) {
  out_val[pos] = w.v;
  out0[pos] = w.k0;
  if (out1 != nullptr) out1[pos] = w.k1;
}

__global__ void __launch_bounds__(THREADS, 1)
sort_cluster(const Sched s, const int* __restrict__ val,
             float* __restrict__ out0, float* __restrict__ out1,
             int* __restrict__ out_val, int n, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* const buf0 = reinterpret_cast<uint2*>(smem);
  uint2* const buf1 = buf0 + chunk;
  unsigned* const cnt = reinterpret_cast<unsigned*>(buf1 + chunk);
  unsigned* const hist = cnt + WARPS * BINS;
  unsigned* const tot = hist + BINS;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int base = rank * chunk;
  const int m = max(0, min(chunk, n - base));
  const float* const key_in = s.key[s.sel[0]];
  const unsigned bound_in = s.bound[s.sel[0]];
  for (int i = tid; i < m; i += THREADS)
    buf0[i] = make_uint2(key_int(key_in[base + i], bound_in),
                         (unsigned)(base + i));
  __syncthreads();
  int lo, hi;
  warp_range(m, &lo, &hi);
  unsigned* const row = cnt + (tid >> 5) * BINS;
  for (int p = 0; p < s.n_pass; ++p) {
    const uint2* src = (p & 1) ? buf1 : buf0;
    uint2* dst = (p & 1) ? buf0 : buf1;
    const int shift = s.shift[p];
    const unsigned mask = (1u << s.bits[p]) - 1u;
    const auto get = [&](int i) { return src[i]; };
    warp_count(row, lo, hi, get, shift, mask);
    __syncthreads();
    if (tid < BINS) hist[tid] = warp_offsets(cnt, 0u);
    cluster.sync();
    unsigned total = 0u, before = 0u;
    if (tid < BINS) {
#pragma unroll
      for (int r = 0; r < CLUSTER_MAX; ++r) {
        if (r < n_blocks) {
          const unsigned h = cluster.map_shared_rank(hist, r)[tid];
          total += h;
          if (r < rank) before += h;
        }
      }
    }
    const unsigned digit_base = block_excl_scan(total, tot);
    if (tid < BINS) {
      const unsigned off = digit_base + before;
      for (int v = 0; v < WARPS; ++v) cnt[v * BINS + tid] += off;
    }
    __syncthreads();
    if (p + 1 == s.n_pass) {
      warp_scatter(row, lo, hi, get, [&](uint2 e) {
        return fetch_out(s, val, out1 != nullptr, e.y);
      }, [&](unsigned pos, uint2, const OutWords& w) {
        write_out(out0, out1, out_val, pos, w);
      }, shift, mask);
    } else {
      const int nsel = s.sel[p + 1];
      const bool reload = nsel != s.sel[p];
      const float* const nkey = s.key[nsel];
      const unsigned nbound = s.bound[nsel];
      warp_scatter(row, lo, hi, get, [&](uint2 e) {
        return reload ? key_int(nkey[e.y], nbound) : e.x;
      }, [&](unsigned pos, uint2 e, unsigned k) {
        const int owner = (int)pos / chunk;
        cluster.map_shared_rank(dst, owner)[(int)pos - owner * chunk] =
            make_uint2(k, e.y);
      }, shift, mask);
    }
    // The writes have landed, and no block still reads this pass's
    // totals, before the next pass (or the end of the kernel).
    cluster.sync();
  }
}

// Route 2: the pass over device memory.  Pass 0 reads the input keys;
// later passes read the pairs the previous pass wrote.
struct GlobalPass {
  const float* key;   // the first pass's key
  unsigned bound;
  int p, base;
  const uint2* src;
  __device__ __forceinline__ GlobalPass(const Sched& s, int p_, int base_,
                                        const uint2* src_)
      : key(s.key[s.sel[0]]), bound(s.bound[s.sel[0]]), p(p_), base(base_),
        src(src_) {}
  __device__ __forceinline__ uint2 operator()(int i) const {
    const int g = base + i;
    return p == 0 ? make_uint2(key_int(key[g], bound), (unsigned)g) : src[g];
  }
};

__global__ void __launch_bounds__(THREADS)
sort_g_count(const Sched s, int p, const uint2* __restrict__ src,
             unsigned* __restrict__ hist, int n, int chunk) {
  __shared__ unsigned cnt[WARPS * BINS];
  const int b = blockIdx.x, nb = gridDim.x, tid = threadIdx.x;
  const int base = b * chunk;
  int lo, hi;
  warp_range(min(chunk, n - base), &lo, &hi);
  const GlobalPass get(s, p, base, src);
  warp_count(cnt + (tid >> 5) * BINS, lo, hi, get, s.shift[p],
             (1u << s.bits[p]) - 1u);
  __syncthreads();
  if (tid < BINS) hist[tid * nb + b] = warp_offsets(cnt, 0u);
}

__global__ void __launch_bounds__(THREADS)
sort_g_scan(unsigned* __restrict__ hist, int len) {
  __shared__ unsigned tot[WARPS];
  const int per = (len + THREADS - 1) / THREADS;
  const int lo = min((int)threadIdx.x * per, len), hi = min(lo + per, len);
  unsigned sum = 0u;
  for (int i = lo; i < hi; ++i) sum += hist[i];
  unsigned run = block_excl_scan(sum, tot);
  for (int i = lo; i < hi; ++i) {
    const unsigned h = hist[i];
    hist[i] = run;
    run += h;
  }
}

__global__ void __launch_bounds__(THREADS)
sort_g_scatter(const Sched s, int p, const uint2* __restrict__ src,
               uint2* __restrict__ dst, const unsigned* __restrict__ hist,
               const int* __restrict__ val, float* __restrict__ out0,
               float* __restrict__ out1, int* __restrict__ out_val, int n,
               int chunk) {
  __shared__ unsigned cnt[WARPS * BINS];
  const int b = blockIdx.x, nb = gridDim.x, tid = threadIdx.x;
  const int base = b * chunk;
  int lo, hi;
  warp_range(min(chunk, n - base), &lo, &hi);
  const GlobalPass get(s, p, base, src);
  const int shift = s.shift[p];
  const unsigned mask = (1u << s.bits[p]) - 1u;
  unsigned* const row = cnt + (tid >> 5) * BINS;
  warp_count(row, lo, hi, get, shift, mask);
  __syncthreads();
  if (tid < BINS) warp_offsets(cnt, hist[tid * nb + b]);
  __syncthreads();
  if (p + 1 == s.n_pass) {
    warp_scatter(row, lo, hi, get, [&](uint2 e) {
      return fetch_out(s, val, out1 != nullptr, e.y);
    }, [&](unsigned pos, uint2, const OutWords& w) {
      write_out(out0, out1, out_val, pos, w);
    }, shift, mask);
  } else {
    const int nsel = s.sel[p + 1];
    const bool reload = nsel != s.sel[p];
    const float* const nkey = s.key[nsel];
    const unsigned nbound = s.bound[nsel];
    warp_scatter(row, lo, hi, get, [&](uint2 e) {
      return reload ? key_int(nkey[e.y], nbound) : e.x;
    }, [&](unsigned pos, uint2 e, unsigned k) {
      dst[pos] = make_uint2(k, e.y);
    }, shift, mask);
  }
}

bool g_cluster_attrs = false;

}  // namespace

// Sorts n pairs of key0 (and key1: lexicographic (key0, key1)) with val
// into out0 (out1) and out_val.  ``sched`` holds n_pass (key, shift,
// bits) triples on the host.  cluster > 0: one launch on a cluster of
// that many blocks of ``chunk`` pairs; cluster == 0: the device-memory
// route, blocks of ``chunk`` pairs, ``scratch`` holding 2 x n pairs and
// 256 x ceil(n / chunk) counts.
extern "C" int piet_sort(const void* key0, const void* key1, const void* val,
                         void* out0, void* out1, void* out_val, int n,
                         int bound0, int bound1, int n_pass,
                         const int* sched, int cluster, int chunk,
                         void* scratch, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_pass < 1 || n_pass > MAX_PASSES) return (int)cudaErrorInvalidValue;
  Sched s{};
  s.key[0] = static_cast<const float*>(key0);
  s.key[1] = static_cast<const float*>(key1 != nullptr ? key1 : key0);
  s.bound[0] = (unsigned)bound0;
  s.bound[1] = (unsigned)bound1;
  s.n_pass = n_pass;
  for (int p = 0; p < n_pass; ++p) {
    s.sel[p] = sched[3 * p];
    s.shift[p] = sched[3 * p + 1];
    s.bits[p] = sched[3 * p + 2];
    if (s.sel[p] < 0 || s.sel[p] > (key1 != nullptr ? 1 : 0) ||
        s.bits[p] < 1 || s.bits[p] > 8 || s.shift[p] < 0 ||
        s.shift[p] + s.bits[p] > 25)
      return (int)cudaErrorInvalidValue;
  }
  const int* v = static_cast<const int*>(val);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  int* ov = static_cast<int*>(out_val);
  cudaError_t err;
  if (cluster > 0) {
    if (cluster > CLUSTER_MAX || chunk < 1 || chunk > CHUNK_MAX ||
        (long long)cluster * chunk < n)
      return (int)cudaErrorInvalidValue;
    if (!g_cluster_attrs) {
      err = cudaFuncSetAttribute(sort_cluster,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)cluster_smem(CHUNK_MAX));
      if (err != cudaSuccess) return (int)err;
      err = cudaFuncSetAttribute(
          sort_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      g_cluster_attrs = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = cluster_smem(chunk);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, sort_cluster, s, v, o0, o1, ov, n, chunk);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || chunk < 1) return (int)cudaErrorInvalidValue;
  const int nb = (n + chunk - 1) / chunk;
  uint2* buf[2] = {static_cast<uint2*>(scratch),
                   static_cast<uint2*>(scratch) + n};
  unsigned* hist = reinterpret_cast<unsigned*>(buf[1] + n);
  for (int p = 0; p < n_pass; ++p) {
    const uint2* src = buf[p & 1];
    uint2* dst = buf[(p + 1) & 1];
    sort_g_count<<<nb, THREADS, 0, stream>>>(s, p, src, hist, n, chunk);
    sort_g_scan<<<1, THREADS, 0, stream>>>(hist, BINS * nb);
    sort_g_scatter<<<nb, THREADS, 0, stream>>>(s, p, src, dst, hist, v, o0,
                                               o1, ov, n, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
