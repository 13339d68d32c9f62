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
// Route 1, up to 16 x 12,288 pairs (the tiger's 67,584 records): one
// launch on one thread-block cluster of 16 blocks.  The pairs live in
// the blocks' shared memory (two buffers of 8-byte (key value, index)
// pairs, 192 KB at the most per block) for all passes.  A pass, per
// block: (1) each warp counts the digits of its contiguous run of the
// block's pairs (one __match_any_sync per 32 pairs, in element order);
// (2) the per-warp counts become exclusive offsets per digit, and the
// block's digit totals are published; (3) the block's global offset per
// digit is the sum of all digits below it plus the same digit in the
// blocks before it, read across the cluster through distributed shared
// memory; (4) each warp walks its run again and writes every pair
// straight into the owning block's buffer, at its offset plus its rank
// among equal digits in its batch.  A cluster barrier follows the totals
// and the writes.  The last pass writes the outputs, gathering the input
// key and val words by index.
//
// Route 2, above that (beziers_10k's 261,504-368,640 records): one pass
// per launch over device memory, after a memset of the counters and one
// upsweep launch -- 1 + n_pass launches, in the shape of Onesweep
// (Adinets & Merrill, 2022).  The upsweep reads every key once and builds
// the global digit histogram of every pass (per block in shared memory,
// merged with atomics; the last block to finish turns each pass's totals
// into exclusive digit starts), and zeroes the look-back words.  A pass
// launch takes 1,792-pair tiles, each block claiming the next tile from an
// atomic counter (so a block that waits on a predecessor's tile never
// waits on a block that has not started): 7 pairs a thread loaded
// together, a warp's 224 pairs ranked in element order with
// __match_any_sync, the warps' counts scanned per digit; the tile
// publishes its digit counts, stages its pairs in shared memory in digit
// order, and learns each digit's global start by decoupled look-back over
// one 32-bit status word per (tile, digit): a flag (count only, or
// inclusive prefix) and a 30-bit value, 8 predecessors' words read at
// once.  Each digit's run then leaves as contiguous stores.  A one-key
// sort moves (key value, val) pairs and writes the key words back from
// their values, unless the upsweep found a key word that its value does
// not give back (-0.0): then pairs carry the record index and the last
// pass gathers val and key words by it, as the two-key sort always does.
// Each pass launch is a programmatic dependent launch: its blocks start
// and claim their tiles while the launch before still runs.
//
// Bound on the H100: each key and val word read and written once, ~1 MB
// at the tiger's size and ~6 MB at beziers_10k's, a few microseconds of
// HBM time at most; what the sort spends is latency -- launches, barriers
// and look-back steps, three passes for the tiger's 20-bit key and for
// beziers_10k's 23-bit key.
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

// Route 2: threads of a block (one per digit bin), pairs a thread, pairs
// a tile (ops/sort.py::PASS_TILE).
constexpr int P_THREADS = 256;
constexpr int P_WARPS = P_THREADS / 32;
constexpr int P_ITEMS = 7;
constexpr int P_TILE = P_THREADS * P_ITEMS;
static_assert(P_THREADS == BINS, "one thread per digit bin");
// Keys an upsweep thread loads at once, and a block's step.
constexpr int U_ITEMS = 8;
constexpr int U_STEP = P_THREADS * U_ITEMS;
// Control words at the start of route 2's counters: a tile counter per
// pass, the upsweep's finished-block count, a flag the upsweep sets when
// a first-key word is not the canonical f32 of its integer value (-0.0),
// then the histograms.
constexpr int CTL_DONE = MAX_PASSES;
constexpr int CTL_ODD = MAX_PASSES + 1;
constexpr int CTL_HIST = 16;
// A look-back word: the tile's digit count, or the inclusive prefix of
// the tiles up to it, in the low 30 bits; 0 until published.
constexpr unsigned ST_AGG = 1u << 30;
constexpr unsigned ST_INCL = 1u << 31;
constexpr unsigned ST_VAL = ST_AGG - 1u;
// Look-back words a thread reads at once.
constexpr int LOOK_W = 8;

struct Sched {
  const float* key[2];
  unsigned bound[2];
  int two;
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

// The key word of an integer value: the bound is +inf.
__device__ __forceinline__ float key_word(unsigned k, unsigned bound) {
  return k == bound ? INFINITY : (float)k;
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

// Exclusive prefix sum of v over the block's NW warps; ``tot`` holds NW
// words.  Every thread of the block calls it.
template <int NW>
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
    const unsigned t = lane < NW ? tot[lane] : 0u;
    unsigned u = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, u, o);
      if (lane >= o) u += y;
    }
    if (lane < NW) tot[lane] = u - t;
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
    const unsigned digit_base = block_excl_scan<WARPS>(total, tot);
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

// Route 2.  Relaxed loads and stores of the look-back words, at device
// scope: a word is published once as a count and once as a prefix, and
// read again until it is published.
__device__ __forceinline__ unsigned ld_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// Programmatic dependent launch (Hopper): a launch may start while the
// one before it runs; wait_prior() returns once that one has finished and
// its writes are visible, and let_next_start() lets the next launch start.
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Every key read once: the digit counts of every pass into ctl's
// histograms (zeroed by the host), and the look-back words of every pass
// zeroed.  The last block to finish turns each pass's counts into the
// exclusive start of each digit.  A block takes U_STEP keys at a time,
// U_ITEMS a thread loaded together, and counts them with plain shared
// atomics (cheaper than a __match_any_sync per key and pass: PERF.md).
// It also flags a first-key word that its integer value does not give
// back.
__global__ void __launch_bounds__(P_THREADS)
sort_upsweep(const Sched s, unsigned* __restrict__ ctl,
             uint4* __restrict__ status, int status_vec, int n) {
  __shared__ unsigned h[MAX_PASSES * BINS];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31;
  let_next_start();
  for (int i = tid; i < s.n_pass * BINS; i += P_THREADS) h[i] = 0u;
  for (int i = blockIdx.x * P_THREADS + tid; i < status_vec;
       i += gridDim.x * P_THREADS)
    status[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  bool odd = false;
  for (int base = blockIdx.x * U_STEP; base < n; base += gridDim.x * U_STEP) {
    const int wbase = base + (tid >> 5) * 32 * U_ITEMS + lane;
    float f0[U_ITEMS];
    unsigned k1[U_ITEMS];
#pragma unroll
    for (int j = 0; j < U_ITEMS; ++j) {
      const int g = wbase + 32 * j;
      f0[j] = g < n ? s.key[0][g] : 0.f;
      k1[j] = g < n && s.two ? key_int(s.key[1][g], s.bound[1]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < U_ITEMS; ++j) {
      if (wbase + 32 * j >= n) continue;
      const unsigned k0 = key_int(f0[j], s.bound[0]);
      odd |= __float_as_uint(f0[j]) !=
             __float_as_uint(key_word(k0, s.bound[0]));
#pragma unroll
      for (int p = 0; p < MAX_PASSES; ++p) {
        if (p == s.n_pass) break;
        atomicAdd(&h[p * BINS + (((s.sel[p] ? k1[j] : k0) >> s.shift[p]) &
                                 ((1u << s.bits[p]) - 1u))],
                  1u);
      }
    }
  }
  if (__syncthreads_or(odd) && tid == 0) atomicOr(&ctl[CTL_ODD], 1u);
  unsigned* const hist = ctl + CTL_HIST;
  for (int i = tid; i < s.n_pass * BINS; i += P_THREADS)
    if (h[i] != 0u) atomicAdd(&hist[i], h[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&ctl[CTL_DONE], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // One warp a pass: lane l holds digits [8l, 8l + 8).
  constexpr int PER = BINS / 32;
  for (int p = tid >> 5; p < s.n_pass; p += P_WARPS) {
    unsigned* const hp = hist + p * BINS + lane * PER;
    unsigned c[PER], sum = 0u;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      c[j] = __ldcg(hp + j);
      sum += c[j];
    }
    unsigned x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    unsigned run = x - sum;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      hp[j] = run;
      run += c[j];
    }
  }
}

// What one digit pass reads and writes.  The first pass reads the key
// ``key`` (bound ``bound``), later passes the pairs at ``src``; the pass
// writes (key value, index) pairs to ``dst``, the next key's value read
// by index where ``nkey`` is set, or, in the last pass, the outputs,
// gathering the val and key words by index.  A one-key sort whose key
// words all equal key_word of their values (``carry`` and no ``odd``
// flag) moves (key value, val) pairs instead, and the last pass writes
// both as they are, with no gather.
struct PassArgs {
  const float* key;
  unsigned bound;
  int first, last, carry;
  const unsigned* odd;
  int shift;
  unsigned mask;
  const float* nkey;
  unsigned nbound;
  const uint2* src;
  uint2* dst;
  const unsigned* digit_start;   // the pass's exclusive digit starts
  unsigned* tile_counter;
  unsigned* status;              // the pass's look-back words
};

__global__ void __launch_bounds__(P_THREADS)
sort_pass(const Sched s, const PassArgs a, const int* __restrict__ val,
          float* __restrict__ out0, float* __restrict__ out1,
          int* __restrict__ out_val, int n) {
  __shared__ uint2 stage[P_TILE];
  __shared__ unsigned whist[P_WARPS * BINS];
  __shared__ unsigned tile_start[BINS];
  __shared__ unsigned glob[BINS];
  __shared__ unsigned tot[P_WARPS];
  __shared__ int part_s;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  // The tile counter was zeroed before the upsweep ran: a tile is claimed
  // before the previous launch has finished.
  let_next_start();
  if (tid == 0) part_s = (int)atomicAdd(a.tile_counter, 1u);
  for (int i = tid; i < P_WARPS * BINS; i += P_THREADS) whist[i] = 0u;
  wait_prior();
  __syncthreads();
  const int part = part_s;
  const int base = part * P_TILE;
  const int shift = a.shift;
  const unsigned mask = a.mask;
  const bool carry = a.carry && *a.odd == 0u;
  // Warp w holds the tile's pairs [224 w, 224 w + 224): item j of a lane
  // is pair 32 j + lane of them, so a warp's items in (j, lane) order are
  // in element order.
  const int wbase = base + w * 32 * P_ITEMS + lane;
  uint2 e[P_ITEMS];
#pragma unroll
  for (int j = 0; j < P_ITEMS; ++j) {
    const int g = wbase + 32 * j;
    e[j] = g >= n ? make_uint2(0u, 0u)
           : a.first
               ? make_uint2(key_int(a.key[g], a.bound),
                            carry ? (unsigned)val[g] : (unsigned)g)
               : a.src[g];
  }
  // Rank within the warp: the digit's count in the warp's earlier items
  // plus the equal digits of lower lanes.
  unsigned* const row = whist + w * BINS;
  const unsigned lt = (1u << lane) - 1u;
  unsigned rank[P_ITEMS];
#pragma unroll
  for (int j = 0; j < P_ITEMS; ++j) {
    const bool ok = wbase + 32 * j < n;
    const unsigned d = ok ? (e[j].x >> shift) & mask : (unsigned)BINS;
    const unsigned peers = __match_any_sync(FULL, d);
    const unsigned before = ok ? row[d] : 0u;
    rank[j] = before + __popc(peers & lt);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) row[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Thread d: the warps' exclusive offsets of digit d, the tile's count,
  // published at once; then the tile's exclusive start of the digit.
  const int d = tid;
  const bool live_bin = (unsigned)d <= mask;
  unsigned cnt = 0u;
#pragma unroll
  for (int v = 0; v < P_WARPS; ++v) {
    const unsigned c = whist[v * BINS + d];
    whist[v * BINS + d] = cnt;
    cnt += c;
  }
  unsigned* const st = a.status + d;
  if (live_bin) st_status(st + (size_t)part * BINS,
                          (part == 0 ? ST_INCL : ST_AGG) | cnt);
  const unsigned start = block_excl_scan<P_WARPS>(cnt, tot);
  tile_start[d] = start;
  __syncthreads();
  // Stage the tile in digit order.
#pragma unroll
  for (int j = 0; j < P_ITEMS; ++j) {
    if (wbase + 32 * j < n) {
      const unsigned dj = (e[j].x >> shift) & mask;
      stage[tile_start[dj] + whist[w * BINS + dj] + rank[j]] = e[j];
    }
  }
  // Decoupled look-back: the digit's count in the tiles before this one,
  // summed back to the first tile that holds its inclusive prefix.  The
  // words of LOOK_W tiles are read at once; an unpublished one is read
  // again.
  if (live_bin) {
    unsigned excl = 0u;
    if (part > 0) {
      bool done = false;
      for (int k = part - 1; !done;) {
        unsigned v[LOOK_W];
#pragma unroll
        for (int i = 0; i < LOOK_W; ++i)
          v[i] = k - i >= 0 ? ld_status(st + (size_t)(k - i) * BINS) : 0u;
        int used = 0;
#pragma unroll
        for (int i = 0; i < LOOK_W; ++i) {
          if (done || used < i || (v[i] & (ST_AGG | ST_INCL)) == 0u) continue;
          excl += v[i] & ST_VAL;
          done = (v[i] & ST_INCL) != 0u;
          used = i + 1;
        }
        k -= used;
      }
      st_status(st + (size_t)part * BINS, ST_INCL | (excl + cnt));
    }
    glob[d] = a.digit_start[d] + excl - start;
  }
  __syncthreads();
  // Staged pair i of digit d goes to glob[d] + i: each digit's run leaves
  // as contiguous stores.
  const int m = min(P_TILE, n - base);
  if (a.last && carry) {
    for (int i = tid; i < m; i += P_THREADS) {
      const uint2 x = stage[i];
      const unsigned pos = glob[(x.x >> shift) & mask] + i;
      out_val[pos] = (int)x.y;
      out0[pos] = key_word(x.x, a.bound);
    }
  } else if (a.last) {
    for (int i = tid; i < m; i += P_THREADS) {
      const uint2 x = stage[i];
      const unsigned pos = glob[(x.x >> shift) & mask] + i;
      write_out(out0, out1, out_val, pos,
                fetch_out(s, val, out1 != nullptr, x.y));
    }
  } else {
    for (int i = tid; i < m; i += P_THREADS) {
      const uint2 x = stage[i];
      const unsigned pos = glob[(x.x >> shift) & mask] + i;
      a.dst[pos] = make_uint2(
          a.nkey != nullptr ? key_int(a.nkey[x.y], a.nbound) : x.x, x.y);
    }
  }
}

// Devices (bit = ordinal) whose sort_cluster attributes are set: an
// attribute belongs to the device that was current when it was set.
unsigned long long g_cluster_attrs = 0;

}  // namespace

// Sorts n pairs of key0 (and key1: lexicographic (key0, key1)) with val
// into out0 (out1) and out_val.  ``sched`` holds n_pass (key, shift,
// bits) triples on the host.  cluster > 0: one launch on a cluster of
// that many blocks of ``chunk`` pairs; cluster == 0: the device-memory
// route, ``chunk`` == its tile (P_TILE), ``scratch`` holding (32-bit
// words) 2 x n pairs, CTL_HIST control words, the n_pass x 256
// histograms and n_pass x ceil(n / P_TILE) x 256 look-back words
// (ops/sort.py::scratch_words).
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
  s.two = key1 != nullptr;
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
    int cur = 0;
    if ((err = cudaGetDevice(&cur)) != cudaSuccess) return (int)err;
    const unsigned long long bit = 1ull << (cur & 63);
    if (!(g_cluster_attrs & bit)) {
      err = cudaFuncSetAttribute(sort_cluster,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)cluster_smem(CHUNK_MAX));
      if (err != cudaSuccess) return (int)err;
      err = cudaFuncSetAttribute(
          sort_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      g_cluster_attrs |= bit;
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
  // Route 2.  The look-back words hold counts below 2^30.
  if (scratch == nullptr || chunk != P_TILE || n >= (int)ST_AGG)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + P_TILE - 1) / P_TILE;
  unsigned* const words = static_cast<unsigned*>(scratch);
  uint2* const buf[2] = {reinterpret_cast<uint2*>(words),
                         reinterpret_cast<uint2*>(words + 2 * (size_t)n)};
  unsigned* const ctl = words + 4 * (size_t)n;
  unsigned* const status = ctl + CTL_HIST + n_pass * BINS;
  if (reinterpret_cast<uintptr_t>(status) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(ctl, 0, (CTL_HIST + n_pass * BINS) * sizeof(unsigned),
                        stream);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // An upsweep block per U_STEP keys, two an SM at the most: each merges
  // its histograms into the global ones with atomics.
  const int up_need = (n + U_STEP - 1) / U_STEP;
  const int up_blocks = up_need < 2 * sms ? up_need : 2 * sms;
  sort_upsweep<<<up_blocks, P_THREADS, 0, stream>>>(
      s, ctl, reinterpret_cast<uint4*>(status), n_pass * n_tiles * BINS / 4,
      n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int p = 0; p < n_pass; ++p) {
    PassArgs a{};
    a.key = s.key[s.sel[0]];
    a.bound = s.bound[s.sel[0]];
    a.first = p == 0;
    a.last = p + 1 == n_pass;
    a.carry = !s.two;
    a.odd = ctl + CTL_ODD;
    a.shift = s.shift[p];
    a.mask = (1u << s.bits[p]) - 1u;
    if (!a.last && s.sel[p + 1] != s.sel[p]) {
      a.nkey = s.key[s.sel[p + 1]];
      a.nbound = s.bound[s.sel[p + 1]];
    }
    a.src = buf[(p + 1) & 1];
    a.dst = buf[p & 1];
    a.digit_start = ctl + CTL_HIST + p * BINS;
    a.tile_counter = ctl + p;
    a.status = status + (size_t)p * n_tiles * BINS;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_tiles);
    cfg.blockDim = dim3(P_THREADS);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, sort_pass, s, a, v, o0, o1, ov, n);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
