// What the two fine kernels share: their band layout, the cp.async
// staging helpers and the dense-first tile order.
//
// Band layout.  A block is a band of a tile: each thread takes R
// neighbouring pixels of one row, a block at most THREADS threads (bx
// columns of threads by ny rows), col_groups blocks across a tile row
// when bx * R < tile_w.  R is 8 on tiles 64 pixels wide or more and 4 on
// narrower ones: the R pixels share each command's dispatch and its terms
// that depend on the row alone, but a thread's work on a tile grows with
// R, and on a narrow tile a band is then only a few warps (at 16x16 tiles
// kernel D took 0.061 ms with 4 pixels a thread against 0.120 with 8;
// PERF.md).  Columns past tile_w (a ragged edge) are computed and not
// written.
//
// Tile order.  One block sorts the tiles by the bit length of their
// command or entry count, heaviest first, and the main grid takes its
// tiles in that order, a tile's bands side by side.  Blocks go out
// roughly in index order, so the longest blocks start first and the short
// ones fill in behind them instead of leaving a dense tile alone at the
// end.  The order only schedules: blocks are independent, so any order
// gives the same pixels.
#pragma once

#include "cmd_math.cuh"

namespace {

constexpr int THREADS = 128;        // threads per block at most
constexpr int ORDER_THREADS = 1024;
constexpr int ORDER_BINS = 32;      // by bit length of the count

struct Bands {
  int r;           // pixels of a row per thread
  int bx, ny;      // threads per block: bx across, ny rows
  int col_groups;  // blocks across a tile row
  int per_tile;    // blocks per tile
};

inline Bands band_layout(int tile_w, int tile_h) {
  Bands b;
  b.r = tile_w >= 64 ? 8 : 4;
  b.bx = min((tile_w + b.r - 1) / b.r, THREADS);
  b.col_groups = (tile_w + b.bx * b.r - 1) / (b.bx * b.r);
  b.ny = max(1, min(THREADS / b.bx, tile_h));
  b.per_tile = b.col_groups * ((tile_h + b.ny - 1) / b.ny);
  return b;
}

// This thread's place: tile ``t`` (order[blockIdx.x / per_tile]), its
// first column c0 and its row in the tile.
struct BandPos {
  int t, c0, row;
};

template <int R>
__device__ __forceinline__ BandPos band_pos(const int* __restrict__ order,
                                            int col_groups, int per_tile) {
  const int sub = blockIdx.x % per_tile;
  BandPos p;
  p.t = order[blockIdx.x / per_tile];
  p.c0 = ((sub % col_groups) * blockDim.x + threadIdx.x) * R;
  p.row = (sub / col_groups) * blockDim.y + threadIdx.y;
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// order[0..n_tiles): the tiles by decreasing bit length of min(count,
// cap) (ties in no fixed order).  One block.
__global__ void __launch_bounds__(ORDER_THREADS)
tile_order(const int* __restrict__ count, int n_tiles, int cap,
           int* __restrict__ order) {
  __shared__ unsigned cnt[ORDER_BINS];
  const int tid = threadIdx.x;
  const auto bin = [&](int t) {
    return ORDER_BINS - 1 - (32 - __clz(min(max(count[t], 0), cap)));
  };
  if (tid < ORDER_BINS) cnt[tid] = 0u;
  __syncthreads();
  for (int t = tid; t < n_tiles; t += ORDER_THREADS)
    atomicAdd(&cnt[bin(t)], 1u);
  __syncthreads();
  if (tid == 0) {
    unsigned run = 0u;
    for (int b = 0; b < ORDER_BINS; ++b) {
      const unsigned c = cnt[b];
      cnt[b] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int t = tid; t < n_tiles; t += ORDER_THREADS)
    order[atomicAdd(&cnt[bin(t)], 1u)] = t;
}

// Launch tile_order; the CUDA error of the launch.
inline cudaError_t launch_tile_order(const int* count, int n_tiles, int cap,
                                     int* order, cudaStream_t stream) {
  tile_order<<<1, ORDER_THREADS, 0, stream>>>(count, n_tiles, cap, order);
  return cudaGetLastError();
}

}  // namespace
