// Kernel A: candidate-record expansion with exact tile decode.
//
// Replaces piet_tpu/ops/candfuse.py::_candfuse_kernel (the Pallas kernel
// behind cand_records_fused).  Each item owns a row-major run of
// (item, tile-in-bbox) candidate slots; slot p copies its owner's 32-word
// row (as raw uint32, so NaN-pattern and integer payload words pass
// untouched) and decodes its tile (ty, tx) with the exact f32 divmod of
// ops/coarse.py::_fdivmod, residue fixup included.  Slots at or past the
// live total get an all-zero row and the decode of that zero row, as the
// staged JAX path does.
//
// Bound on the H100: pure data movement (128 B in, 140 B out per slot;
// ~1.4 MB at the 1664^2 tiger) plus a 9-step binary search per slot over
// the items' inclusive cumsum, which stays in L1/L2.  The TPU kernel
// expanded rows with a banded one-hot matmul because the TPU has no
// gather; here one thread per slot searches its owner and copies the row
// with 16-byte vector loads and stores.
#include "cmd_math.cuh"

namespace {

constexpr int CAND_WORDS = 32;
constexpr int W_CEXCL = 18, W_BX0 = 19, W_BY0 = 20, W_BW = 23;

__global__ void candfuse_kernel(const int4* __restrict__ cand_pack,
                                const int* __restrict__ counts,
                                const int* __restrict__ excl,
                                const int* __restrict__ total_p,
                                int4* __restrict__ ca, int* __restrict__ tile,
                                int* __restrict__ ty, int* __restrict__ tx,
                                int ni, int cap, int tiles_x, int row0) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cap) return;
  const int total = *total_p;
  int4 row[CAND_WORDS / 4];
  if (p < total) {
    // Owner: the first item whose inclusive cumsum exceeds p (items with
    // no candidates own no slot).
    int lo = 0, hi = ni;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (excl[mid] + counts[mid] > p) hi = mid; else lo = mid + 1;
    }
    const int4* src = cand_pack + (size_t)lo * (CAND_WORDS / 4);
#pragma unroll
    for (int k = 0; k < CAND_WORDS / 4; ++k) row[k] = src[k];
  } else {
#pragma unroll
    for (int k = 0; k < CAND_WORDS / 4; ++k) row[k] = make_int4(0, 0, 0, 0);
  }
  int4* dst = ca + (size_t)p * (CAND_WORDS / 4);
#pragma unroll
  for (int k = 0; k < CAND_WORDS / 4; ++k) dst[k] = row[k];

  const int* w = reinterpret_cast<const int*>(row);
  const int local = p - w[W_CEXCL];
  int dy, dx;
  piet::fdivmod(local, max(w[W_BW], 1), &dy, &dx);
  const int cty = w[W_BY0] + dy;
  const int ctx = w[W_BX0] + dx;
  ty[p] = cty;
  tx[p] = ctx;
  tile[p] = (cty - row0) * tiles_x + ctx;
}

}  // namespace

extern "C" int piet_candfuse(const void* cand_pack, const void* counts,
                             const void* excl, const void* total, void* ca,
                             void* tile, void* ty, void* tx, int ni, int cap,
                             int tiles_x, int row0, cudaStream_t stream) {
  if (cap <= 0) return 0;
  const int threads = 256;
  candfuse_kernel<<<(cap + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const int4*>(cand_pack), static_cast<const int*>(counts),
      static_cast<const int*>(excl), static_cast<const int*>(total),
      static_cast<int4*>(ca), static_cast<int*>(tile), static_cast<int*>(ty),
      static_cast<int*>(tx), ni, cap, tiles_x, row0);
  return (int)cudaGetLastError();
}
