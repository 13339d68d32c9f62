// Row gathers of the coarse pass: the generic K-stream gather, the
// segment endpoint fetch and the backdrop's row-start base, each one
// launch with its indices computed and its rows masked inside.
//
// Replaces piet_tpu/ops/gatherm.py::_make_kernel (the Pallas kernel
// behind gather_monotone) and the XLA glue around its two call sites
// (piet_tpu/ops/coarse.py:420-436: the endpoint index streams, the fill
// wrap-around and the dead-slot masks; :854-872: the candidates' row
// starts, the base fetch and the subtraction).  Three kernels, each with
// its own C entry point; all three move rows through one routine,
// gather_row: row i, clamped into [0, n_rows)
// as a JAX gather clamps, copied as 32-bit words (never through a float
// register op) in 16- or 8-byte pieces where the row width and the
// pointers allow.
//
// - gather_rows: out_k[p] = rows[idx_k[p]], one thread per (stream,
//   slot) moving the whole row; the K <= 4 index streams are passed by
//   value (the y grid dimension picks one), so nothing stacks them.
// - gather_endpoints: segment slot p reads its row of the expanded item
//   rows (S, 14) in place and fetches both endpoints: p0 = points[i0] and
//   p1 = points[i0 + 1], or the row's carried first point (words 12-13)
//   at a fill's or clip's wrap-around segment; slots at or past n_segs
//   (read on the device) are +0.0.
// - backdrop: candidate p's row start from its row's words 18, 20, 23
//   and its tile row, csum at the slot before it (+0.0 at a start of 0)
//   and csum[p] minus that base, one f32 subtraction.
//
// Bound on the H100: data movement (the affine tiger: 49,152 segment
// slots, 2 x 0.39 MB of endpoints written; the static tiger's backdrop,
// 10,240 candidates), but a call this small is bound by its launch and
// one chain of dependent loads (the index or the row, then the fetched
// row).  The TPU kernel needed the indices nondecreasing: it walked one
// source window per block of slots and gathered with a one-hot bf16
// matmul, because its vector core has no gather.  A GPU thread loads any
// address; the glue's 9 and about 14 device ops around the two call
// sites become part of the one launch.
#include "cmd_math.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_STREAMS = 4;
constexpr int SITEM_WORDS = 14;     // ops/coarse.py::derive_seg_stage rows
constexpr int CAND_WORDS = 32;
constexpr int TAG_FILL = 3, TAG_CLIP = 5;   // scene/scene.py
constexpr int S_TAG = 0, S_NPTS = 1, S_PTOFF = 2, S_SEXCL = 10, S_FIRST = 12;
constexpr int W_CEXCL = 18, W_BY0 = 20, W_BW = 23;

struct Streams {
  const int* idx[MAX_STREAMS];
};

template <int VEC> struct Piece;
template <> struct Piece<1> { using type = int; };
template <> struct Piece<2> { using type = int2; };
template <> struct Piece<4> { using type = int4; };

// Row i of rows (n_rows x words 32-bit words), clamped into [0, n_rows),
// to dst, VEC words at a time (rows, dst and words aligned to VEC).
template <int VEC>
__device__ __forceinline__ void gather_row(const int* __restrict__ rows,
                                           int n_rows, int words, int i,
                                           int* dst) {
  using P = typename Piece<VEC>::type;
  i = min(max(i, 0), n_rows - 1);
  const P* src = reinterpret_cast<const P*>(rows + (size_t)i * words);
  P* d = reinterpret_cast<P*>(dst);
  for (int k = 0; k < words / VEC; ++k) d[k] = src[k];
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
gather_rows(const int* __restrict__ rows, Streams s, int* __restrict__ out,
            int n_rows, int words, int n_slots) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n_slots) return;
  const int k = blockIdx.y;
  const int* idx = k == 0 ? s.idx[0] : k == 1 ? s.idx[1]
                 : k == 2 ? s.idx[2] : s.idx[3];
  gather_row<VEC>(rows, n_rows, words, idx[p],
                  out + ((size_t)k * n_slots + p) * words);
}

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
gather_endpoints(const int* __restrict__ points,
                 const int* __restrict__ sitem,
                 const int* __restrict__ n_segs_p, int* __restrict__ p0,
                 int* __restrict__ p1, int n_points, int n_slots) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n_slots) return;
  int* d0 = p0 + 2 * (size_t)p;
  int* d1 = p1 + 2 * (size_t)p;
  if (p >= *n_segs_p) {  // dead slot: +0.0
    d0[0] = d0[1] = d1[0] = d1[1] = 0;
    return;
  }
  const int* row = sitem + (size_t)p * SITEM_WORDS;
  const int tag = row[S_TAG];
  const int local = (int)((unsigned)p - (unsigned)row[S_SEXCL]);
  const int i0 = wadd(row[S_PTOFF], local);
  gather_row<VEC>(points, n_points, 2, i0, d0);
  const bool fill = tag == TAG_FILL || tag == TAG_CLIP;
  if (fill && wadd(local, 1) == row[S_NPTS]) {  // the wrap-around
    d1[0] = row[S_FIRST];
    d1[1] = row[S_FIRST + 1];
  } else {
    gather_row<VEC>(points, n_points, 2, wadd(i0, 1), d1);
  }
}

__global__ void __launch_bounds__(THREADS)
backdrop(const int* __restrict__ csum, const int* __restrict__ ca,
         const int* __restrict__ cand_ty, float* __restrict__ out, int cap) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= cap) return;
  const int* row = ca + (size_t)p * CAND_WORDS;
  const int crs = (int)((unsigned)row[W_CEXCL] +
                        ((unsigned)cand_ty[p] - (unsigned)row[W_BY0]) *
                            (unsigned)max(row[W_BW], 1));
  int base = 0;  // +0.0
  if (crs > 0) gather_row<1>(csum, cap, 1, crs - 1, &base);
  out[p] = __fsub_rn(__int_as_float(csum[p]), __int_as_float(base));
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<size_t>(p) & (size_t)(bytes - 1)) == 0;
}

// The widest piece (4, 2 or 1 words) that divides the row width and to
// which both pointers are aligned.
int piece_words(const void* a, const void* b, int words) {
  for (int v = 4; v > 1; v >>= 1)
    if (words % v == 0 && aligned(a, 4 * v) && aligned(b, 4 * v)) return v;
  return 1;
}

}  // namespace

// rows (n_rows, words) int32 words; idx0..idx3 the first n_streams of K
// (n_slots,) int32 index streams (the rest unused); out (n_streams,
// n_slots, words).
extern "C" int piet_gather_rows(const void* rows, const void* idx0,
                                const void* idx1, const void* idx2,
                                const void* idx3, void* out, int n_rows,
                                int words, int n_streams, int n_slots,
                                cudaStream_t stream) {
  if (n_slots <= 0) return 0;
  if (n_rows <= 0 || n_streams < 1 || n_streams > MAX_STREAMS || words <= 0)
    return (int)cudaErrorInvalidValue;
  const Streams s = {{static_cast<const int*>(idx0),
                      static_cast<const int*>(idx1),
                      static_cast<const int*>(idx2),
                      static_cast<const int*>(idx3)}};
  const dim3 g((n_slots + THREADS - 1) / THREADS, n_streams);
  const int* r = static_cast<const int*>(rows);
  int* o = static_cast<int*>(out);
  switch (piece_words(rows, out, words)) {
    case 4:
      gather_rows<4><<<g, THREADS, 0, stream>>>(r, s, o, n_rows, words,
                                                n_slots);
      break;
    case 2:
      gather_rows<2><<<g, THREADS, 0, stream>>>(r, s, o, n_rows, words,
                                                n_slots);
      break;
    default:
      gather_rows<1><<<g, THREADS, 0, stream>>>(r, s, o, n_rows, words,
                                                n_slots);
  }
  return (int)cudaGetLastError();
}

// points (n_points, 2) f32; sitem the expanded item rows (n_slots, 14)
// int32; n_segs (1,) int32; p0 and p1 (n_slots, 2) f32.
extern "C" int piet_gather_endpoints(const void* points, const void* sitem,
                                     const void* n_segs, void* p0, void* p1,
                                     int n_points, int n_slots,
                                     cudaStream_t stream) {
  if (n_slots <= 0) return 0;
  if (n_points <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_slots + THREADS - 1) / THREADS);
  const int* pt = static_cast<const int*>(points);
  const int* si = static_cast<const int*>(sitem);
  const int* ns = static_cast<const int*>(n_segs);
  int* a = static_cast<int*>(p0);
  int* b = static_cast<int*>(p1);
  if (piece_words(points, a, 2) == 2 && aligned(b, 8))
    gather_endpoints<2><<<grid, THREADS, 0, stream>>>(pt, si, ns, a, b,
                                                      n_points, n_slots);
  else
    gather_endpoints<1><<<grid, THREADS, 0, stream>>>(pt, si, ns, a, b,
                                                      n_points, n_slots);
  return (int)cudaGetLastError();
}

// csum (cap,) f32; ca the candidate rows (cap, 32) int32; cand_ty (cap,)
// int32; out the backdrop (cap,) f32.
extern "C" int piet_gather_backdrop(const void* csum, const void* ca,
                                    const void* cand_ty, void* out, int cap,
                                    cudaStream_t stream) {
  if (cap <= 0) return 0;
  backdrop<<<(cap + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const int*>(csum), static_cast<const int*>(ca),
      static_cast<const int*>(cand_ty), static_cast<float*>(out), cap);
  return (int)cudaGetLastError();
}
