"""Row gathers of the coarse pass: the generic K-stream gather, the
segment endpoint fetch and the backdrop's row-start base.

Port of ``piet_tpu/ops/gatherm.py::gather_monotone``: ``out_k[p] =
rows[idx_k[p]]``.  The JAX kernel needs every stream nondecreasing (the
coarse pass's endpoint fetches and backdrop row-start base are); the CUDA
kernel takes any indices.  Indices are clamped into [0, N), as a JAX
gather clamps.  Rows are any 32-bit payload and move as int32 bits.

The coarse pass calls the gather at two sites, and each site is one
launch with its index streams and its masks inside:

- :func:`gather_endpoints`: both endpoints of every segment slot from the
  expanded item rows (``ops/coarse.py::derive_seg_stage``, the device
  animation path; ``piet_tpu/ops/coarse.py:420-449``);
- :func:`backdrop_from_csum`: each candidate's winding backdrop from the
  running sum of its deltas (every frame; ``piet_tpu/ops/coarse.py:
  854-872``).

The CUDA kernels are ``csrc/gatherm.cu`` (a C entry each, one gather
routine shared by all three); each ``*_plain`` function is its plain PyTorch
version, bit for bit, and :func:`endpoint_streams` and
:func:`backdrop_streams` give the generic gather that the plain versions
of the two sites make.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..scene.scene import TAG_CLIP, TAG_FILL
from .expand import _int_bits

I32, F32 = torch.int32, torch.float32

#: csrc/gatherm.cu's most index streams a call.
MAX_STREAMS = 4
#: Words of an expanded item row (ops/coarse.py::derive_seg_stage) and the
#: ones the endpoint fetch reads: tag, n_pts, pt_offset, the item's first
#: segment slot, the carried first point (two words).
SITEM_WORDS = 14
S_TAG, S_NPTS, S_PTOFF, S_SEXCL, S_FIRST = 0, 1, 2, 10, 12
#: Candidate row words the backdrop reads (ops/candfuse.py).
W_CEXCL, W_BY0, W_BW = 18, 20, 23


def gather_monotone_plain(rows: torch.Tensor, idxs: tuple) -> tuple:
    """Plain PyTorch version of :func:`gather_monotone`."""
    n = rows.shape[0]
    return tuple(rows[torch.clamp(i, 0, n - 1).to(torch.int64)]
                 for i in idxs)


def gather_monotone(rows: torch.Tensor, idxs: tuple) -> tuple:
    """out_k[p] = rows[idx_k[p]] for K <= 4 index streams, one launch.

    Args:
      rows: (N, W) int32 or float32 source rows (moved as bits), N >= 1.
      idxs: tuple of K (P,) int32 index streams of one length.

    Returns a tuple of K (P, W) tensors of rows.dtype.
    """
    idxs = tuple(idxs)
    if not kernels.on_cuda(rows, *idxs):
        return gather_monotone_plain(rows, idxs)
    n_rows, words = rows.shape
    n_slots = idxs[0].shape[0]
    bits = _int_bits(rows)
    for k, i in enumerate(idxs):
        kernels.check_cuda_tensor(i, I32, f"idxs[{k}]", (n_slots,))
    if n_rows == 0:
        raise ValueError("gather_monotone needs at least one row")
    if not 1 <= len(idxs) <= MAX_STREAMS:
        raise ValueError(f"gather_monotone takes 1 to {MAX_STREAMS} index "
                         "streams")
    if len(idxs) * n_slots * words >= 2 ** 31:
        raise ValueError("gather_monotone: output must stay below 2^31 "
                         "words")
    out = torch.empty((len(idxs), n_slots, words), dtype=I32,
                      device=rows.device)
    ptrs = [i.data_ptr() for i in idxs] + [None] * (MAX_STREAMS - len(idxs))
    kernels.launch("gatherm", "piet_gather_rows", bits.data_ptr(), *ptrs,
                   out.data_ptr(), n_rows, words, len(idxs), n_slots)
    return tuple(o.view(rows.dtype) for o in out)


# ---- the endpoint fetch ---------------------------------------------------

def endpoint_streams(sitem: torch.Tensor, points: torch.Tensor,
                     n_segs: torch.Tensor):
    """``(points, (i0, i0 + 1))``: the endpoint fetch's generic gather.
    Each live segment slot's first point index and the next, clamped into
    the point table; dead slots pinned to its last row (both streams
    nondecreasing, as the JAX kernel needs)."""
    S = sitem.shape[0]
    np_max = points.shape[0] - 1
    seg_idx = torch.arange(S, dtype=I32, device=sitem.device)
    seg_valid = seg_idx < n_segs
    i0 = sitem[:, S_PTOFF] + (seg_idx - sitem[:, S_SEXCL])
    i0_g = torch.where(seg_valid, torch.clamp(i0, 0, np_max), np_max)
    j1_g = torch.where(seg_valid, torch.clamp(i0 + 1, 0, np_max), np_max)
    return points, (i0_g, j1_g)


def gather_endpoints_plain(sitem: torch.Tensor, points: torch.Tensor,
                           n_segs: torch.Tensor):
    """Plain PyTorch version of :func:`gather_endpoints`: the coarse pass's
    former glue around :func:`gather_monotone_plain`."""
    S = sitem.shape[0]
    seg_idx = torch.arange(S, dtype=I32, device=sitem.device)
    seg_valid = seg_idx < n_segs
    seg_local = seg_idx - sitem[:, S_SEXCL]
    s_tag = sitem[:, S_TAG]
    s_is_fill_tag = (s_tag == TAG_FILL) | (s_tag == TAG_CLIP)
    wrap = s_is_fill_tag & (seg_local + 1 == sitem[:, S_NPTS])
    p0e, p1n = gather_monotone_plain(*endpoint_streams(sitem, points,
                                                       n_segs))
    first = sitem.view(F32)[:, S_FIRST:S_FIRST + 2]
    p1e = torch.where(wrap[:, None], first, p1n)
    p0 = torch.where(seg_valid[:, None], p0e, 0.0)
    p1 = torch.where(seg_valid[:, None], p1e, 0.0)
    return p0, p1


def gather_endpoints(sitem: torch.Tensor, points: torch.Tensor,
                     n_segs: torch.Tensor):
    """Both endpoints of every segment slot, one launch on the card.

    Args:
      sitem: (S, 14) int32 expanded item rows, one per segment slot
        (``ops/coarse.py::derive_seg_stage``: words 0 tag, 1 n_pts,
        2 pt_offset, 10 the item's first segment slot, 12-13 the bits of
        its first point).
      points: (NP, 2) f32 point table, NP >= 1.
      n_segs: (1,) int32 live segment count, on the device.

    Returns (p0, p1), each (S, 2) f32: slot p's points at i0 = pt_offset
    + (p - first slot) and i0 + 1, both clamped into the table, and at a
    fill's or clip's last segment (its wrap-around) p1 is the carried
    first point; both are +0.0 at and past ``n_segs``.
    """
    if not kernels.on_cuda(sitem, points, n_segs):
        return gather_endpoints_plain(sitem, points, n_segs)
    S = sitem.shape[0]
    kernels.check_cuda_tensor(sitem, I32, "sitem", (S, SITEM_WORDS))
    kernels.check_cuda_tensor(points, F32, "points")
    kernels.check_cuda_tensor(n_segs, I32, "n_segs", (1,))
    if points.dim() != 2 or points.shape[1] != 2 or points.shape[0] == 0:
        raise ValueError("points must be (NP >= 1, 2)")
    p0, p1 = (torch.empty((S, 2), dtype=F32, device=sitem.device)
              for _ in range(2))
    kernels.launch("gatherm", "piet_gather_endpoints", points.data_ptr(),
                   sitem.data_ptr(), n_segs.data_ptr(), p0.data_ptr(),
                   p1.data_ptr(), points.shape[0], S)
    return p0, p1


# ---- the backdrop ---------------------------------------------------------

def backdrop_streams(csum: torch.Tensor, ca: torch.Tensor,
                     cand_ty: torch.Tensor):
    """``(csum[:, None], (sb_idx,))``: the backdrop's generic gather.
    ``sb_idx`` is the slot before each candidate's row start, clamped
    into [0, cap); the row starts are nondecreasing (candidates expand
    item- and row-major, dead slots continue as their slot), and so is
    the stream."""
    cap = csum.shape[0]
    crs = cand_row_start(ca, cand_ty)
    return csum[:, None], (torch.clamp(crs - 1, 0, cap - 1),)


def cand_row_start(ca: torch.Tensor, cand_ty: torch.Tensor):
    """Each candidate's first slot in its item's tile row: the item's first
    slot + (ty - the rect's first row) * the rect's width (at least 1)."""
    ci = _int_bits(ca)
    return ci[:, W_CEXCL] + (cand_ty - ci[:, W_BY0]) * torch.clamp(
        ci[:, W_BW], min=1)


def backdrop_from_csum_plain(csum: torch.Tensor, ca: torch.Tensor,
                             cand_ty: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`backdrop_from_csum`: the coarse
    pass's former glue around :func:`gather_monotone_plain`."""
    crs = cand_row_start(ca, cand_ty)
    (sb,) = gather_monotone_plain(*backdrop_streams(csum, ca, cand_ty))
    start_base = torch.where(crs > 0, sb[:, 0], 0.0)
    return csum - start_base


def backdrop_from_csum(csum: torch.Tensor, ca: torch.Tensor,
                       cand_ty: torch.Tensor) -> torch.Tensor:
    """Each candidate's winding backdrop, one launch on the card.

    Args:
      csum: (cap,) f32 running sum of the candidates' winding deltas.
      ca: (cap, 32) int32 or f32 candidate rows (kernel A's; words 18 the
        item's first slot, 20 its rect's first tile row, 23 its width).
      cand_ty: (cap,) int32 tile row of each candidate.

    Returns (cap,) f32: ``csum - base``, where ``base`` is csum at the slot
    before the candidate's row start, or +0.0 where that start is 0: the
    prefix of the deltas along the candidate's tile row.
    """
    if not kernels.on_cuda(csum, ca, cand_ty):
        return backdrop_from_csum_plain(csum, ca, cand_ty)
    cap = csum.shape[0]
    bits = _int_bits(ca)
    kernels.check_cuda_tensor(csum, F32, "csum", (cap,))
    kernels.check_cuda_tensor(bits, I32, "ca", (cap, 32))
    kernels.check_cuda_tensor(cand_ty, I32, "cand_ty", (cap,))
    if cap == 0:
        raise ValueError("backdrop_from_csum needs at least one candidate")
    out = torch.empty((cap,), dtype=F32, device=csum.device)
    kernels.launch("gatherm", "piet_gather_backdrop", csum.data_ptr(),
                   bits.data_ptr(), cand_ty.data_ptr(), out.data_ptr(), cap)
    return out


#: The coarse pass's two gather sites: name -> (the call, its plain
#: version, the generic gather its plain version makes).  The coarse pass
#: records each call's arguments under ``taps["gatherm"]`` as (name, args).
SITES = {
    "endpoints": (gather_endpoints, gather_endpoints_plain,
                  endpoint_streams),
    "backdrop": (backdrop_from_csum, backdrop_from_csum_plain,
                 backdrop_streams),
}
