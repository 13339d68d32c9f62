"""Candidate-record expansion with exact tile decode (kernel A).

Port of ``piet_tpu/ops/candfuse.py``.  Each item's (NI, 32) attribute row
expands into one record per (item, tile in its bbox rect), and each record
decodes its tile from its rank with the exact f32 divmod of
``ops/coarse.py::_fdivmod``.  Rows travel as int32 bit patterns: several
words are integers or NaN-pattern colours that must not pass through
float arithmetic.

The CUDA kernel is ``csrc/candfuse.cu``; :func:`cand_records_fused_plain`
is its plain PyTorch version, bit for bit.
"""

from __future__ import annotations

import torch

from .. import kernels

#: Words per candidate row (ops/coarse.py::cand_pack).
CAND_WORDS = 32
#: cand_pack word indices of the packed item ints the decode reads.
W_CEXCL, W_BX0, W_BY0, W_BW = 18, 19, 20, 23


def fdivmod(local: torch.Tensor, w: torch.Tensor):
    """Exact floor-div/mod of small non-negative ints via f32 with residue
    fixup (ops/coarse.py::_fdivmod).  ``w`` >= 1."""
    q = torch.floor(local.to(torch.float32) / w.to(torch.float32)).to(
        torch.int32)
    r = local - q * w
    q = q + (r >= w).to(torch.int32) - (r < 0).to(torch.int32)
    return q, local - q * w


def owner_of(excl: torch.Tensor, counts: torch.Tensor, cap: int):
    """Owning row of every slot in [0, cap): the first row whose inclusive
    cumsum exceeds the slot (clamped to a valid row past the total)."""
    incl = excl + counts
    p = torch.arange(cap, dtype=torch.int32, device=excl.device)
    s = torch.searchsorted(incl, p, right=True)
    return p, s.clamp(max=max(excl.shape[0] - 1, 0))


def cand_records_fused_plain(cand_pack, counts, excl, total, row0: int,
                             cap: int, *, tiles_x: int):
    """Plain PyTorch version of kernel A; see :func:`cand_records_fused`."""
    p, s = owner_of(excl, counts, cap)
    valid = (p < total)[:, None]
    ca = torch.where(valid, cand_pack[s], 0)
    local = p - ca[:, W_CEXCL]
    dy, dx = fdivmod(local, torch.clamp(ca[:, W_BW], min=1))
    cand_ty = ca[:, W_BY0] + dy
    cand_tx = ca[:, W_BX0] + dx
    cand_tile = (cand_ty - row0) * tiles_x + cand_tx
    return ca.view(torch.float32), cand_tile, cand_ty, cand_tx


def cand_records_fused(cand_pack, counts, excl, total, row0: int, cap: int,
                       *, tiles_x: int):
    """Expand per-item rows into candidate records with tile decode.

    Args:
      cand_pack: (NI, 32) int32 bit patterns (ops/coarse.py::cand_pack).
      counts/excl: (NI,) int32 tile-rect areas and their exclusive cumsum.
      total: () or (1,) int32 live candidate count, on the device.
      row0: first tile row of the slab.
      cap: candidate capacity.

    Returns (ca, cand_tile, cand_ty, cand_tx): ``ca`` is (cap, 32) f32
    holding the rows' exact bit patterns, all-zero at and past ``total``;
    the decode is int32, and past ``total`` it is the decode of the zero
    row (ty = slot, tx = 0), as in the staged JAX path.
    """
    if not kernels.on_cuda(cand_pack, counts, excl, total):
        return cand_records_fused_plain(cand_pack, counts, excl, total, row0,
                                        cap, tiles_x=tiles_x)
    ni = cand_pack.shape[0]
    for name, t, shape in (("cand_pack", cand_pack, (ni, CAND_WORDS)),
                           ("counts", counts, (ni,)), ("excl", excl, (ni,)),
                           ("total", total, None)):
        kernels.check_cuda_tensor(t, torch.int32, name, shape)
    if total.numel() != 1:
        raise ValueError("total must hold one count")
    if cand_pack.data_ptr() % 16:
        raise ValueError("cand_pack must be 16-byte aligned")
    dev = cand_pack.device
    ca = torch.empty((cap, CAND_WORDS), dtype=torch.int32, device=dev)
    tile, ty, tx = (torch.empty((cap,), dtype=torch.int32, device=dev)
                    for _ in range(3))
    kernels.launch("candfuse", "piet_candfuse", cand_pack.data_ptr(),
                   counts.data_ptr(), excl.data_ptr(), total.data_ptr(),
                   ca.data_ptr(), tile.data_ptr(), ty.data_ptr(),
                   tx.data_ptr(), ni, cap, tiles_x, int(row0))
    return ca.view(torch.float32), tile, ty, tx
