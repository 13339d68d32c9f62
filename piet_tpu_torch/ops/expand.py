"""Ragged expansion + row gather: the coarse pass's record engine.

Port of ``piet_tpu/ops/expand.py::expand_rows``.  Source ``s`` owns
``counts[s]`` consecutive output slots; every slot gets its owner's row,
``out[p] = rows[src(p)]`` with ``src(p) = #{s : incl[s] <= p}``, so
zero-count sources are skipped.  Slots at or past ``counts.sum()`` are
all-zero bits.  Rows are any 32-bit payload and move as int32 bits.

The CUDA kernel is ``csrc/expand.cu``; :func:`expand_rows_plain` is its
plain PyTorch version (``expand_rows_xla`` of the JAX module), bit for
bit.  The kernel takes blocks of :data:`BLOCK` slots (the owners of a
block's first and last live slot by a one-warp search, then each slot's
owner within that span) and stages up to :data:`STAGE_WORDS` output words
of a block in shared memory before its 16-byte stores; it reads the live
total itself, so a call on the card is one device op.
"""

from __future__ import annotations

import torch

from .. import kernels
from .candfuse import owner_of

I32 = torch.int32

#: Constants of csrc/expand.cu: slots per block, and output words staged
#: in shared memory at once.
BLOCK = 128
STAGE_WORDS = 4096


def _int_bits(rows: torch.Tensor) -> torch.Tensor:
    if rows.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"rows: expected a 32-bit dtype, got {rows.dtype}")
    return rows.contiguous().view(I32)


def _excl(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0, dtype=I32) - counts


def expand_rows_plain(rows: torch.Tensor, counts: torch.Tensor, cap: int,
                      excl=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`expand_rows`."""
    if excl is None:
        excl = _excl(counts)
    bits = _int_bits(rows)
    total = excl[-1] + counts[-1]
    p, s = owner_of(excl, counts, cap)
    out = torch.where((p < total)[:, None], bits[s], 0)
    return out.view(rows.dtype)


def expand_rows(rows: torch.Tensor, counts: torch.Tensor, cap: int,
                excl=None) -> torch.Tensor:
    """Ragged-expand ``rows`` by ``counts`` into ``cap`` output slots.

    Args:
      rows: (S, W) int32 or float32 source rows (moved as bits).
      counts: (S,) int32 slots per source (zeros allowed anywhere).
      cap: output capacity.
      excl: optional precomputed exclusive cumsum of ``counts``.

    Returns (cap, W) of rows.dtype: ``rows[src(p)]`` for live slots,
    all-zero bits at and past ``counts.sum()``.
    """
    if not kernels.on_cuda(rows, counts):
        return expand_rows_plain(rows, counts, cap, excl)
    if excl is None:
        excl = _excl(counts)
    n_src, words = rows.shape
    bits = _int_bits(rows)
    for name, t, shape in (("rows", bits, (n_src, words)),
                           ("counts", counts, (n_src,)),
                           ("excl", excl, (n_src,))):
        kernels.check_cuda_tensor(t, I32, name, shape)
    if n_src == 0:
        raise ValueError("expand_rows needs at least one source row")
    if cap * words >= 2 ** 31:
        raise ValueError("expand_rows: cap * words must stay below 2^31")
    out = torch.empty((cap, words), dtype=I32, device=rows.device)
    kernels.launch("expand", "piet_expand", bits.data_ptr(),
                   counts.data_ptr(), excl.data_ptr(), out.data_ptr(),
                   n_src, words, cap)
    return out.view(rows.dtype)
