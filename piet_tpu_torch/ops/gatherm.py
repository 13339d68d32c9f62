"""Row gather at (monotone) indices for K streams: the coarse pass's
row-fetch engine.

Port of ``piet_tpu/ops/gatherm.py::gather_monotone``: ``out_k[p] =
rows[idx_k[p]]``.  The JAX kernel needs every stream nondecreasing (the
coarse pass's endpoint fetches and backdrop row-start base are); the CUDA
kernel takes any indices.  Indices are clamped into [0, N), as a JAX
gather clamps.  Rows are any 32-bit payload and move as int32 bits.

The CUDA kernel is ``csrc/gatherm.cu`` (all K streams in one launch);
:func:`gather_monotone_plain` is its plain PyTorch version
(``gather_monotone_xla`` of the JAX module).
"""

from __future__ import annotations

import torch

from .. import kernels
from .expand import _int_bits

I32 = torch.int32


def gather_monotone_plain(rows: torch.Tensor, idxs: tuple) -> tuple:
    """Plain PyTorch version of :func:`gather_monotone`."""
    n = rows.shape[0]
    return tuple(rows[torch.clamp(i, 0, n - 1).to(torch.int64)]
                 for i in idxs)


def gather_monotone(rows: torch.Tensor, idxs: tuple) -> tuple:
    """out_k[p] = rows[idx_k[p]] for K index streams.

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
    if len(idxs) * n_slots * words >= 2 ** 31:
        raise ValueError("gather_monotone: output must stay below 2^31 "
                         "words")
    idx = torch.stack(idxs) if len(idxs) > 1 else idxs[0][None]
    out = torch.empty((len(idxs), n_slots, words), dtype=I32,
                      device=rows.device)
    kernels.launch("gatherm", "piet_gatherm", bits.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), n_rows, words, len(idxs),
                   n_slots)
    return tuple(o.view(rows.dtype) for o in out)
