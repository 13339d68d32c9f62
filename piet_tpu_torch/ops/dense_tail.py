"""The coarse pass's dense tail on the card: the sorted entry records ->
each tile's (T, CAP) command list, one launch of ``csrc/dense_tail.cu``.

The pass (``ops/coarse.py::coarse_rasterize(output="dense")``) calls
:func:`dense_tail` for CUDA tensors and its plain version,
``ops/coarse.py::_dense_ptcl`` (the JAX pass's dense tail, in PyTorch),
for CPU tensors, and both give the same words.  The kernel reads each
entry's meta word itself (command count, opaque, clearing), finds each
tile's entries as the one run the sort leaves them in, and writes every
output word once: no scratch, no copy, no atomics.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..layout.entry_stream import ENTRY_WORDS
from ..raster.ptcl import ARG_WORDS

I32, F32 = torch.int32, torch.float32


def dense_tail(rows: torch.Tensor, sorted_idx: torch.Tensor,
               e_tile: torch.Tensor, c_color_bits: torch.Tensor, *,
               n_tiles: int, max_hits: int, cmd_capacity: int):
    """The dense PTCL of the sorted records, on the card.

    Args:
      rows: (E, 16) int32 sorted records, dead rows zero, 16-byte aligned.
      sorted_idx: (E,) int32 source row of each record: a hit record below
        ``max_hits``, else candidate ``sorted_idx - max_hits``.
      e_tile: (E,) int32 tile of each record, non-decreasing, the dead
        records last at ``n_tiles``.
      c_color_bits: (max_candidates,) int32 colour bits of the candidates,
        any row stride (a column of the candidate rows).

    Returns ``(tags, args, counts, solid, overflow)``: (T, CAP) int32,
    (T, CAP * 12) f32, and (T,) int32 commands kept, bail colour and
    commands dropped past CAP, as ``ops/coarse.py::_dense_ptcl`` gives
    them.
    """
    if not kernels.on_cuda(rows, sorted_idx, e_tile, c_color_bits):
        raise ValueError("dense_tail runs on CUDA tensors only")
    n_ent = rows.shape[0]
    kernels.check_cuda_tensor(rows, I32, "rows", (n_ent, ENTRY_WORDS))
    kernels.check_cuda_tensor(sorted_idx, I32, "sorted_idx", (n_ent,))
    kernels.check_cuda_tensor(e_tile, I32, "e_tile", (n_ent,))
    if c_color_bits.dtype != I32 or c_color_bits.dim() != 1:
        raise ValueError("c_color_bits: expected a 1-D int32 tensor")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    if n_ent == 0 or cmd_capacity <= 0:
        raise ValueError("dense_tail needs records and a positive capacity")
    dev = rows.device
    tags = torch.empty((n_tiles, cmd_capacity), dtype=I32, device=dev)
    args = torch.empty((n_tiles, cmd_capacity * ARG_WORDS), dtype=I32,
                       device=dev)
    counts, solid, overflow = (torch.empty((n_tiles,), dtype=I32, device=dev)
                               for _ in range(3))
    kernels.launch("dense_tail", "piet_dense_tail", rows.data_ptr(),
                   sorted_idx.data_ptr(), e_tile.data_ptr(),
                   c_color_bits.data_ptr(), tags.data_ptr(), args.data_ptr(),
                   counts.data_ptr(), solid.data_ptr(), overflow.data_ptr(),
                   n_ent, n_tiles, cmd_capacity, max_hits,
                   c_color_bits.stride(0))
    return tags, args.view(F32), counts, solid, overflow
