"""The dense PTCL interpreter with the clip/layer group stacks.

Port of ``piet_tpu/ops/fine_xla.py::fine_rasterize_xla``: the same
contract as ``ops/fine.py::fine_rasterize`` with fifteen branches, tag map
``clip(tag - 2, 0, 14)`` -- the seven core commands, a no-op, begin/end
clip, begin/end layer, linear and radial gradient and the winding carry.
In the JAX package it is plain XLA (a ``vmap`` over tiles of a
``fori_loop`` over command slots); here it runs on the card through the
same CUDA kernel as ``fine_rasterize`` (``csrc/fine_dense.cu``, the group
instantiation).  Its plain version is ``ops/fine.py::dense_plain`` with
``groups=True``.  On tags 2-9 both entry points compute the same pixels.
"""

from __future__ import annotations

import torch

from .. import kernels
from .fine import dense_plain, launch_dense


def fine_rasterize_xla_plain(counts, tags, args, row0=0, *, tile_h: int,
                             tile_w: int, cmd_capacity: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fine_rasterize_xla`."""
    return dense_plain(counts, tags, args, row0, tile_h=tile_h,
                       tile_w=tile_w, cmd_capacity=cmd_capacity, groups=True)


def fine_rasterize_xla(counts, tags, args, row0=0, *, tile_h: int,
                       tile_w: int, cmd_capacity: int) -> torch.Tensor:
    """Rasterize all tiles of a slab from the dense PTCL, group commands
    included.  Arguments and result as ``ops/fine.py::fine_rasterize``."""
    if not kernels.on_cuda(counts, tags, args):
        return fine_rasterize_xla_plain(counts, tags, args, row0,
                                        tile_h=tile_h, tile_w=tile_w,
                                        cmd_capacity=cmd_capacity)
    return launch_dense(counts, tags, args, row0, tile_h=tile_h,
                        tile_w=tile_w, cmd_capacity=cmd_capacity, groups=True)
