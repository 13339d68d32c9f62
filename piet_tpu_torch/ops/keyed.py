"""Keyed integer sums: the coarse pass's per-candidate command counts and
winding deltas.

Port of ``piet_tpu/ops/keyed.py::keyed_sum_xla`` (the segment_sum the JAX
main path uses).  Values are small integers (0/1/2 command counts, +-1
deltas), so an int32 ``index_add_`` is exact and order-free; the result is
cast to f32 as the JAX sum returns it.  Keys outside [0, n_out) drop.
"""

from __future__ import annotations

import torch


def keyed_sum(values: torch.Tensor, keys: torch.Tensor,
              n_out: int) -> torch.Tensor:
    """(E,) integer-valued f32 ``values`` summed into (n_out,) f32 by
    ``keys``."""
    k = torch.where((keys >= 0) & (keys < n_out), keys, n_out).to(torch.int64)
    acc = torch.zeros(n_out + 1, dtype=torch.int32, device=values.device)
    acc.index_add_(0, k, values.to(torch.int32))
    return acc[:n_out].to(torch.float32)
