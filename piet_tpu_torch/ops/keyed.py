"""Keyed integer sums: the coarse pass's per-candidate command counts and
winding deltas.

Port of ``piet_tpu/ops/keyed.py::keyed_sum``.  Values are small integers
(0/1/2 command counts, +-1 deltas), every element with |v| <= 256 and
every sum below 2^24, so an f32 sum is exact in any order.  Keys outside
[0, n_out) drop.  The JAX signature's ``lo_bound``/``hi_bound`` window
bounds are left out: only the TPU kernel reads them, to find each key
block's entries.

The CUDA kernel is ``csrc/keyed.cu``; :func:`keyed_sum_plain` is its plain
PyTorch version (``keyed_sum_xla`` of the JAX module, a segment sum).
"""

from __future__ import annotations

import torch

from .. import kernels


def keyed_sum_plain(values: torch.Tensor, keys: torch.Tensor,
                    n_out: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`keyed_sum`: ``index_add_`` into
    n_out + 1 rows, the last catching the dropped keys."""
    k = torch.where((keys >= 0) & (keys < n_out), keys, n_out).to(
        torch.int64)
    acc = torch.zeros((n_out + 1, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    acc.index_add_(0, k, values)
    return acc[:n_out]


def keyed_sum(values: torch.Tensor, keys: torch.Tensor,
              n_out: int) -> torch.Tensor:
    """out[k, v] = sum of values[e, v] over entries with keys[e] == k.

    Args:
      values: (E, V) f32, integer-valued, |v| <= 256, |sums| < 2^24.
      keys: (E,) int32; keys outside [0, n_out) contribute nowhere.
      n_out: number of output keys.

    Returns (n_out, V) f32 sums, exact and independent of order.
    """
    n_ent, width = values.shape
    if not (n_out < 2 ** 24 and n_ent < 2 ** 24):
        raise ValueError("keyed_sum: keys and entries must stay below 2^24")
    if not kernels.on_cuda(values, keys):
        return keyed_sum_plain(values, keys, n_out)
    kernels.check_cuda_tensor(values, torch.float32, "values",
                              (n_ent, width))
    kernels.check_cuda_tensor(keys, torch.int32, "keys", (n_ent,))
    out = torch.zeros((n_out, width), dtype=torch.float32,
                      device=values.device)
    kernels.launch("keyed", "piet_keyed", values.data_ptr(),
                   keys.data_ptr(), out.data_ptr(), n_ent, width, n_out)
    return out
