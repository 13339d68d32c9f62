"""Stable sort of the coarse pass's packed keys (kernel C).

Port of ``piet_tpu/ops/sort.py::stable_sort_multi``.  The record index
(``val``, unique) rides in the comparison, so the bitonic network's result
equals a stable sort on the keys.  The plain version is
``torch.sort(stable=True)``; the CUDA kernel (``csrc/sort.cu``) takes the
single packed f32 key of the main path.
"""

from __future__ import annotations

import torch

from .. import kernels

#: The bitonic kernel sorts at least one shared-memory block of pairs.
MIN_SORT = 2048


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def stable_sort_multi_plain(keys, val: torch.Tensor):
    """Stable lexicographic sort of (keys..., val) by ``keys``: successive
    stable sorts from the last key to the first."""
    keys = tuple(keys)
    perm = torch.arange(val.shape[0], device=val.device)
    for k in reversed(keys):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return tuple(k[perm] for k in keys), val[perm]


def stable_sort_multi(keys, val: torch.Tensor):
    """Stable lexicographic sort of (keys..., val) by ``keys``.

    ``val`` must be unique (the record index in the coarse pass).  Returns
    (sorted_keys_tuple, sorted_val).  On CUDA only the single f32 key of
    the main path is supported: the two-key sort belongs to the unpacked
    key fallback (ROADMAP.md, Queue 1), which raises in the coarse pass.
    """
    keys = tuple(keys)
    if not kernels.on_cuda(*keys, val):
        return stable_sort_multi_plain(keys, val)
    if len(keys) != 1:
        raise NotImplementedError(
            "two-key sort on CUDA: see ROADMAP.md Queue 1, 'unpacked sort "
            "key fallback'")
    (key,) = keys
    n = key.shape[0]
    kernels.check_cuda_tensor(key, torch.float32, "key", (n,))
    kernels.check_cuda_tensor(val, torch.int32, "val", (n,))
    np2 = max(_next_pow2(n), MIN_SORT)
    k_buf = torch.full((np2,), float("inf"), dtype=torch.float32,
                       device=key.device)
    v_buf = torch.arange(np2, dtype=torch.int32, device=key.device)
    k_buf[:n] = key
    v_buf[:n] = val
    kernels.launch("sort", "piet_sort_f32_i32", k_buf.data_ptr(),
                   v_buf.data_ptr(), np2)
    return (k_buf[:n],), v_buf[:n]
