"""Stable sort of the coarse pass's keys (kernel C).

Port of ``piet_tpu/ops/sort.py::stable_sort_multi`` and its one-key
wrapper ``stable_sort_pairs``.  The keys are the ones the coarse pass
makes: non-negative integers held in f32 below a bound (``bounds``, at
most 2^24, where f32 stops being exact), and +inf for dead records.  The
plain version is ``torch.sort(stable=True)``, one key at a time from the
last; the CUDA kernel (``csrc/sort.cu``) is a
stable LSD radix sort on the keys' integer values, with +inf mapped to the
bound, so the result is the same for any ``val``.

:func:`sort_plan` fixes what the kernel does for a call: the digit passes
(least significant first: the last key's digits, then the first key's)
and how the pairs are split over blocks.  Up to ``CLUSTER *
CLUSTER_CHUNK`` pairs the whole sort is one launch on one thread-block
cluster whose blocks hold the pairs in shared memory.  Above that it runs
over device memory in 1 + n_pass launches: one upsweep that builds every
pass's digit histogram from the keys, then one launch per digit pass, in
tiles of ``PASS_TILE`` pairs that find their digits' global starts by
decoupled look-back (:func:`scratch_words` sizes its scratch).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels

#: Keys are exact f32 integers below this.
KEY_LIMIT = 2 ** 24
#: Bits of one digit pass (256 bins).
RADIX_BITS = 8
#: Warps per block of the cluster route; a block's pairs are split into
#: one contiguous run per warp, ranked in element order.
WARPS = 32
#: Pairs held by one block of the cluster (its shared memory holds two
#: buffers of 8-byte pairs beside the per-warp digit counts).
CLUSTER_CHUNK = 12288
#: Blocks of the cluster, above the portable 8: more blocks rank fewer
#: pairs each (on an H100, 16 blocks sort the 1664^2 tiger's keys faster
#: than 8: PERF.md).
CLUSTER = 16
#: The device-memory route's tile: PASS_THREADS threads of PASS_ITEMS
#: pairs (warp w ranks the tile's pairs [32 w PASS_ITEMS, 32 (w + 1)
#: PASS_ITEMS) in element order).  1,792 pairs a tile give beziers_10k's
#: 261,504 records 146 tiles, more than the H100's 132 SMs.
PASS_THREADS = 256
PASS_ITEMS = 7
PASS_TILE = PASS_THREADS * PASS_ITEMS
#: The device-memory route's control words ahead of its histograms.
PASS_CTL_WORDS = 16


class SortPlan(NamedTuple):
    """What the kernel does for one call.

    ``passes``: (key, shift, bits) of each digit pass, first pass first.
    ``cluster``: blocks of the cluster, or 0 for the device-memory route.
    ``chunk``: pairs per cluster block (block b holds positions
    [b * chunk, (b + 1) * chunk)), or per tile of the device-memory
    route."""
    passes: Tuple[Tuple[int, int, int], ...]
    cluster: int
    chunk: int


def radix_passes(bounds: Sequence[int]) -> Tuple[Tuple[int, int, int], ...]:
    """Digit passes for keys below ``bounds`` (+inf taking the value of the
    bound itself): the last key's digits first, least significant first,
    each key's bits split into passes of at most RADIX_BITS, widths as
    even as they go."""
    passes = []
    for sel in reversed(range(len(bounds))):
        bits = max(int(bounds[sel]).bit_length(), 1)
        n_pass = -(-bits // RADIX_BITS)
        shift = 0
        for p in range(n_pass):
            w = (bits - shift) // (n_pass - p) + ((bits - shift)
                                                  % (n_pass - p) > 0)
            passes.append((sel, shift, w))
            shift += w
    return tuple(passes)


def sort_plan(n: int, bounds: Sequence[int]) -> SortPlan:
    """The plan for ``n`` pairs: the cluster, its blocks holding an equal
    share, while they hold the pairs; the device-memory route past
    that."""
    passes = radix_passes(bounds)
    if n > CLUSTER * CLUSTER_CHUNK:
        return SortPlan(passes, 0, PASS_TILE)
    return SortPlan(passes, CLUSTER, max(-(-n // CLUSTER), 1))


def scratch_words(n: int, plan: SortPlan) -> int:
    """32-bit words of the device-memory route's scratch: two buffers of n
    8-byte pairs, the control words, a 256-bin histogram per pass and a
    look-back word per (pass, tile, bin)."""
    bins = 1 << RADIX_BITS
    n_pass = len(plan.passes)
    return (4 * n + PASS_CTL_WORDS
            + n_pass * bins * (1 + -(-n // plan.chunk)))


def stable_sort_multi_plain(keys, val: torch.Tensor):
    """Stable lexicographic sort of (keys..., val) by ``keys``: successive
    stable sorts from the last key to the first."""
    keys = tuple(keys)
    perm = torch.arange(val.shape[0], device=val.device)
    for k in reversed(keys):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return tuple(k[perm] for k in keys), val[perm]


def stable_sort_multi(keys, val: torch.Tensor,
                      bounds: Optional[Sequence[int]] = None):
    """Stable lexicographic sort of (keys..., val) by ``keys``.

    Returns (sorted_keys_tuple, sorted_val).  On CUDA it takes one or two
    f32 keys, each holding integers in [0, bound) or +inf, with
    ``bounds`` (default 2^24 each) no larger than 2^24; ``val`` is int32."""
    keys = tuple(keys)
    if not kernels.on_cuda(*keys, val):
        return stable_sort_multi_plain(keys, val)
    if len(keys) not in (1, 2):
        raise ValueError(f"the sort kernel takes 1 or 2 keys, got {len(keys)}")
    bounds = tuple(bounds) if bounds is not None else (KEY_LIMIT,) * len(keys)
    if len(bounds) != len(keys) or not all(0 <= b <= KEY_LIMIT
                                           for b in bounds):
        raise ValueError(f"key bounds {bounds}")
    n = val.shape[0]
    for i, k in enumerate(keys):
        kernels.check_cuda_tensor(k, torch.float32, f"key {i}", (n,))
    kernels.check_cuda_tensor(val, torch.int32, "val", (n,))
    out_keys = tuple(torch.empty_like(k) for k in keys)
    out_val = torch.empty_like(val)
    if n == 0:
        return out_keys, out_val
    plan = sort_plan(n, bounds)
    flat = [v for p in plan.passes for v in p]
    sched = (ctypes.c_int * len(flat))(*flat)
    # The device-memory route ping-pongs (key value, index or val) pairs
    # through scratch; the kernel zeroes its counters and look-back words.
    scratch = None
    if plan.cluster == 0:
        scratch = torch.empty((scratch_words(n, plan),), dtype=torch.int32,
                              device=val.device)
    two = len(keys) == 2
    kernels.launch(
        "sort", "piet_sort", keys[0].data_ptr(),
        keys[1].data_ptr() if two else None, val.data_ptr(),
        out_keys[0].data_ptr(), out_keys[1].data_ptr() if two else None,
        out_val.data_ptr(), n, bounds[0], bounds[1] if two else 0,
        len(plan.passes), sched, plan.cluster, plan.chunk,
        scratch.data_ptr() if scratch is not None else None)
    return out_keys, out_val


def stable_sort_pairs(key: torch.Tensor, val: torch.Tensor,
                      bound: Optional[int] = None):
    """Single-key wrapper around :func:`stable_sort_multi`: (sorted key,
    sorted val).  ``bound``: the key bound of the kernel (2^24 if None)."""
    (ks,), vs = stable_sort_multi(
        (key,), val, bounds=None if bound is None else (bound,))
    return ks, vs
