"""The port's stable sort (piet_tpu_torch/ops/sort.py) against the JAX
package's ``stable_sort_multi``, bitwise: keys with duplicates and +inf
(dead records), sizes that are not a power of two, one and two keys."""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.ops.sort import stable_sort_multi as jax_sort  # noqa: E402
from piet_tpu_torch.ops.sort import (MIN_SORT, _next_pow2,  # noqa: E402
                                     stable_sort_multi)


def _keys(n, n_keys, seed):
    rng = np.random.default_rng(seed)
    keys = []
    for _ in range(n_keys):
        k = rng.integers(0, max(n // 8, 2), n).astype(np.float32)
        k[rng.uniform(size=n) < 0.2] = np.inf       # dead records
        keys.append(k)
    return keys


@pytest.mark.parametrize("impl", ["xla", "jnp"])
@pytest.mark.parametrize("n,n_keys", [(1000, 1), (777, 1), (1500, 2),
                                      (4096, 1)])
def test_plain_sort_matches_jax(impl, n, n_keys):
    keys = _keys(n, n_keys, seed=n + n_keys)
    val = np.arange(n, dtype=np.int32)
    jk, jv = jax_sort(tuple(jnp.asarray(k) for k in keys),
                      jnp.asarray(val), impl=impl)
    tk, tv = stable_sort_multi(tuple(torch.from_numpy(k) for k in keys),
                               torch.from_numpy(val))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))


def _bitonic_emulation(key, val):
    """The stage schedule of csrc/sort.cu on the CPU: pad to a power of two
    of at least MIN_SORT with (+inf, n, n+1, ...), then for every merge
    size k the partner distances j = k/2 .. 1, compare-exchanging (key, idx)
    lexicographically (ascending where i & k == 0).  The kernel runs the
    j < MIN_SORT stages in shared memory and the rest as global passes --
    the same stages in the same order."""
    n = key.shape[0]
    np2 = max(_next_pow2(n), MIN_SORT)
    k_buf = torch.full((np2,), float("inf"))
    v_buf = torch.arange(np2, dtype=torch.int32)
    k_buf[:n], v_buf[:n] = key, val
    i = torch.arange(np2)
    k = 2
    while k <= np2:
        j = k // 2
        while j >= 1:
            lo = i[(i & j) == 0]
            hi = lo + j
            asc = (lo & k) == 0
            ka, kb, va, vb = k_buf[lo], k_buf[hi], v_buf[lo], v_buf[hi]
            b_lt_a = (kb < ka) | ((kb == ka) & (vb < va))
            a_lt_b = (ka < kb) | ((ka == kb) & (va < vb))
            swap = torch.where(asc, b_lt_a, a_lt_b)
            k_buf[lo] = torch.where(swap, kb, ka)
            k_buf[hi] = torch.where(swap, ka, kb)
            v_buf[lo] = torch.where(swap, vb, va)
            v_buf[hi] = torch.where(swap, va, vb)
            j //= 2
        k *= 2
    return k_buf[:n], v_buf[:n]


@pytest.mark.parametrize("n", [100, 2048, 5000])
def test_bitonic_schedule_equals_stable_sort(n):
    (key,) = _keys(n, 1, seed=n)
    key = torch.from_numpy(key)
    val = torch.arange(n, dtype=torch.int32)
    gk, gv = _bitonic_emulation(key, val)
    (wk,), wv = stable_sort_multi((key,), val)
    np.testing.assert_array_equal(gv.numpy(), wv.numpy())
    np.testing.assert_array_equal(gk.numpy().view(np.uint32),
                                  wk.numpy().view(np.uint32))
