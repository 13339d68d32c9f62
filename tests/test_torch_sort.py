"""The port's stable sort (piet_tpu_torch/ops/sort.py) against the JAX
package's ``stable_sort_multi``, bitwise: keys with duplicates and +inf
(dead records), sizes that are not a power of two, one and two keys.  And
the radix kernel's schedule (csrc/sort.cu) emulated on the CPU against the
plain version."""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.ops.sort import stable_sort_multi as jax_sort  # noqa: E402
from piet_tpu_torch.ops.sort import (CLUSTER, CLUSTER_CHUNK,  # noqa: E402
                                     GLOBAL_TILE, RADIX_BITS, WARPS,
                                     SortPlan, radix_passes, sort_plan,
                                     stable_sort_multi,
                                     stable_sort_multi_plain)


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


def _radix_emulation(keys, val, bounds, plan):
    """The schedule of csrc/sort.cu on the CPU.  Each pair is (the integer
    value of the pass's key, +inf taken as the key's bound; its record
    index).  Block b holds positions [b * chunk, (b + 1) * chunk); warp w
    of a block a contiguous run of ceil(m / WARPS) of its m pairs.  A pass
    places a pair at: the count of all smaller digits, plus the same digit
    in earlier (block, warp) runs, plus its rank among equal digits of its
    own run -- what the per-warp counts, the cross-block totals and the
    ballots of the kernel compute.  Where the next pass reads the other
    key, the moved pair takes that key's value by index."""
    n = val.shape[0]
    ints = [torch.where(k == float("inf"), int(b), k.to(torch.int64))
            for k, b in zip(keys, bounds)]
    pos_ = torch.arange(n)
    block = pos_ // plan.chunk
    local = pos_ - block * plan.chunk
    m = torch.clamp(n - block * plan.chunk, max=plan.chunk)
    per = (m + WARPS - 1) // WARPS
    run = block * WARPS + local // per                  # (block, warp) id
    n_runs = int(run.max()) + 1
    bins = 1 << RADIX_BITS
    cur_k = ints[plan.passes[0][0]].clone()
    cur_i = torch.arange(n)
    for p, (sel, shift, bits) in enumerate(plan.passes):
        d = (cur_k >> shift) & ((1 << bits) - 1)
        cnt = torch.zeros((n_runs, bins), dtype=torch.int64)
        cnt.index_put_((run, d), torch.ones(n, dtype=torch.int64),
                       accumulate=True)
        before_runs = torch.cumsum(cnt, 0) - cnt         # earlier runs
        tot = cnt.sum(0)
        digit_base = torch.cumsum(tot, 0) - tot          # smaller digits
        # Rank among equal digits of the own run, in element order.
        grp = run * bins + d
        order = torch.sort(grp, stable=True).indices
        first = torch.ones(n, dtype=torch.bool)
        first[1:] = grp[order][1:] != grp[order][:-1]
        start = torch.cummax(torch.where(first, torch.arange(n), 0),
                             0).values
        rank = torch.empty(n, dtype=torch.int64)
        rank[order] = torch.arange(n) - start
        dest = digit_base[d] + before_runs[run, d] + rank
        assert torch.equal(torch.sort(dest).values, torch.arange(n))
        nxt_k = torch.empty_like(cur_k)
        nxt_i = torch.empty_like(cur_i)
        nxt_i[dest] = cur_i
        last = p + 1 == len(plan.passes)
        reload = not last and plan.passes[p + 1][0] != sel
        nxt_k[dest] = ints[plan.passes[p + 1][0]][cur_i] if reload else cur_k
        cur_k, cur_i = nxt_k, nxt_i
    return tuple(k[cur_i] for k in keys), val[cur_i]


def test_radix_passes_split_each_key():
    assert radix_passes((412_360,)) == ((0, 0, 7), (0, 7, 6), (0, 13, 6))
    assert radix_passes((2 ** 24,)) == ((0, 0, 7), (0, 7, 6), (0, 13, 6),
                                        (0, 19, 6))
    assert radix_passes((4096, 4098)) == ((1, 0, 7), (1, 7, 6), (0, 0, 7),
                                          (0, 7, 6))
    assert sort_plan(67_584, (412_360,))[1:] == (16, 4224)
    assert sort_plan(CLUSTER * CLUSTER_CHUNK, (2 ** 24,))[1:] == (
        16, CLUSTER_CHUNK)
    assert sort_plan(CLUSTER * CLUSTER_CHUNK + 1, (2 ** 24,))[1:] == (
        0, GLOBAL_TILE)


@pytest.mark.parametrize("n,n_keys,val_kind,chunk", [
    (1000, 1, "arange", None),
    (777, 2, "arange", None),
    (5000, 1, "reversed", None),
    (3001, 2, "random", 512),
    (20000, 1, "arange", GLOBAL_TILE),
])
def test_radix_schedule_equals_stable_sort(n, n_keys, val_kind, chunk):
    """Dead +inf records, sizes that are not a power of two, one and two
    keys, a val that is not increasing; the cluster route as
    :func:`sort_plan` splits the pairs over its blocks (chunk None), and
    the device-memory route in blocks of ``chunk`` pairs."""
    keys = tuple(torch.from_numpy(k) for k in _keys(n, n_keys, seed=n))
    rng = np.random.default_rng(n + 7)
    val = {"arange": torch.arange(n, dtype=torch.int32),
           "reversed": torch.arange(n, 0, -1, dtype=torch.int32),
           "random": torch.from_numpy(rng.integers(
               -2 ** 31, 2 ** 31, n).astype(np.int32))}[val_kind]
    bounds = (max(n // 8, 2),) * n_keys
    if chunk is None:
        plan = sort_plan(n, bounds)
        assert plan.cluster == CLUSTER
    else:
        plan = SortPlan(radix_passes(bounds), 0, chunk)
    gk, gv = _radix_emulation(keys, val, bounds, plan)
    wk, wv = stable_sort_multi_plain(keys, val)
    np.testing.assert_array_equal(gv.numpy(), wv.numpy())
    for a, b in zip(gk, wk):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      b.numpy().view(np.uint32))
