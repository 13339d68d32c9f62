"""The port's stable sort (piet_tpu_torch/ops/sort.py) against the JAX
package's ``stable_sort_multi``, bitwise: keys with duplicates and +inf
(dead records), sizes that are not a power of two, one and two keys.  And
the radix kernel's schedule (csrc/sort.cu) emulated on the CPU against the
plain version and JAX's sort: the cluster route, and the device-memory
route (upsweep histograms, tiles, look-back prefixes), on synthetic keys
and on beziers_10k's own."""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.ops.sort import stable_sort_multi as jax_sort  # noqa: E402
from piet_tpu_torch.ops import coarse  # noqa: E402
from piet_tpu_torch.ops.sort import (CLUSTER, CLUSTER_CHUNK,  # noqa: E402
                                     PASS_ITEMS, PASS_TILE, RADIX_BITS,
                                     WARPS, SortPlan, radix_passes,
                                     scratch_words, sort_plan,
                                     stable_sort_multi,
                                     stable_sort_multi_plain)
from piet_tpu_torch.renderer.renderer import Renderer  # noqa: E402
from piet_tpu_torch.scene import fixtures  # noqa: E402


def _keys(n, n_keys, seed, bound=None):
    rng = np.random.default_rng(seed)
    keys = []
    for _ in range(n_keys):
        k = rng.integers(0, bound or max(n // 8, 2), n).astype(np.float32)
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


def _key_ints(keys, bounds):
    """Each key's integer value, +inf taken as the key's bound."""
    return [torch.where(k == float("inf"), int(b), k.to(torch.int64))
            for k, b in zip(keys, bounds)]


def _rank_in_run(run, d, n):
    """Each pair's rank among the pairs of its run with its digit, in
    element order (what a warp's ballots over its batches compute)."""
    grp = run * (1 << RADIX_BITS) + d
    order = torch.sort(grp, stable=True).indices
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = grp[order][1:] != grp[order][:-1]
    start = torch.cummax(torch.where(first, torch.arange(n), 0), 0).values
    rank = torch.empty(n, dtype=torch.int64)
    rank[order] = torch.arange(n) - start
    return rank


def _run_passes(keys, val, bounds, plan, place):
    """The digit passes: ``place(p, d)`` gives each pair's destination from
    its digit; where the next pass reads the other key, the moved pair
    takes that key's value by index; the last pass gathers the outputs."""
    n = val.shape[0]
    ints = _key_ints(keys, bounds)
    cur_k = ints[plan.passes[0][0]].clone()
    cur_i = torch.arange(n)
    for p, (sel, shift, bits) in enumerate(plan.passes):
        dest = place(p, (cur_k >> shift) & ((1 << bits) - 1))
        assert torch.equal(torch.sort(dest).values, torch.arange(n))
        nxt_k = torch.empty_like(cur_k)
        nxt_i = torch.empty_like(cur_i)
        nxt_i[dest] = cur_i
        last = p + 1 == len(plan.passes)
        reload = not last and plan.passes[p + 1][0] != sel
        nxt_k[dest] = ints[plan.passes[p + 1][0]][cur_i] if reload else cur_k
        cur_k, cur_i = nxt_k, nxt_i
    return tuple(k[cur_i] for k in keys), val[cur_i]


def _radix_emulation(keys, val, bounds, plan):
    """The cluster route of csrc/sort.cu on the CPU.  Each pair is (the
    integer value of the pass's key; its record index).  Block b holds
    positions [b * chunk, (b + 1) * chunk); warp w of a block a contiguous
    run of ceil(m / WARPS) of its m pairs.  A pass places a pair at: the
    count of all smaller digits, plus the same digit in earlier (block,
    warp) runs, plus its rank among equal digits of its own run -- what
    the per-warp counts, the cross-block totals and the ballots of the
    kernel compute."""
    n = val.shape[0]
    pos_ = torch.arange(n)
    block = pos_ // plan.chunk
    local = pos_ - block * plan.chunk
    m = torch.clamp(n - block * plan.chunk, max=plan.chunk)
    per = (m + WARPS - 1) // WARPS
    run = block * WARPS + local // per                  # (block, warp) id
    n_runs = int(run.max()) + 1
    bins = 1 << RADIX_BITS

    def place(p, d):
        cnt = torch.zeros((n_runs, bins), dtype=torch.int64)
        cnt.index_put_((run, d), torch.ones(n, dtype=torch.int64),
                       accumulate=True)
        before_runs = torch.cumsum(cnt, 0) - cnt         # earlier runs
        tot = cnt.sum(0)
        digit_base = torch.cumsum(tot, 0) - tot          # smaller digits
        return digit_base[d] + before_runs[run, d] + _rank_in_run(run, d, n)

    return _run_passes(keys, val, bounds, plan, place)


def _onesweep_emulation(keys, val, bounds, plan):
    """The device-memory route of csrc/sort.cu on the CPU, in tiles of
    ``plan.chunk`` pairs.  The upsweep's histogram of every pass, counted
    on the input keys, gives each digit's exclusive global start.  In a
    pass, warp w of a tile ranks the tile's pairs [32 w PASS_ITEMS,
    32 (w + 1) PASS_ITEMS) in element order; a pair is staged in the tile
    at the tile's start of its digit (smaller digits of the tile) plus the
    digit's count in the tile's earlier warps plus its rank in its warp,
    and staged pair i of digit d leaves for the digit's global start plus
    the look-back prefix (the digit's count in all earlier tiles) plus
    i minus the tile's start of d."""
    n = val.shape[0]
    bins = 1 << RADIX_BITS
    ints = _key_ints(keys, bounds)
    digit_start = []
    for sel, shift, bits in plan.passes:
        h = torch.bincount((ints[sel] >> shift) & ((1 << bits) - 1),
                           minlength=bins)
        digit_start.append(torch.cumsum(h, 0) - h)
    pos_ = torch.arange(n)
    part = pos_ // plan.chunk
    local = pos_ - part * plan.chunk
    n_tiles = int(part[-1]) + 1
    warps = -(-plan.chunk // (32 * PASS_ITEMS))
    warp = local // (32 * PASS_ITEMS)

    def place(p, d):
        cnt = torch.zeros((n_tiles, warps, bins), dtype=torch.int64)
        cnt.index_put_((part, warp, d), torch.ones(n, dtype=torch.int64),
                       accumulate=True)
        warp_before = torch.cumsum(cnt, 1) - cnt         # earlier warps
        tile_cnt = cnt.sum(1)                            # published counts
        assert int(tile_cnt.sum(0).max()) < 2 ** 30      # a status word
        tile_start = torch.cumsum(tile_cnt, 1) - tile_cnt
        look_back = torch.cumsum(tile_cnt, 0) - tile_cnt  # earlier tiles
        staged = (tile_start[part, d] + warp_before[part, warp, d]
                  + _rank_in_run(part * warps + warp, d, n))
        m = torch.clamp(n - part * plan.chunk, max=plan.chunk)
        assert torch.equal(torch.sort(staged + part * plan.chunk).values,
                           pos_) and bool((staged < m).all())
        return (digit_start[p][d] + look_back[part, d]
                - tile_start[part, d] + staged)

    return _run_passes(keys, val, bounds, plan, place)


def _hold(got, keys, val):
    """``got`` bitwise against the plain version and JAX's sort."""
    gk, gv = got
    wk, wv = stable_sort_multi_plain(keys, val)
    jk, jv = jax_sort(tuple(jnp.asarray(k.numpy()) for k in keys),
                      jnp.asarray(val.numpy()), impl="xla")
    for want_k, want_v in ((wk, wv.numpy()), (jk, np.asarray(jv))):
        np.testing.assert_array_equal(gv.numpy(), want_v)
        for a, b in zip(gk, want_k):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b).view(np.uint32))


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
        0, PASS_TILE)
    # beziers_10k at 1024^2: E = 261,504 (fitted) or 368,640 (bucketed),
    # 23-bit keys: three passes of 8, 8 and 7 bits, in 1,792-pair tiles,
    # more tiles than the H100's 132 SMs.
    for n, bound in ((261_504, 5_177_856), (368_640, 7_340_544)):
        plan = sort_plan(n, (bound,))
        assert plan == SortPlan(((0, 0, 8), (0, 8, 8), (0, 16, 7)), 0,
                                PASS_TILE)
        assert -(-n // plan.chunk) >= 132
    assert scratch_words(261_504, sort_plan(261_504, (5_177_856,))) == (
        4 * 261_504 + 16 + 3 * 256 * (1 + 146))


@pytest.mark.parametrize("n,n_keys,val_kind,chunk", [
    (1000, 1, "arange", None),
    (777, 2, "arange", None),
    (5000, 1, "reversed", None),
    (3001, 2, "random", 512),
    (20000, 1, "arange", PASS_TILE),
    (196_609, 1, "reversed", PASS_TILE),
    (196_609, 2, "random", PASS_TILE),
    (261_504, 1, "random", PASS_TILE),
    (261_504, 2, "reversed", PASS_TILE),
])
def test_radix_schedule_equals_stable_sort(n, n_keys, val_kind, chunk):
    """Dead +inf records, sizes that are not a power of two, one and two
    keys, a val that is not increasing; the cluster route as
    :func:`sort_plan` splits the pairs over its blocks (chunk None), and
    the device-memory route in tiles of ``chunk`` pairs (the kernel's
    PASS_TILE from 20,000 pairs up, beziers_10k's 261,504 among them, with
    its 23-bit keys)."""
    bound = 7_340_544 if n > CLUSTER * CLUSTER_CHUNK and n_keys == 1 \
        else max(n // 8, 2)
    keys = tuple(torch.from_numpy(k) for k in _keys(n, n_keys, seed=n,
                                                     bound=bound))
    rng = np.random.default_rng(n + 7)
    val = {"arange": torch.arange(n, dtype=torch.int32),
           "reversed": torch.arange(n, 0, -1, dtype=torch.int32),
           "random": torch.from_numpy(rng.integers(
               -2 ** 31, 2 ** 31, n).astype(np.int32))}[val_kind]
    bounds = (bound,) * n_keys
    if chunk is None:
        plan = sort_plan(n, bounds)
        assert plan.cluster == CLUSTER
        got = _radix_emulation(keys, val, bounds, plan)
    else:
        plan = SortPlan(radix_passes(bounds), 0, chunk)
        if n > CLUSTER * CLUSTER_CHUNK:
            assert plan == sort_plan(n, bounds)
        got = _onesweep_emulation(keys, val, bounds, plan)
    _hold(got, keys, val)


@pytest.mark.parametrize("bucket", [False, True])
def test_radix_schedule_on_beziers_keys(bucket):
    """The device-memory route's schedule on the keys beziers_10k's coarse
    pass sorts at 1024^2 (E = 261,504 fitted, 368,640 bucketed)."""
    scene = fixtures.get_scene("beziers_10k")
    r = Renderer.for_scene(scene, 1024, 1024, device="cpu", bucket=bucket)
    cfg = r.config
    taps = {}
    coarse.coarse_rasterize(
        r.prepare(scene), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        max_segments=cfg.max_segments, max_hits=cfg.max_hits,
        max_candidates=cfg.max_candidates, taps=taps)
    keys, val, bounds = taps["sort"]
    assert val.shape[0] == (368_640 if bucket else 261_504)
    plan = sort_plan(val.shape[0], bounds)
    assert plan.cluster == 0 and len(plan.passes) == 3
    _hold(_onesweep_emulation(keys, val, bounds, plan), keys, val)


@pytest.mark.parametrize("n,hi", [(300, 1000), (4096, 17)])
def test_stable_sort_pairs_matches_jax(n, hi):
    """The one-key wrapper against JAX's ``stable_sort_pairs``: f32 keys
    with heavy duplication and dead (+inf) keys."""
    from piet_tpu.ops.sort import stable_sort_pairs as jax_pairs
    from piet_tpu_torch.ops.sort import stable_sort_pairs
    rng = np.random.default_rng(n)
    key = rng.integers(0, hi, n).astype(np.float32)
    key[rng.random(n) < 0.1] = np.inf
    val = rng.permutation(n).astype(np.int32)
    wk, wv = jax_pairs(jnp.asarray(key), jnp.asarray(val), impl="xla")
    gk, gv = stable_sort_pairs(torch.from_numpy(key), torch.from_numpy(val),
                               bound=hi)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
