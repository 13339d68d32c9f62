"""Kernel A (candfuse) and the row gathers (gatherm) as the redesigned
kernels run them.

- The item rows: ``coarse.cand_inputs_plain`` (what a CPU tensor runs)
  against the JAX pass's glue (``piet_tpu/ops/coarse.py:297-346``, its
  own ``_item_tile_rect`` and cumsum) on adversarial items -- offscreen
  and negative bboxes, slabs with row0 > 0, tags 0 and items past
  ``n_items``, zero-area rects, NaN-pattern colours -- and
  ``csrc/candfuse.cu``'s ``cand_count`` and ``cand_prep`` schedule
  emulated on the CPU (512 items a block, one a thread, each block's sum
  of counts, each block adding up the sums before it, a block scan, rows
  as 16-byte words) against the plain version.
- The expansion: ``cand_expand``'s schedule emulated on the CPU (owner
  span per 128-slot block by the one-warp search, dead blocks, zero-count
  runs, rows as 16-byte words, the decode) against
  ``cand_records_fused_plain`` and JAX's ``cand_records_fused`` in
  interpret mode, on tests/_engine_cases.py's expansion cases.
- The gathers: ``gather_endpoints_plain`` and ``backdrop_from_csum_plain``
  against the JAX pass's expressions (``piet_tpu/ops/coarse.py:420-449``,
  both branches; ``:854-872``), with ``gather_monotone`` in interpret
  mode where the streams are monotone, and the kernels' per-slot logic
  emulated on the CPU.
- The coarse pass's taps: one call to each.

The kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import re

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.ops import coarse as jcoarse  # noqa: E402
from piet_tpu.ops.candfuse import cand_records_fused as jax_cand  # noqa: E402
from piet_tpu.ops.gatherm import gather_monotone as jax_gather  # noqa: E402
from piet_tpu.ops.gatherm import (  # noqa: E402
    gather_monotone_xla as jax_gather_xla)
from piet_tpu_torch import kernels  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.ops import candfuse, coarse, gatherm  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    device_scene_from_numpy, prepare_scene)
from piet_tpu_torch.scene import animate  # noqa: E402
from piet_tpu_torch.scene.scene import TAG_CLIP, TAG_FILL  # noqa: E402
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402
from _engine_cases import (CAND_SCENES, EXPAND_CASES,  # noqa: E402
                           adversarial_sitem, cand_scene_case,
                           synth_cand_pack, warp_search)


def _u32(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32) if x.dtype.itemsize == 4 else x


def _coarse_kw(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates)


# ---- the item rows --------------------------------------------------------

def _jax_cand_inputs(leaves, kw):
    """The JAX pass's item rows (piet_tpu/ops/coarse.py:297-346)."""
    f32 = jnp.float32
    ni = leaves.tags.shape[0]
    item_ids = jnp.arange(ni, dtype=jnp.int32)
    tags_in = jnp.asarray(leaves.tags)
    active = (item_ids < jnp.int32(leaves.n_items)) & (tags_in > 0)
    tags = jnp.where(active, tags_in, 0)
    bx0, by0, bx1, by1, bw, bh = jcoarse._item_tile_rect(
        jnp.asarray(leaves.bboxes), kw["tile_w"], kw["tile_h"],
        kw["tiles_x"], kw["tiles_y"], active, kw["row0"])
    counts = bw * bh
    excl, incl = jcoarse._exclusive_cumsum(counts)
    item_pack = jnp.stack([tags, jnp.asarray(leaves.n_pts),
                           jnp.asarray(leaves.pt_offset), excl,
                           bx0, by0, bx1, by1, bw], axis=1)
    cand_pack = jnp.concatenate(
        [jnp.asarray(leaves.colors_lin),
         jnp.asarray(leaves.bboxes).astype(f32),
         (f32(0.5) * jnp.asarray(leaves.widths))[:, None],
         jax.lax.bitcast_convert_type(jnp.asarray(leaves.colors_u32),
                                      f32)[:, None],
         jnp.asarray(leaves.flags).astype(f32)[:, None],
         jnp.asarray(leaves.clips),
         jax.lax.bitcast_convert_type(item_pack, f32),
         jax.lax.bitcast_convert_type(item_ids, f32)[:, None],
         jnp.asarray(leaves.grads)[:, :7]], axis=1)
    return cand_pack, counts, excl, incl[-1]


@pytest.mark.parametrize("case", [c for c in sorted(CAND_SCENES)
                                  if not CAND_SCENES[c][3]])
def test_cand_inputs_plain_matches_jax(case):
    """Every word of the item rows, the counts, offsets and total.  (The
    JAX scene holds flags as uint32 and converts them unsigned; the port
    holds their bits as int32 and converts them signed, as its plain glue
    does: the cases here keep the flags below 2^31.)"""
    leaves, kw = cand_scene_case(case)
    # XLA on the CPU flushes denormal products to zero (0.5 * a denormal
    # width); torch and the card keep them.  The rows hold the width's
    # half, so the JAX side sees the denormal widths as zero.
    tiny = np.abs(leaves.widths) < np.finfo(np.float32).tiny
    assert tiny.sum() > 2
    leaves.widths = np.where(tiny, np.float32(0.0), leaves.widths)
    dev = device_scene_from_numpy(leaves, "cpu")
    kernels.reset_launches()
    got = coarse.cand_inputs(dev, **kw)
    assert kernels.LAUNCHES["candfuse"] == 0            # the plain version
    want = _jax_cand_inputs(leaves, kw)
    np.testing.assert_array_equal(_u32(got.cand_pack.numpy()),
                                  _u32(want[0]))
    for name, g, w in zip(("counts", "excl"), got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got.total.shape == (1,)
    assert int(got.total[0]) == int(want[3])
    counts = got.counts.numpy()
    # The cases reach what they claim: dead and live items, zero areas.
    assert (counts == 0).sum() > 10 and (counts > 0).sum() > 10
    assert int(got.total[0]) > 0


def _floor_div_c(a, b):
    """csrc/candfuse.cu::floor_div: C's truncating division, fixed up."""
    q = np.abs(a) // b * np.sign(a)
    return np.where(a - q * b < 0, q - 1, q)


def _emulate_prep(leaves, kw):
    """csrc/candfuse.cu::cand_count and cand_prep on the CPU, block by
    block."""
    ni = leaves.tags.shape[0]
    n_items = int(leaves.n_items)
    tw, th, row0 = kw["tile_w"], kw["tile_h"], kw["row0"]
    bb = leaves.bboxes.astype(np.int64)
    tags = leaves.tags
    active = (np.arange(ni) < n_items) & (tags > 0)
    x0 = np.maximum(_floor_div_c(bb[:, 0], tw), 0)
    y0 = np.maximum(_floor_div_c(bb[:, 1], th), row0)
    x1 = np.minimum(_floor_div_c(bb[:, 2], tw), kw["tiles_x"] - 1)
    y1 = np.minimum(_floor_div_c(bb[:, 3], th), row0 + kw["tiles_y"] - 1)
    w = np.where(active, np.maximum(x1 - x0 + 1, 0), 0)
    h = np.where(active, np.maximum(y1 - y0 + 1, 0), 0)
    count = (w * h) & 0xFFFFFFFF
    block = candfuse.PREP_ITEMS
    pack = np.full((ni, 32), 0x5A5A5A5A, np.uint32)      # unwritten marker
    counts = np.full(ni, -7, np.int64)
    excl = np.full(ni, -7, np.int64)
    total = None
    bits = lambda a: np.ascontiguousarray(a).view(np.uint32)  # noqa: E731
    # cand_count: each block's sum of counts (only where there are two
    # blocks or more; a lone block reads none).
    sums = [int(count[i0:i0 + block].sum()) & 0xFFFFFFFF
            for i0 in range(0, ni, block)]
    for b, i0 in enumerate(range(0, ni, block)):
        # Thread t adds up sums[t], sums[t + 512], ... of the blocks before
        # this one, then the block scan adds the threads' partials.
        part = [sum(sums[t:b:block]) for t in range(min(block, b))]
        before = sum(part) & 0xFFFFFFFF
        n_here = min(block, ni - i0)
        own = count[i0:i0 + n_here]
        e = (before + np.cumsum(own) - own) & 0xFFFFFFFF
        counts[i0:i0 + n_here] = own
        excl[i0:i0 + n_here] = e
        if i0 + n_here == ni:
            total = (int(e[-1]) + int(own[-1])) & 0xFFFFFFFF
        it = np.arange(i0, i0 + n_here)
        ii = np.stack([np.where(active[it], tags[it], 0),
                       leaves.n_pts[it], leaves.pt_offset[it], e,
                       x0[it], y0[it], x1[it], y1[it], w[it]],
                      1).astype(np.int64) & 0xFFFFFFFF
        quads = [
            bits(leaves.colors_lin[it]),
            bits(leaves.bboxes[it].astype(np.float32)),
            np.stack([bits(np.float32(0.5) * leaves.widths[it]),
                      bits(leaves.colors_u32[it]),
                      bits(leaves.flags[it].view(np.int32).astype(
                          np.float32)),
                      bits(leaves.clips[it, 0])], 1),
            np.concatenate([bits(leaves.clips[it, 1:4]), ii[:, :1]], 1),
            ii[:, 1:5], ii[:, 5:9],
            np.concatenate([it[:, None], bits(leaves.grads[it, :3])], 1),
            bits(leaves.grads[it, 3:7])]
        # The block's rows, staged, leave as 16-byte words in order.
        flat = pack.reshape(-1, 4)
        for k in range(n_here * 8):
            li, q = divmod(k, 8)
            flat[(i0 * 8) + k] = quads[q][li]
    wrap = lambda a: a.astype(np.uint32).view(np.int32)  # noqa: E731
    return pack, wrap(counts), wrap(excl), np.uint32(total).view(np.int32)


@pytest.mark.parametrize("case", sorted(CAND_SCENES))
def test_cand_prep_schedule_equals_plain(case):
    leaves, kw = cand_scene_case(case)
    pack, counts, excl, total = _emulate_prep(leaves, kw)
    want = coarse.cand_inputs_plain(device_scene_from_numpy(leaves, "cpu"),
                                    **kw)
    np.testing.assert_array_equal(pack, _u32(want.cand_pack.numpy()))
    np.testing.assert_array_equal(counts, want.counts.numpy())
    np.testing.assert_array_equal(excl, want.excl.numpy())
    assert total == int(want.total[0])
    if case.endswith("5 prep blocks"):
        assert leaves.tags.shape[0] > 4 * candfuse.PREP_ITEMS


def test_candfuse_constants_match_the_source():
    src = (kernels.CSRC / "candfuse.cu").read_text()
    assert re.search(rf"constexpr int PREP_THREADS = {candfuse.PREP_ITEMS};",
                     src)
    assert re.search(rf"constexpr int BLOCK = {candfuse.BLOCK};", src)
    assert re.search(r"constexpr int W_CEXCL = %d, W_BX0 = %d, W_BY0 = %d, "
                     r"W_BW = %d;" % (candfuse.W_CEXCL, candfuse.W_BX0,
                                      candfuse.W_BY0, candfuse.W_BW), src)
    # The scene fields the wrappers hand over, in the C entries' order.
    params = src[src.index("#define PIET_SCENE_PARAMS"):]
    params = params[:re.search(r"#define PIET_SCENE\s", params).start()]
    names = [n for n, _, _ in candfuse.SCENE_FIELDS] + ["n_items"]
    assert re.findall(r"const void\* (\w+)", params) == names
    for entry in ("piet_cand_prep", "piet_cand_stage"):
        assert f'extern "C" int {entry}(PIET_SCENE_PARAMS, void* sums,' in src


def test_gatherm_constants_match_the_source():
    src = (kernels.CSRC / "gatherm.cu").read_text()
    assert re.search(r"constexpr int MAX_STREAMS = %d;"
                     % gatherm.MAX_STREAMS, src)
    assert re.search(r"constexpr int SITEM_WORDS = %d;"
                     % gatherm.SITEM_WORDS, src)
    assert re.search(r"constexpr int S_TAG = %d, S_NPTS = %d, S_PTOFF = %d, "
                     r"S_SEXCL = %d, S_FIRST = %d;" % (
                         gatherm.S_TAG, gatherm.S_NPTS, gatherm.S_PTOFF,
                         gatherm.S_SEXCL, gatherm.S_FIRST), src)
    assert re.search(r"constexpr int W_CEXCL = %d, W_BY0 = %d, W_BW = %d;"
                     % (gatherm.W_CEXCL, gatherm.W_BY0, gatherm.W_BW), src)
    assert re.search(r"constexpr int TAG_FILL = %d, TAG_CLIP = %d;"
                     % (TAG_FILL, TAG_CLIP), src)


# ---- the expansion --------------------------------------------------------

def _fdivmod_f32(local, w):
    q = np.floor(local.astype(np.float32) / w.astype(np.float32)).astype(
        np.int64)
    r = local - q * w
    q = q + (r >= w) - (r < 0)
    return q, local - q * w


def _emulate_cand_expand(pack, counts, excl, total, cap, tiles_x, row0):
    """csrc/candfuse.cu::cand_expand on the CPU, block by block."""
    ni = pack.shape[0]
    incl = excl.astype(np.int64) + counts
    pack4 = pack.reshape(ni * 8, 4)
    ca4 = np.full((cap * 8, 4), 0x5A5A5A5A, np.int64)
    tile, ty, tx = (np.full(cap, -7, np.int64) for _ in range(3))
    block = candfuse.BLOCK
    for p0 in range(0, cap, block):
        n_slot = min(block, cap - p0)
        p = p0 + np.arange(n_slot)
        if p0 >= total:                      # dead block: no search
            own = np.full(n_slot, -1)
        else:
            span0, _ = warp_search(incl, ni, p0)
            span1, _ = warp_search(incl, ni, min(p0 + n_slot, total) - 1)
            lo = np.full(n_slot, span0)
            hi = np.full(n_slot, span1)
            while (lo < hi).any():
                act = lo < hi
                mid = (lo + hi) >> 1
                go = incl[np.minimum(mid, ni - 1)] > p
                hi = np.where(act & go, mid, hi)
                lo = np.where(act & ~go, mid + 1, lo)
            own = np.where(p < total, np.minimum(lo, ni - 1), -1)
        for k in range(n_slot * 8):          # 8 threads a row, in order
            s, q = divmod(k, 8)
            ca4[p0 * 8 + k] = pack4[own[s] * 8 + q] if own[s] >= 0 else 0
        w = np.where(own[:, None] >= 0, pack[np.maximum(own, 0)], 0).astype(
            np.int64)
        dy, dx = _fdivmod_f32(p - w[:, candfuse.W_CEXCL],
                              np.maximum(w[:, candfuse.W_BW], 1))
        ty[p] = w[:, candfuse.W_BY0] + dy
        tx[p] = w[:, candfuse.W_BX0] + dx
        tile[p] = (ty[p] - row0) * tiles_x + tx[p]
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return i32(ca4.reshape(cap, 32)), i32(tile), i32(ty), i32(tx)


@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_cand_expand_schedule_equals_plain_and_jax(case):
    counts, cap = EXPAND_CASES[case]
    pack, excl = synth_cand_pack(counts, seed=cap)
    total = int(counts.sum())
    tiles_x, row0 = 6, 3
    got = _emulate_cand_expand(pack, counts, excl, total, cap, tiles_x, row0)
    t = [torch.from_numpy(a) for a in (pack, counts, excl)]
    want = candfuse.cand_records_fused_plain(
        *t, torch.tensor([total], dtype=torch.int32), row0, cap,
        tiles_x=tiles_x)
    np.testing.assert_array_equal(_u32(got[0]), _u32(want[0].numpy()))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w.numpy())
    if total < cap:
        assert not got[0][total:].any()              # dead rows zero
        assert (got[2][total:] == np.arange(total, cap)).all()
        assert not got[3][total:].any()
    jw = jax_cand(jax.lax.bitcast_convert_type(jnp.asarray(pack),
                                               jnp.float32),
                  jnp.asarray(counts), jnp.asarray(excl), jnp.int32(total),
                  row0, cap, tiles_x=tiles_x, interpret=True)
    np.testing.assert_array_equal(_u32(got[0]), _u32(jw[0]))
    live = min(total, cap)
    for name, g, w in zip(("tile", "ty", "tx"), got[1:], jw[1:]):
        np.testing.assert_array_equal(g[:live],
                                      np.asarray(w)[:live].astype(np.int32),
                                      err_msg=name)


# ---- the gathers ----------------------------------------------------------

def _jax_endpoints(sitem, points, n_segs, engine):
    """The JAX pass's endpoint fetch (piet_tpu/ops/coarse.py:408-449):
    the gatherm engine's branch, its streams through gather_monotone in
    interpret mode ("pallas") or its XLA reference ("xla"), or the other
    branch ("pairs": one gather of point pairs, which reads
    points[clip(i0) + 1] where the engine reads points[clip(i0 + 1)]: the
    same on every index a scene makes, i0 in [0, NP - 1))."""
    sitem_f = jax.lax.bitcast_convert_type(jnp.asarray(sitem), jnp.float32)
    pts = jnp.asarray(points)
    S = sitem.shape[0]
    np_max = pts.shape[0] - 1
    seg_idx = jnp.arange(S, dtype=jnp.int32)
    seg_valid = seg_idx < int(n_segs[0])
    s = jnp.asarray(sitem)
    seg_local = seg_idx - s[:, 10]
    i0 = s[:, 2] + seg_local
    s_is_fill_tag = (s[:, 0] == TAG_FILL) | (s[:, 0] == TAG_CLIP)
    wrap = s_is_fill_tag & (seg_local + 1 == s[:, 1])
    if engine != "pairs":
        i0_g = jnp.where(seg_valid, jnp.clip(i0, 0, np_max), np_max)
        j1_g = jnp.where(seg_valid, jnp.clip(i0 + 1, 0, np_max), np_max)
        if engine == "pallas":
            p0e, p1n = jax_gather(pts, (i0_g, j1_g), interpret=True)
        else:
            p0e, p1n = jax_gather_xla(pts, (i0_g, j1_g))
        p1e = jnp.where(wrap[:, None], sitem_f[:, 12:14], p1n)
    else:
        nxt = jnp.concatenate([pts[1:], pts[-1:]], axis=0)
        pair_rows = jnp.concatenate([pts, nxt], axis=1)
        pr = pair_rows[jnp.clip(i0, 0, np_max)]
        p0e = pr[:, 0:2]
        p1e = jnp.where(wrap[:, None], sitem_f[:, 12:14], pr[:, 2:4])
    return (jnp.where(seg_valid[:, None], p0e, 0.0),
            jnp.where(seg_valid[:, None], p1e, 0.0))


def _emulate_endpoints(sitem, points, n_segs):
    """csrc/gatherm.cu::gather_endpoints on the CPU, slot by slot."""
    S, n = sitem.shape[0], points.shape[0]
    pb = points.view(np.int32)
    p0 = np.full((S, 2), 0x5A5A5A5A, np.int32)
    p1 = p0.copy()
    for p in range(S):
        if p >= int(n_segs[0]):
            p0[p] = p1[p] = 0
            continue
        row = sitem[p].astype(np.int64)
        local = p - row[10]
        i0 = row[2] + local
        p0[p] = pb[min(max(i0, 0), n - 1)]
        if row[0] in (TAG_FILL, TAG_CLIP) and local + 1 == row[1]:
            p1[p] = sitem[p, 12:14]
        else:
            p1[p] = pb[min(max(i0 + 1, 0), n - 1)]
    return p0.view(np.float32), p1.view(np.float32)


def _derived_taps(name):
    """The coarse pass's taps on the device-animation path (segments
    derived by expand and gatherm): the tiger at 256^2 or the animated
    fixture's frame at t = 0.7."""
    if name == "tiger":
        scene = make_tiger(scale=0.5)
        cfg = fit_capacities(scene, RenderConfig(width=256, height=256))
        dev = prepare_scene(scene, cfg, "cpu", seg_pre=False)
    else:
        tmpl = animate.template_scene(size=256, n=24, seed=5)
        cfg = fit_capacities(tmpl, RenderConfig(
            width=256, height=256, tile_height=16, tile_width=128),
            bucket=True)
        base = prepare_scene(tmpl, cfg, "cpu", seg_pre=False)
        params = animate.host_params(size=256, n=24, seed=5, device="cpu")
        dev = animate.animate_device_scene(base, params, 0.7)
    taps = {}
    coarse.coarse_rasterize(dev, taps=taps, **_coarse_kw(cfg))
    return taps


def _endpoint_case(case):
    if case.startswith("adversarial"):
        sitem, pts, n_segs = adversarial_sitem(seed=int(case[-1]))
        return sitem, pts, n_segs, False
    (name, (sitem, points, n_segs)), _ = _derived_taps(case)["gatherm"]
    assert name == "endpoints"
    return sitem.numpy(), points.numpy(), n_segs.numpy(), True


@pytest.mark.parametrize("case", ["tiger", "animated", "adversarial 1",
                                  "adversarial 2"])
def test_gather_endpoints_plain_matches_jax(case):
    sitem, pts, n_segs, monotone = _endpoint_case(case)
    got = gatherm.gather_endpoints_plain(torch.from_numpy(sitem),
                                         torch.from_numpy(pts),
                                         torch.from_numpy(n_segs))
    # The adversarial rows index before and past the point table and are
    # not monotone: there the engine's XLA reference alone applies.
    engines = ("xla", "pallas", "pairs") if monotone else ("xla",)
    for engine in engines:
        want = _jax_endpoints(sitem, pts, n_segs, engine)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u32(g.numpy()), _u32(w),
                                          err_msg=f"engine={engine}")
    emu = _emulate_endpoints(sitem, pts, n_segs)
    for g, e in zip(got, emu):
        np.testing.assert_array_equal(_u32(g.numpy()), _u32(e))
    # Dead slots are +0.0, and the wrap-around was taken.
    n = int(n_segs[0])
    assert not _u32(got[0].numpy())[n:].any()
    assert not _u32(got[1].numpy())[n:].any()
    local = np.arange(len(sitem)) - sitem[:, 10]
    wrap = (np.isin(sitem[:, 0], (TAG_FILL, TAG_CLIP))
            & (local + 1 == sitem[:, 1]))
    assert wrap[:n].any()


def _jax_backdrop(csum, ca, cand_ty, engine):
    """The JAX pass's backdrop (piet_tpu/ops/coarse.py:854-872)."""
    csum = jnp.asarray(csum)
    ci = jnp.asarray(ca)[:, 15:24]
    cap = csum.shape[0]
    crs = ci[:, 3] + (jnp.asarray(cand_ty) - ci[:, 5]) * jnp.maximum(
        ci[:, 8], 1)
    if engine:
        sb_idx = jnp.clip(crs - 1, 0, cap - 1)
        (sb,) = jax_gather(csum[:, None], (sb_idx,), interpret=True)
        start_base = jnp.where(crs > 0, sb[:, 0], 0.0)
    else:
        start_base = jnp.where(crs > 0, csum[crs - 1], 0.0)
    return csum - start_base


def _emulate_backdrop(csum, ca, cand_ty):
    """csrc/gatherm.cu::backdrop on the CPU, slot by slot (f32)."""
    cap = csum.shape[0]
    out = np.empty(cap, np.float32)
    for p in range(cap):
        row = ca[p].astype(np.int64)
        crs = np.int64(row[18] + (int(cand_ty[p]) - row[20])
                       * max(row[23], 1)).astype(np.int32)
        base = (csum[min(max(int(crs) - 1, 0), cap - 1)] if crs > 0
                else np.float32(0.0))
        out[p] = csum[p] - base
    return out


def _backdrop_case(case):
    if case == "synthetic":
        counts, cap = EXPAND_CASES["owners_of_many_blocks"]
        pack, excl = synth_cand_pack(counts, seed=9)
        t = [torch.from_numpy(a) for a in (pack, counts, excl)]
        total = torch.tensor([int(counts.sum())], dtype=torch.int32)
        ca, _, ty, _ = candfuse.cand_records_fused_plain(
            *t, total, 0, cap, tiles_x=6)
        rng = np.random.default_rng(2)
        csum = rng.integers(-4, 5, cap).astype(np.float32)
        csum[::17] = -0.0
        csum[3::29] = np.float32(1e-45)
        return csum, ca.view(torch.int32).numpy(), ty.numpy()
    (name, (csum, ca, ty)), = [c for c in _derived_taps(case)["gatherm"]
                                if c[0] == "backdrop"]
    assert name == "backdrop"
    return csum.numpy(), ca.numpy(), ty.numpy()


@pytest.mark.parametrize("case", ["tiger", "animated", "synthetic"])
def test_backdrop_from_csum_plain_matches_jax(case):
    csum, ca, ty = _backdrop_case(case)
    got = gatherm.backdrop_from_csum_plain(
        torch.from_numpy(csum), torch.from_numpy(ca), torch.from_numpy(ty))
    np.testing.assert_array_equal(_u32(got.numpy()),
                                  _u32(_emulate_backdrop(csum, ca, ty)))
    # XLA on the CPU flushes denormal differences to zero; torch and the
    # card keep them.  Against JAX, both sides take the denormal running
    # sums (the synthetic case's) as zero.
    tiny = np.abs(csum) < np.finfo(np.float32).tiny
    csum = np.where(tiny, csum * 0, csum)
    got = gatherm.backdrop_from_csum_plain(
        torch.from_numpy(csum), torch.from_numpy(ca), torch.from_numpy(ty))
    for engine in (False, True):
        want = _jax_backdrop(csum, ca, ty, engine)
        np.testing.assert_array_equal(_u32(got.numpy()), _u32(want),
                                      err_msg=f"engine={engine}")
    # The float view of the rows gives the same bits.
    same = gatherm.backdrop_from_csum_plain(
        torch.from_numpy(csum), torch.from_numpy(ca).view(torch.float32),
        torch.from_numpy(ty))
    assert torch.equal(same.view(torch.int32), got.view(torch.int32))


# ---- the coarse pass's calls ----------------------------------------------

@pytest.mark.parametrize("seg_pre", [True, False])
def test_coarse_taps_one_call_to_each(seg_pre):
    """One kernel A call (item rows and expansion) and one gatherm call per
    site: the backdrop on every frame, the endpoints where segments are
    derived on the device.  Each tap's arguments give back what the pass
    used."""
    scene = make_tiger(scale=0.5)
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256))
    dev = prepare_scene(scene, cfg, "cpu", seg_pre=seg_pre)
    taps = {}
    coarse.coarse_rasterize(dev, taps=taps, **_coarse_kw(cfg))
    sites = [name for name, _ in taps["gatherm"]]
    assert sites == (["backdrop"] if seg_pre else ["endpoints",
                                                   "backdrop"])
    scene_in, rect_kw = taps["cand_inputs"]
    ci, akw = taps["candfuse"]
    again = coarse.cand_inputs(scene_in, **rect_kw)
    for g, w in zip(again, ci):
        assert torch.equal(g, w)
    stage = coarse.cand_stage(scene_in, cap=akw["cap"], **rect_kw)
    plain = candfuse.cand_records_fused(*ci, **akw)
    for g, w in zip(stage[1:], plain[:3]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    for name, args in taps["gatherm"]:
        call, plain_call, streams = gatherm.SITES[name]
        got = call(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = plain_call(*args)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        rows, idxs = streams(*args)
        assert len(gatherm.gather_monotone(rows, idxs)) == len(idxs)
