"""The coarse pass's dense tail: ``ops/dense_tail.py::dense_tail`` (the
kernel ``csrc/dense_tail.cu``) against its plain version
``ops/dense_tail.py::dense_tail_plain``.

On the CPU, the facts the kernel rests on, on the configurations of
tests/test_coarse.py (:data:`COARSE_CASES`), the overflow case of
tests/test_torch_dense.py and a bailing and a mostly empty scene: the
sorted records' tiles are non-decreasing with the dead records last at
``n_tiles``; each tile's run of records, found by integer searches, gives
the plain version's f32 maxima (first, last, last opaque, last clearing
record); and :func:`kernel_model`, the kernel's algorithm in numpy (a scan
of the command counts from each tile's first kept record), places each
tile's commands at unique positions, exactly ``[0, counts)`` of them kept,
and gives the plain version's PTCL word for word.  The CPU pass launches
no kernel.

On the card (``cuda``): the kernel against the plain version word for
word on those scenes, the group scenes of tests/test_torch_dense.py (two
also with the segment stage derived on the card) and the benchmark's
three scenes at their fitted capacities; one launch a dense pass and none
on the entries route; a captured dense frame's ``tile_reduce`` stage at
most 12 device nodes.

No JAX here: on the card,
``python -m pytest --noconftest tests/test_torch_dense_tail.py -q``.
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

from piet_tpu_torch import tracing  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.layout.entry_stream import (  # noqa: E402
    META_CLEAR_BIT, META_NCMDS_MASK, META_OPAQUE_BIT, N_S0_ARGS, N_S1_ARGS,
    W_META, W_S0_ARG, W_S0_TAG, W_S1_ARG, W_S1_TAG)
from piet_tpu_torch.ops import coarse, dense_tail  # noqa: E402
from piet_tpu_torch.raster.ptcl import ARG_WORDS, CMD_FILL  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    make_render_fn, prepare_scene)
from piet_tpu_torch.scene import affine, fixtures  # noqa: E402
from piet_tpu_torch.scene.scene import SceneBuilder  # noqa: E402
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

#: tests/test_coarse.py's CASES with the port's scene makers (that file
#: imports the JAX package); tests/test_torch_dense_coarse.py holds the two
#: lists equal.
COARSE_CASES = [
    ("path_test", fixtures.make_path_test,
     dict(width=320, height=832, tile_height=16, tile_width=16,
          cmd_capacity=128, max_items=64, max_points=1024, max_segments=1024,
          max_hits=1 << 14, max_candidates=1 << 12, max_deltas=1 << 12)),
    ("cardioid", lambda: fixtures.make_cardioid(center=(256.0, 256.0),
                                                r=200.0),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=128, max_items=256, max_points=1024, max_segments=1024,
          max_hits=1 << 17, max_candidates=1 << 14, max_deltas=1 << 12)),
    ("circles_rects", lambda: fixtures.make_circles_rects(80, 80, size=512),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=256, max_items=256, max_points=1 << 13,
          max_segments=1 << 13, max_hits=1 << 16, max_candidates=1 << 14,
          max_deltas=1 << 13)),
    ("animated", lambda: fixtures.make_animated_frame(0.3, size=512, n=60),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=256, max_items=256, max_points=1024,
          max_segments=1024, max_hits=1 << 14, max_candidates=1 << 13,
          max_deltas=1 << 12)),
    ("tiger_1x", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=16,
          cmd_capacity=768, max_items=512, max_points=1 << 15,
          max_segments=1 << 15, max_hits=1 << 17, max_candidates=1 << 15,
          max_deltas=1 << 15)),
    ("tiger_1x_tpu_tiles", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=128,
          cmd_capacity=2688, max_items=512, max_points=1 << 15,
          max_segments=1 << 15, max_hits=1 << 17, max_candidates=1 << 14,
          max_deltas=1 << 15)),
    ("tiger_1x_tall_tiles", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=32, tile_width=128,
          cmd_capacity=4096, max_items=512, max_points=1 << 15,
          max_segments=1 << 15, max_hits=1 << 17, max_candidates=1 << 14,
          max_deltas=1 << 15)),
]

#: tests/test_torch_dense.py's group scenes, at its size and tiles.
GROUP_SCENES = [
    ("clip_star", fixtures.make_clip_star),
    ("gradient_demo", fixtures.make_gradient_demo),
    ("holes_demo", fixtures.make_holes_demo),
]
GROUP_SIZE = 256


def make_bail_scene(size: int = 256):
    """Strokes and a circle under an opaque square that covers every tile
    but the border's: those tiles bail on its Solid; a translucent
    triangle and a line over it keep their tiles from the Solid on."""
    b = SceneBuilder()
    for i in range(8):
        x = 8.0 + 30.0 * i
        b.stroke_line((x, 4.0), (x + 12.0, size - 6.0), 3.0, 0x336699FF)
    b.circle(60.0, 60.0, 40.0)
    lo, hi = 16.0, size - 16.0
    b.fill([(lo, lo), (hi, lo), (hi, hi), (lo, hi)], 0xCC2200FF)
    b.fill([(100.0, 100.0), (180.0, 110.0), (140.0, 200.0)], 0x00AA0080)
    b.stroke_line((0.0, 128.0), (float(size), 140.0), 2.0, 0x000000FF)
    return b.build()


def make_corner_scene(size: int = 512):
    """A circle, a fill and a stroke in one corner: most tiles are empty."""
    b = SceneBuilder()
    b.circle(30.0, 30.0, 20.0)
    b.fill([(10.0, 50.0), (70.0, 40.0), (40.0, 90.0)], 0x11AA44FF)
    b.stroke_line((5.0, 5.0), (90.0, 60.0), 2.5, 0x8800FFC0)
    return b.build()


def _fitted(scene, size: int, tile_w: int, tile_h: int = 16):
    return fit_capacities(scene, RenderConfig(
        width=size, height=size, tile_height=tile_h, tile_width=tile_w))


def overflow_case():
    """tests/test_torch_dense.py's overflow case: the tiger at 1x, 16x128
    tiles, 128 command slots."""
    scene = make_tiger(scale=1.0)
    return scene, dataclasses.replace(_fitted(scene, 512, 128),
                                      cmd_capacity=128)


#: name -> () -> (scene, config): the CPU tests' cases.
CPU_CASES = {
    **{n: (lambda m=m, kw=kw: (m(), RenderConfig(**kw)))
       for n, m, kw in COARSE_CASES},
    "overflow": overflow_case,
    "bail": lambda: (make_bail_scene(), _fitted(make_bail_scene(), 256, 16)),
    "corner": lambda: (make_corner_scene(),
                       _fitted(make_corner_scene(), 512, 16)),
}


def _pass_kw(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates,
                cmd_capacity=cfg.cmd_capacity)


def dense_pass(scene, cfg, device, seg_pre=True):
    """(the dense pass's output, its tail's tensors, live mask, keywords,
    its sort keys) on ``device``."""
    taps = {}
    out = coarse.coarse_rasterize(
        prepare_scene(scene, cfg, device, seg_pre=seg_pre), output="dense",
        taps=taps, **_pass_kw(cfg))
    tail, live, kw = taps["dense_tail"]
    return out, tail, live, kw, taps["sort"]


@functools.lru_cache(maxsize=None)
def cpu_case(name):
    """The CPU dense pass of a case, as numpy: (out, (rows, sorted_idx,
    e_tile, color_bits), live, kw, the sorted first key), cached: the
    tests of a case share one pass."""
    scene, cfg = CPU_CASES[name]()
    out, tail, live, kw, (keys, _, _) = dense_pass(scene, cfg, "cpu")
    key0 = keys[0][tail[1].long()]
    return (out, tuple(t.numpy() for t in tail), live.numpy(), kw,
            key0.numpy())


def _meta(rows):
    m = rows.view(np.float32)[:, W_META].astype(np.int32)
    return (m & META_NCMDS_MASK, (m & META_OPAQUE_BIT) != 0,
            (m & META_CLEAR_BIT) != 0)


def tile_runs(e_tile, n_tiles):
    """Each tile's records [first, end), by integer searches of the
    non-decreasing tiles."""
    b = np.searchsorted(e_tile, np.arange(n_tiles + 1), side="left")
    return b[:-1], b[1:]


def _last(mask, first, end, none):
    """Per tile, the last record in [first, end) where ``mask`` holds."""
    out = np.full(first.shape, none, np.int64)
    for t, (lo, hi) in enumerate(zip(first, end)):
        hits = np.flatnonzero(mask[lo:hi])
        if hits.size:
            out[t] = lo + hits[-1]
    return out


def kernel_model(rows, sorted_idx, e_tile, color_bits, *, n_tiles,
                 max_hits, cmd_capacity):
    """csrc/dense_tail.cu's algorithm in numpy: each tile's run of
    records, its last opaque and last clearing record, the bail, and the
    commands at the positions a scan of the command counts from the first
    kept record gives.  Asserts, for each kept tile, that the positions of
    its commands are unique and exactly [0, total), so that the kept ones
    are [0, counts).  Returns ``(tags, args, counts, solid, overflow)``."""
    cap = cmd_capacity
    ncmds, opaque, clear = _meta(rows)
    rows_f = rows.view(np.float32)
    tags = np.zeros((n_tiles, cap), np.int32)
    args = np.zeros((n_tiles, cap, ARG_WORDS), np.int32)
    counts, solid, overflow = (np.zeros(n_tiles, np.int32) for _ in range(3))
    first, end = tile_runs(e_tile, n_tiles)
    opq = _last(opaque, first, end, -1)
    clr = _last(clear, first, end, -2)
    for t in range(n_tiles):
        if clr[t] < opq[t]:
            solid[t] = (color_bits[max(sorted_idx[opq[t]] - max_hits, 0)]
                        if opq[t] >= 0 else -1)
            continue
        begin = opq[t] if opq[t] >= 0 else first[t]
        n = ncmds[begin:end[t]]
        rel = np.cumsum(n) - n
        total = int(n.sum())
        positions = []
        for e, p in zip(range(begin, end[t]), rel):
            hit = sorted_idx[e] < max_hits
            tag0 = int(rows_f[e, W_S0_TAG])
            s1 = hit and rows_f[e, W_S1_TAG] == float(CMD_FILL)
            fill = np.zeros(ARG_WORDS, np.int32)
            fill[:N_S1_ARGS] = rows[e, W_S1_ARG:W_S1_ARG + N_S1_ARGS]
            slots = []
            if tag0:
                a0 = rows[e, W_S0_ARG:W_S0_ARG + ARG_WORDS].copy()
                if hit:
                    a0[N_S0_ARGS:] = 0
                slots.append((tag0, a0))
            if s1:
                slots.append((CMD_FILL, fill))
            for k, (tag, a) in enumerate(slots):
                positions.append(p + k)
                if p + k < cap:
                    tags[t, p + k] = tag
                    args[t, p + k] = a
        assert sorted(positions) == list(range(total)), (t, positions)
        counts[t] = min(total, cap)
        overflow[t] = max(total - cap, 0)
    return tags, args.reshape(n_tiles, -1), counts, solid, overflow


def _bits(t):
    a = np.ascontiguousarray(t.numpy() if torch.is_tensor(t) else t)
    return a.view(np.int32)


def assert_ptcl_equal(got, want, what):
    for name, g, w in zip(("tags", "args", "counts", "solid", "overflow"),
                          got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what}: {name}")


# ---- on the CPU: what the kernel rests on ---------------------------------

@pytest.mark.parametrize("name", list(CPU_CASES))
def test_sorted_tiles_rise_with_the_dead_records_last(name):
    """The sort leaves the tiles non-decreasing, the live records (finite
    key) below ``n_tiles`` and the dead ones after them at ``n_tiles``,
    their rows zero: each tile's records are one run."""
    _, (rows, _, e_tile, _), live, kw, key0 = cpu_case(name)
    assert np.all(np.diff(e_tile) >= 0)
    np.testing.assert_array_equal(live, key0 < np.inf)
    np.testing.assert_array_equal(live, e_tile < kw["n_tiles"])
    assert np.all(e_tile[~live] == kw["n_tiles"])
    assert not rows[~live].any()
    assert live.any()


@pytest.mark.parametrize("name", list(CPU_CASES))
def test_tile_runs_give_the_f32_maxima(name):
    """Each tile's run, found by integer searches, gives the first, last,
    last opaque and last clearing record of the plain version's f32
    ``scatter_reduce`` maxima (empty tiles: first E + 1, last below 0)."""
    _, (rows, _, e_tile, _), _, kw, _ = cpu_case(name)
    n_tiles = kw["n_tiles"]
    _, opaque, clear = _meta(rows)
    first_raw, last_raw, opq_e, clr_e = (
        t.numpy() for t in dense_tail._tile_maxima(
            torch.from_numpy(e_tile), torch.from_numpy(opaque),
            torch.from_numpy(clear), n_tiles))
    first, end = tile_runs(e_tile, n_tiles)
    has = end > first
    assert has.any() and (name != "corner" or (~has).sum() > n_tiles // 2)
    np.testing.assert_array_equal(last_raw >= 0, has)
    np.testing.assert_array_equal(first_raw[has], first[has])
    np.testing.assert_array_equal(last_raw[has], end[has] - 1)
    np.testing.assert_array_equal(first_raw[~has], rows.shape[0] + 1)
    np.testing.assert_array_equal(opq_e, _last(opaque, first, end, -1))
    np.testing.assert_array_equal(clr_e, _last(clear, first, end, -2))


@pytest.mark.parametrize("name", list(CPU_CASES))
def test_kernel_model_places_unique_slots_and_equals_the_plain_ptcl(name):
    """The kernel's scan from each tile's first kept record places its
    commands at unique positions, exactly [0, total) (asserted inside the
    model), keeps [0, counts) of them, and gives the plain version's
    tags, operand words, counts, bail colours and overflow word for
    word."""
    out, tail, _, kw, _ = cpu_case(name)
    got = kernel_model(*tail, **kw)
    want = (out.tags, out.args, out.counts, out.solid, out.overflow)
    assert_ptcl_equal(got, want, name)
    assert int(out.diag["live_cmds"]) == int(got[2].sum())
    if name == "overflow":
        assert got[4].sum() > 0
    if name == "bail":
        assert (got[3] == np.array([0xCC2200FF], np.uint32).view(
            np.int32)[0]).sum() > 10


@pytest.mark.parametrize("name", list(CPU_CASES))
def test_kept_slots_are_exactly_zero_to_counts(name):
    """Every slot below a tile's count holds a command and every slot at
    or past it is zero: a tile's kept commands fill [0, counts) without a
    gap and nothing lies past it."""
    out, _, _, _, _ = cpu_case(name)
    tags, counts = out.tags.numpy(), out.counts.numpy()
    args = out.args.numpy().reshape(tags.shape[0], tags.shape[1], -1)
    below = np.arange(tags.shape[1])[None, :] < counts[:, None]
    assert np.all(tags[below] != 0)
    assert not tags[~below].any()
    assert not _bits(args[~below]).any()
    assert counts.max() > 0


def test_the_cpu_pass_launches_no_dense_tail():
    scene, cfg = CPU_CASES["corner"]()
    tracing.reset_launches()
    out, _, _, _, _ = dense_pass(scene, cfg, "cpu")
    assert int(out.counts.sum()) > 0
    assert tracing.LAUNCHES["dense_tail"] == 0


# ---- on the card ----------------------------------------------------------

def _bench_case(name):
    """A benchmark configuration's scene (seed 1) at its fitted
    capacities, as its replay cell fits them."""
    config = json.loads((ROOT / "frame_bench" / "configs"
                         / f"{name}.json").read_text())
    from frame_bench import scenes
    from frame_bench.workload import port_scene
    scene = port_scene(scenes.make_scene(config, 1))
    return scene, fit_capacities(scene, RenderConfig(
        width=config["width"], height=config["height"],
        tile_width=config["tile_width"], tile_height=config["tile_height"],
        cmd_capacity=config["cmd_capacity"]))


def _group_case(make):
    scene = make(GROUP_SIZE)
    return scene, _fitted(scene, GROUP_SIZE, 128)


#: name -> () -> (scene, config, seg_pre): the card tests' cases.
CUDA_CASES = {
    **{n: (lambda c=c: c() + (True,)) for n, c in CPU_CASES.items()},
    **{n: (lambda m=m: _group_case(m) + (True,)) for n, m in GROUP_SCENES},
    **{f"{n}_derived": (lambda m=m: _group_case(m) + (False,))
       for n, m in GROUP_SCENES[::2]},
    **{n: (lambda n=n: _bench_case(n) + (True,))
       for n in ("tiger_4k", "beziers_10k", "glyph_page_5k")},
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_dense_tail_equals_plain(name):
    """The kernel's PTCL, word for word the plain version's on the same
    sorted records (copied to the CPU), with one launch a pass."""
    _need_card()
    scene, cfg, seg_pre = CUDA_CASES[name]()
    tracing.reset_launches()
    out, tail, live, kw, _ = dense_pass(scene, cfg, "cuda", seg_pre)
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["dense_tail"] == 1
    want = dense_tail.dense_tail_plain(*(t.cpu() for t in tail), live.cpu(),
                                       **kw)
    got = (out.tags, out.args, out.counts, out.solid, out.overflow)
    assert_ptcl_equal([t.cpu() for t in got], want, name)
    assert int(out.diag["live_cmds"]) == int(want[2].sum()) > 0


@pytest.mark.cuda
def test_cuda_dense_tail_launches_once_a_dense_pass_only():
    _need_card()
    scene, cfg = CPU_CASES["tiger_1x"]()
    dev = prepare_scene(scene, cfg, "cuda")
    kw = _pass_kw(cfg)
    tracing.reset_launches()
    for _ in range(3):
        coarse.coarse_rasterize(dev, output="dense", **kw)
    assert tracing.LAUNCHES["dense_tail"] == 3
    tracing.reset_launches()
    coarse.coarse_rasterize(dev, output="entries", **kw)
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["dense_tail"] == 0


def _frame_steps():
    """The 512^2 tiger's dense frame steps: staged once, and spun on the
    card (the segment stage derived in the frame)."""
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512),
                         bucket=True)
    render = make_render_fn(cfg, "cuda")
    x = render.stage(prepare_scene(scene, cfg, "cuda"))
    yield render.step, lambda: render.flat(x)
    cfg = dataclasses.replace(cfg, max_hits=8 * cfg.max_hits,
                              max_candidates=8 * cfg.max_candidates)
    render_t = affine.make_affine_render_fn(
        cfg, scene, lambda t: affine.rotation_about(256.0, 256.0, t, 0.9))
    yield render_t.step, lambda: render_t(0.5)


@pytest.mark.cuda
def test_cuda_tile_reduce_stage_is_at_most_12_nodes():
    """In a captured dense frame the stage from the sorted gather to the
    PTCL is the overflow clamps, the kernel and the command sum."""
    _need_card()
    for step, call in _frame_steps():
        call()
        torch.cuda.synchronize()
        (entry,) = step._entries.values()
        stages = dict(entry.stages)
        assert 0 < stages["tile_reduce"] <= 12, entry.stages
