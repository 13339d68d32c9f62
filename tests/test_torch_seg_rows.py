"""The device segment stage's rows: ``ops/seg_rows.py::seg_rows`` (the
kernel ``csrc/seg_rows.cu``) against its plain version
``ops/seg_rows.py::seg_rows_plain``.

On the CPU: ``coarse.derive_seg_stage``, which runs the plain version on
CPU tensors, gives ``build_seg_pre``'s rows on every live segment and its
hit counts, offsets and total everywhere, on tests/test_torch_coarse.py's
scenes, a clip fixture and :func:`make_edge_scene` (zero-length, vertical
and horizontal segments, segments on tile edges, line and clip items, in
several kernel blocks with a ragged last one); and launches no kernel.

On the card (``cuda``): the kernel against the plain version (run on the
same card tensors) word for word on every slot, dead slots included, with
the hit counts, offsets, live count and total, on those scenes, on the 4K
tiger under three poses of the benchmark's anim traffic and on synthetic
rows full of the values the expressions can meet (NaN, infinities, -0.0,
denormals, coordinates past int32 once divided by the tile); one launch a
derivation, and one a derived frame through its graph.

No JAX here: on the card,
``python -m pytest --noconftest tests/test_torch_seg_rows.py -q``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

from piet_tpu_torch import tracing  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.ops import coarse, seg_rows  # noqa: E402
from piet_tpu_torch.ops.candfuse import cand_prep  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    make_render_fn, prepare_scene)
from piet_tpu_torch.renderer.segstage import build_seg_pre  # noqa: E402
from piet_tpu_torch.scene import affine, fixtures  # noqa: E402
from piet_tpu_torch.scene.scene import (  # noqa: E402
    TAG_CLIP, TAG_LINE, SceneBuilder)
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402

BLOCK = seg_rows.BLOCK


def make_edge_scene(size: int = 512):
    """Segments the derivation treats apart, over four 256-slot blocks of
    128x32 tiles: a clip whose edges lie on tile edges, around a fill with
    a zero-length segment, an axis-aligned rect on tile edges, a polyline
    with vertical, horizontal and zero-length segments, line items (one
    of zero length, one on a tile row's edge, one on the right border),
    a circle (no segment), and a 600-point fill and a 300-point polyline
    that carry the slots across the blocks."""
    b = SceneBuilder()
    b.clip_path([(0.0, 0.0), (384.0, 0.0), (384.0, 448.0), (0.0, 448.0)])
    b.fill([(10.0, 10.0), (10.0, 10.0), (200.0, 40.0), (60.0, 150.0)],
           0x2266AAFF)
    b.fill([(128.0, 64.0), (256.0, 64.0), (256.0, 96.0), (128.0, 96.0)],
           0xAA2200C0)
    b.polyline([(300.0, 20.0), (300.0, 200.0), (300.0, 200.0),
                (450.0, 200.0), (450.0, 32.0)], 0x118833FF, 3.0)
    b.pop()
    b.stroke_line((50.0, 300.0), (50.0, 300.0), 4.0, 0x000000FF)
    b.stroke_line((0.0, 256.0), (float(size), 256.0), 2.0, 0x3344EEFF)
    b.stroke_line((float(size), 0.0), (float(size), 128.0), 1.0,
                  0x884400FF)
    b.circle(400.0, 400.0, 50.0)
    ring = [(256.0 + 200.0 * math.cos(2.0 * math.pi * k / 600),
             256.0 + 200.0 * math.sin(2.0 * math.pi * k / 600))
            for k in range(600)]
    b.fill(ring, 0x55AA5580)
    b.polyline([(10.0 + 1.6 * k, 480.0 + 12.0 * math.sin(k / 9.0))
                for k in range(300)], 0x202020FF, 1.5)
    return b.build()


def _edge_case():
    scene = make_edge_scene()
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512,
                                             tile_height=32, tile_width=128))
    n_segs = int(build_seg_pre(scene, cfg).n_segs[0])
    # Dead slots after the live ones, and a ragged last block.
    return scene, dataclasses.replace(cfg, max_segments=n_segs + 77)


def _fitted(make, wh, th):
    def case():
        scene = make()
        return scene, fit_capacities(scene, RenderConfig(
            width=wh[0], height=wh[1], tile_height=th, tile_width=128))
    return case


#: name -> () -> (scene, config): tests/test_torch_coarse.py's scenes, a
#: clip fixture and the edge scene.
SCENES = {
    "tiger_1x": _fitted(lambda: make_tiger(scale=1.0), (512, 512), 32),
    "path_test": _fitted(lambda: fixtures.get_scene("path_test"),
                         (256, 256), 32),
    "animated": _fitted(lambda: fixtures.get_scene("animated"), (512, 512),
                        32),
    "gradients": _fitted(lambda: fixtures.get_scene("gradients"),
                         (256, 256), 16),
    "holes": _fitted(lambda: fixtures.get_scene("holes"), (256, 256), 16),
    "star_evenodd": _fitted(lambda: fixtures.get_scene("star_evenodd"),
                            (256, 256), 32),
    "clip_star": _fitted(fixtures.make_clip_star, (256, 256), 32),
    "edges": _edge_case,
}


def derive(dscene, cfg):
    """(the derived SegPre, the seg_rows call's arguments and keywords,
    its launches) of a staged scene with no ``seg_pre``."""
    ci = cand_prep(dscene, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                   tile_w=cfg.tile_width, tile_h=cfg.tile_height)
    taps = {}
    with tracing.launches_apart() as launches:
        sp = coarse.derive_seg_stage(
            dscene, ci.cand_pack[:, 15:24], tile_w=cfg.tile_width,
            tile_h=cfg.tile_height, max_segments=cfg.max_segments, taps=taps)
    return sp, taps["seg_rows"], launches["seg_rows"]


def _np(t):
    return np.ascontiguousarray(t.cpu().numpy()).view(np.int32)


# ---- on the CPU -----------------------------------------------------------

@pytest.mark.parametrize("name", list(SCENES))
def test_plain_rows_equal_the_host_stage(name):
    """The plain version, through derive_seg_stage, gives build_seg_pre's
    rows on every live segment and its hit counts, offsets and totals on
    every slot, with no kernel launched."""
    scene, cfg = SCENES[name]()
    tracing.reset_launches()
    sp, _, launched = derive(prepare_scene(scene, cfg, "cpu", seg_pre=False),
                             cfg)
    host = build_seg_pre(scene, cfg)
    n = int(host.n_segs[0])
    assert n > 0 and int(sp.n_segs[0]) == n
    assert int(sp.n_hits[0]) == int(host.n_hits[0]) > 0
    np.testing.assert_array_equal(_np(sp.seg_rows[:n]),
                                  host.seg_rows[:n].view(np.int32))
    np.testing.assert_array_equal(_np(sp.hit_counts),
                                  host.hit_counts.view(np.int32))
    np.testing.assert_array_equal(_np(sp.hit_excl),
                                  host.hit_excl.view(np.int32))
    np.testing.assert_array_equal(_np(sp.seg_rows[:, 26]), _np(sp.hit_excl))
    assert launched == 0 and tracing.LAUNCHES["seg_rows"] == 0


def test_the_edge_scene_holds_what_it_is_for():
    """make_edge_scene's live slots span four kernel blocks, the last
    ragged, with dead slots after them; among them zero-length, vertical
    and horizontal segments, segments on tile edges, and the segments of
    a line item and a clip item."""
    scene, cfg = _edge_case()
    sp, _, _ = derive(prepare_scene(scene, cfg, "cpu", seg_pre=False), cfg)
    n, S = int(sp.n_segs[0]), cfg.max_segments
    assert S % BLOCK and S - n == 77 and n > 3 * BLOCK
    rows = sp.seg_rows[:n]
    f = rows.view(torch.float32)
    sx, sy, ex, ey = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
    assert bool(((sx == ex) & (sy == ey)).any())
    assert bool(((sx == ex) & (sy != ey)).any())
    assert bool(((sy == ey) & (sx != ex)).any())
    on_x = (sx % cfg.tile_width == 0) & (sx == ex)
    on_y = (sy % cfg.tile_height == 0) & (sy == ey)
    assert bool(on_x.any()) and bool(on_y.any())
    tags = prepare_scene(scene, cfg, "cpu").tags
    items = tags[rows[:, 16].long()]
    assert bool((items == TAG_LINE).any()) and bool((items == TAG_CLIP).any())
    assert bool(((rows[:, 12] & 4) != 0).any())   # the line item flag
    assert int(sp.hit_counts[n:].abs().sum()) == 0


# ---- on the card ----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


#: The 4K tiger's anim poses (k of the anim traffic's 64 in a period).
POSES = (0, 21, 45)


def _tiger_4k_pose(k):
    """The 4K tiger (tiger_4k's geometry) under pose k of the anim
    traffic's 64: a turn of 2 pi k / 64 about the centre with a zoom of
    1 + 0.1 sin, on the card."""
    scene = make_tiger(scale=19.2)
    cfg = fit_capacities(scene, RenderConfig(
        width=3840, height=2160, tile_width=128, tile_height=32,
        cmd_capacity=1024), bucket=True)

    def mats(t):
        a = t * (2.0 * math.pi)
        return affine.rotation_about(1920.0, 1080.0, a,
                                     1.0 + 0.1 * torch.sin(a))

    render_t = affine.make_affine_render_fn(cfg, scene, mats, device="cuda")
    return render_t.scene_at(k / 64.0), cfg


def _synthetic(seed=7, S=3 * BLOCK + 45):
    """Synthetic item rows and endpoints on the card: random tags (live
    and dead), bboxes around the points' tiles, widths and coordinates
    drawn from tile edges, fractions, -0.0, denormals, NaN, +-inf and
    values past int32 once divided by the tile; repeated endpoints and
    shared coordinates (zero-length, vertical, horizontal segments)."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, np.nan, np.inf, -np.inf,
                        1e12, -1e12, 3e9, 128.0, 256.0, 32.0, 96.0, 512.0,
                        -128.0, 0.5, 127.99999], np.float32)

    def coords(n):
        v = rng.uniform(-300.0, 900.0, n).astype(np.float32)
        pick = rng.random(n) < 0.3
        v[pick] = rng.choice(special, pick.sum())
        return v

    sitem = rng.integers(-5, 40, (S, 14), dtype=np.int32)
    sitem[:, 0] = rng.integers(0, 8, S)
    sitem[:, 6] = sitem[:, 4] + rng.integers(-2, 8, S)
    sitem[:, 7] = sitem[:, 5] + rng.integers(-2, 8, S)
    sitem[:, 9] = coords(S).view(np.int32)
    p0 = np.stack([coords(S), coords(S)], 1)
    p1 = np.stack([coords(S), coords(S)], 1)
    same = rng.random(S) < 0.1
    p1[same] = p0[same]
    vert = rng.random(S) < 0.1
    p1[vert, 0] = p0[vert, 0]
    horiz = rng.random(S) < 0.1
    p1[horiz, 1] = p0[horiz, 1]
    dev = torch.device("cuda")
    return ((torch.from_numpy(sitem).to(dev), torch.from_numpy(p0).to(dev),
             torch.from_numpy(p1).to(dev),
             torch.tensor([S - 61], dtype=torch.int32, device=dev)),
            dict(tile_w=128, tile_h=32))


def _on_card(case):
    scene, cfg = case()
    return prepare_scene(scene, cfg, "cuda", seg_pre=False), cfg


#: name -> () -> (a staged scene on the card with no seg_pre, config).
CUDA_SCENES = {
    **{n: (lambda c=c: _on_card(c)) for n, c in SCENES.items()},
    **{f"tiger_4k_pose{k}": (lambda k=k: _tiger_4k_pose(k)) for k in POSES},
}


def _assert_equal(got, want, what):
    for name, g, w in zip(("rows", "hit_counts", "hit_excl", "n_hits"),
                          got, want):
        assert g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(_np(g), _np(w),
                                      err_msg=f"{what}: {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_SCENES))
def test_cuda_seg_rows_equal_plain(name):
    """The kernel's rows, hit counts, offsets and total, word for word the
    plain version's on every slot of the derivation, in one launch."""
    _need_card()
    dscene, cfg = CUDA_SCENES[name]()
    sp, (args, kw), launched = derive(dscene, cfg)
    torch.cuda.synchronize()
    assert launched == 1
    want = seg_rows.seg_rows_plain(*args, **kw)
    _assert_equal((sp.seg_rows, sp.hit_counts, sp.hit_excl, sp.n_hits),
                  want, name)
    assert int(sp.n_segs[0]) > 0 and int(sp.n_hits[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8])
def test_cuda_seg_rows_equal_plain_on_synthetic_rows(seed):
    _need_card()
    args, kw = _synthetic(seed)
    tracing.reset_launches()
    got = seg_rows.seg_rows(*args, **kw)
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["seg_rows"] == 1
    _assert_equal(got, seg_rows.seg_rows_plain(*args, **kw), f"seed {seed}")


@pytest.mark.cuda
def test_cuda_one_seg_rows_launch_a_derived_frame():
    """A frame that derives its segments (the affine tiger) launches the
    kernel once, through its graph's replays; a host-staged frame never."""
    _need_card()
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512),
                         bucket=True)
    static = make_render_fn(cfg, "cuda")
    x = static.stage(prepare_scene(scene, cfg, "cuda"))
    cfg = dataclasses.replace(cfg, max_hits=8 * cfg.max_hits,
                              max_candidates=8 * cfg.max_candidates)
    render_t = affine.make_affine_render_fn(
        cfg, scene, lambda t: affine.rotation_about(256.0, 256.0, t, 0.9))
    tracing.reset_launches()
    for k in range(3):
        render_t(0.25 * k)
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["seg_rows"] == 3
    tracing.reset_launches()
    for _ in range(2):
        static.flat(x)
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["seg_rows"] == 0
