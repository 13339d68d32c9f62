"""The port's dense route on the CPU against the JAX package and the numpy
oracle: ``coarse_rasterize(output="dense")`` (piet_tpu_torch/ops/coarse.py),
``Renderer(fine_impl="dense")`` and the renderer's remaining entry points
(renderer/renderer.py), and one dense frame of each device animation.
The dense interpreters are held to JAX in tests/test_torch_dense_fine.py,
and the dense coarse pass on the seven configurations of
tests/test_coarse.py in tests/test_torch_dense_coarse.py (files of their
own, so that parallel test workers share the eager JAX passes' time).

Coarse: both sides take the same staged leaves; the JAX pass runs eagerly
on its staged record route (hitfuse="off", sort_impl="xla"), the port on
its fused route, and the (T, CAP) tags and operands, counts, bail colours
and overflow must agree word for word -- whole arrays, dead slots
included -- and equal the port's ``cpu_tile_scene`` on every live prefix.
Images: the port's CPU interpreters round every operation on their own
and are held bitwise to the numpy oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from piet_tpu.ops.coarse import coarse_rasterize as jax_coarse  # noqa: E402
from piet_tpu.renderer import renderer as jax_renderer  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.ops.coarse import coarse_rasterize  # noqa: E402
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu_torch.raster.cpu_tiler import cpu_tile_scene  # noqa: E402
from piet_tpu_torch.raster.ptcl import ARG_WORDS  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    Renderer, SceneCapacityError, device_scene_from_numpy, fetch_scene,
    pack_scene, prepare_scene, render_slab, stack_scenes, unpack_scene)
from piet_tpu_torch.scene import affine, animate, fixtures  # noqa: E402
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402

PTCL = ("tags", "args", "counts", "solid", "overflow")

#: The clip/layer, gradient and multi-subpath fixtures: together they
#: reach every one of the fifteen dense branches but the no-op.
GROUP_SCENES = [
    ("clip_star", fixtures.make_clip_star),
    ("gradient_demo", fixtures.make_gradient_demo),
    ("holes_demo", fixtures.make_holes_demo),
]
GROUP_SIZE = 256


def _group_cfg(scene):
    return fit_capacities(scene, RenderConfig(
        width=GROUP_SIZE, height=GROUP_SIZE, tile_height=16,
        tile_width=128))


def _kw(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates)


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.itemsize == 4 else x


def dense_both(scene, cfg, cap=None, seg_pre=True):
    """(JAX's dense PTCL, the port's) on the same staged leaves."""
    cap = cap or cfg.cmd_capacity
    jdev = jax_renderer.prepare_scene(scene, cfg, seg_pre=seg_pre)
    want = jax_coarse(jdev, cmd_capacity=cap, max_deltas=cfg.max_deltas,
                      output="dense", sort_impl="xla", hitfuse="off",
                      **_kw(cfg))
    dev = device_scene_from_numpy(jax.tree.map(np.asarray, jdev), "cpu")
    assert (dev.seg_pre is None) == (not seg_pre)
    got = coarse_rasterize(dev, output="dense", cmd_capacity=cap, **_kw(cfg))
    return want, got


def assert_dense_matches(want, got, scene, cfg, what):
    """Word for word against JAX; live prefixes against the oracle."""
    for leaf in PTCL:
        np.testing.assert_array_equal(
            _bits(getattr(got, leaf).numpy()), _bits(getattr(want, leaf)),
            err_msg=f"{what}: {leaf}")
    gold = cpu_tile_scene(scene, cfg)
    counts = got.counts.numpy()
    np.testing.assert_array_equal(counts, gold.counts, err_msg=what)
    np.testing.assert_array_equal(got.solid.numpy().view(np.uint32),
                                  gold.solid, err_msg=what)
    np.testing.assert_array_equal(got.overflow.numpy(), gold.overflow,
                                  err_msg=what)
    tags = got.tags.numpy()
    args = got.args.numpy().reshape(len(counts), -1, ARG_WORDS)
    for t, n in enumerate(counts):
        np.testing.assert_array_equal(tags[t, :n], gold.tags[t, :n],
                                      err_msg=f"{what}: tile {t} tags")
        np.testing.assert_array_equal(_bits(args[t, :n]),
                                      _bits(gold.args[t, :n]),
                                      err_msg=f"{what}: tile {t} args")
    assert int(got.diag["live_cmds"]) == int(counts.sum())
    for k in ("n_segments", "n_hits", "n_candidates", "n_deltas"):
        assert int(got.diag[k]) == int(want.diag[k]), k


# ---- coarse ---------------------------------------------------------------

@pytest.mark.parametrize("name,make", GROUP_SCENES,
                         ids=[s[0] for s in GROUP_SCENES])
def test_dense_coarse_group_scenes_match_jax(name, make):
    scene = make(GROUP_SIZE)
    cfg = _group_cfg(scene)
    want, got = dense_both(scene, cfg)
    assert int(got.counts.sum()) > 0
    assert_dense_matches(want, got, scene, cfg, name)


@pytest.mark.parametrize("name,make", GROUP_SCENES[::2],
                         ids=[s[0] for s in GROUP_SCENES[::2]])
def test_dense_coarse_derived_segments_match_jax(name, make):
    """seg_pre=None: the segment stage derived on the device."""
    scene = make(GROUP_SIZE)
    cfg = _group_cfg(scene)
    want, got = dense_both(scene, cfg, seg_pre=False)
    assert_dense_matches(want, got, scene, cfg, name)


def _overflow_cfg():
    """Tiger 1x, 16x128 tiles, 128 command slots."""
    scene = make_tiger(scale=1.0)
    return scene, dataclasses.replace(
        fit_capacities(scene, RenderConfig(width=512, height=512,
                                           tile_height=16, tile_width=128)),
        cmd_capacity=128)


def test_dense_coarse_overflow_matches_jax():
    """Commands past the capacity are dropped and counted, as JAX and the
    oracle count them."""
    scene, cfg = _overflow_cfg()
    want, got = dense_both(scene, cfg)
    assert int(got.overflow.sum()) > 0
    assert_dense_matches(want, got, scene, cfg, "overflow")


# ---- the dense renderer ---------------------------------------------------

RENDER_SCENES = [
    ("beziers_small", lambda: fixtures.make_random_beziers(n=150, size=384),
     384, 16),
    ("glyphs_small", lambda: fixtures.make_glyph_page(n_glyphs=300,
                                                      size=384), 384, 16),
    ("animated_small", lambda: fixtures.make_animated_frame(0.7, size=384,
                                                            n=40), 384, 16),
] + [(n, (lambda m=m: m(GROUP_SIZE)), GROUP_SIZE, 16)
     for n, m in GROUP_SCENES]


@pytest.mark.parametrize("name,make,size,th", RENDER_SCENES,
                         ids=[s[0] for s in RENDER_SCENES])
def test_dense_render_bitwise_equals_oracle(name, make, size, th):
    scene = make()
    r = Renderer.for_scene(scene, size, size, device="cpu",
                           fine_impl="dense", tile_height=th, tile_width=128)
    img = r.render(scene)
    np.testing.assert_array_equal(img, cpu_render_scene(scene, r.config),
                                  err_msg=name)
    assert r.last_stats["overflow_cmds"] == 0
    assert r.last_stats["live_cmds"] > 0


@pytest.mark.parametrize("case", ["fitted", "overflow"])
def test_dense_stats_equal_jax(case):
    """overflow_cmds, live_cmds, max_tile_cmds and bail_tiles of
    render_slab equal JAX's; the renderer raises on a PTCL overflow."""
    if case == "overflow":
        scene, cfg = _overflow_cfg()
    else:
        scene = fixtures.make_clip_star(GROUP_SIZE)
        cfg = _group_cfg(scene)
    jdev = jax_renderer.prepare_scene(scene, cfg)
    _, want = jax_renderer.render_slab(jdev, cfg, tiles_y=cfg.tiles_y, row0=0,
                                       fine_impl="xla")
    _, got = render_slab(prepare_scene(scene, cfg, "cpu"), cfg,
                         tiles_y=cfg.tiles_y, fine_impl="dense")
    for k in ("overflow_cmds", "live_cmds", "max_tile_cmds", "bail_tiles"):
        assert int(got[k]) == int(np.asarray(want[k])[0]), k
    r = Renderer(cfg, device="cpu", fine_impl="dense")
    if case == "overflow":
        assert int(got["overflow_cmds"]) > 0
        with pytest.raises(SceneCapacityError, match="PTCL overflow"):
            r.render(scene)
    else:
        assert int(got["overflow_cmds"]) == 0
        r.render(scene)


@pytest.mark.parametrize("row0", [0, 3, 5])
def test_dense_slab_bitwise_equals_oracle_rows(row0):
    """The dense route over tile rows [row0, row0 + 3), with the segment
    stage built for that window: absolute pixel coordinates."""
    from piet_tpu_torch.ops.coarse import SegPre
    from piet_tpu_torch.renderer.segstage import build_seg_pre
    scene = fixtures.make_clip_star(256)
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256,
                                             tile_height=32, tile_width=128))
    rows = 3
    slab = dataclasses.replace(cfg, height=rows * cfg.tile_height)
    sp = build_seg_pre(scene, slab, row0=row0)
    dev = prepare_scene(scene, cfg, "cpu")._replace(seg_pre=SegPre(*(
        torch.from_numpy(np.ascontiguousarray(getattr(sp, f)).view(np.int32))
        for f in SegPre._fields)))
    img, _ = render_slab(dev, cfg, tiles_y=rows, row0=row0,
                         fine_impl="dense")
    got = img.numpy().view(np.uint8).reshape(rows * cfg.tile_height, -1, 4)
    y0 = row0 * cfg.tile_height
    want = cpu_render_scene(scene, cfg)[y0:y0 + rows * cfg.tile_height]
    np.testing.assert_array_equal(got[:, :cfg.width], want)


def test_fine_impl_is_checked():
    cfg = RenderConfig(width=128, height=128)
    with pytest.raises(ValueError, match="fine_impl"):
        Renderer(cfg, device="cpu", fine_impl="xla")


# ---- the entry points -----------------------------------------------------

def _anim_frames(n=3):
    return [fixtures.make_animated_frame(t / 10.0, size=256, n=20)
            for t in range(n)]


def _anim_cfg(scene):
    return fit_capacities(scene, RenderConfig(
        width=256, height=256, tile_height=16, tile_width=128), bucket=True)


def test_pack_scene_equals_jax_and_round_trips():
    scene = fixtures.make_animated_frame(0.4, size=256, n=24)
    cfg = _anim_cfg(scene)
    buf = pack_scene(scene, cfg)
    np.testing.assert_array_equal(buf, jax_renderer.pack_scene(scene, cfg))
    got = unpack_scene(torch.from_numpy(buf.view(np.int32)), cfg)
    ref = prepare_scene(scene, cfg, "cpu")
    assert got.seg_pre is None
    for f in ref._fields:
        if f != "seg_pre":
            np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                          _bits(getattr(ref, f).numpy()),
                                          err_msg=f)


@pytest.mark.parametrize("fine_impl", ["dense", "entries"])
def test_render_entry_points_equal_render(fine_impl):
    """render_sequence, render_packed_u32 (segments derived on the
    device) and render_updated (points moved) equal render_u32."""
    scenes = _anim_frames()
    cfg = _anim_cfg(scenes[0])
    r = Renderer(cfg, device="cpu", fine_impl=fine_impl)
    seq = r.render_sequence(scenes)
    assert len(r.last_stats["n_hits"]) == len(scenes)
    for i, s in enumerate(scenes):
        np.testing.assert_array_equal(seq[i], r.render(s))
    want = r.render_u32(scenes[0])
    assert torch.equal(r.render_packed_u32(scenes[0]), want)
    # Every point and bbox two pixels to the right and down: the
    # quantized bboxes move by exactly 2.
    moved = dataclasses.replace(scenes[0], points=scenes[0].points + 2.0,
                                bboxes=scenes[0].bboxes + 2)
    assert torch.equal(r.render_updated(moved), r.render_u32(moved))
    np.testing.assert_array_equal(r.render(moved),
                                  cpu_render_scene(moved, cfg))


def test_stack_scenes_equals_jax():
    scenes = _anim_frames(2)
    cfg = _anim_cfg(scenes[0])
    want = jax_renderer.stack_scenes(scenes, cfg)
    got = stack_scenes(scenes, cfg, "cpu")
    pairs = [(f, getattr(got, f), getattr(want, f))
             for f in got._fields if f != "seg_pre"]
    pairs += [(f, getattr(got.seg_pre, f), getattr(want.seg_pre, f))
              for f in got.seg_pre._fields]
    for f, g, w in pairs:
        assert g.shape[0] == len(scenes), f
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=f)


def test_render_sequence_checks_capacity():
    scenes = _anim_frames(2)
    cfg = dataclasses.replace(_anim_cfg(scenes[0]), max_segments=16)
    with pytest.raises(SceneCapacityError, match="seg_overflow"):
        Renderer(cfg, device="cpu", fine_impl="dense").render_sequence(
            scenes)


# ---- one dense frame of each device animation -----------------------------

def _frame_checks(render_entries, render_dense, t, cfg, n_items, n_points):
    img_e, _ = render_entries(t)
    img_d, stats = render_dense(t)
    assert int(stats["overflow_cmds"]) == 0
    assert torch.equal(img_d, img_e)
    got = img_d.numpy().view(np.uint8).reshape(cfg.height, cfg.width, 4)
    frame = fetch_scene(render_dense.scene_at(t), n_items, n_points)
    np.testing.assert_array_equal(got, cpu_render_scene(frame, cfg))


def test_dense_affine_frame():
    scene = fixtures.make_gradient_demo(256)
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256,
                                             tile_height=16, tile_width=128),
                         bucket=True)
    cfg = dataclasses.replace(cfg, max_hits=8 * cfg.max_hits,
                              max_candidates=8 * cfg.max_candidates,
                              cmd_capacity=2 * cfg.cmd_capacity)

    def mats(t):
        return affine.rotation_about(128.0, 128.0, t, 0.9)

    fns = [affine.make_affine_render_fn(cfg, scene, mats, device="cpu",
                                        fine_impl=f)
           for f in ("entries", "dense")]
    _frame_checks(*fns, 0.5, cfg, scene.n_items, scene.n_points)


def test_dense_animated_frame():
    tmpl = animate.template_scene(size=256, n=24, seed=5)
    cfg = _anim_cfg(tmpl)
    fns = [animate.make_animated_render_fn(cfg, size=256, n=24, seed=5,
                                           device="cpu", fine_impl=f)[0]
           for f in ("entries", "dense")]
    _frame_checks(*fns, 0.7, cfg, tmpl.n_items, tmpl.n_points)
