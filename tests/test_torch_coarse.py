"""The port's coarse pass (piet_tpu_torch/ops/coarse.py) against the JAX
package's ``coarse_rasterize(output="entries")``, word for word.

Both sides take the same staged leaves (the JAX package's prepare_scene,
as numpy).  The JAX reference runs the staged record route
(hitfuse="off", sort_impl="xla", pair="off"), eagerly -- one primitive at
a time, so XLA:CPU contracts nothing; the port always takes the fused
route, which the JAX package pins bitwise equal to the staged one
(tests/test_hitfuse.py).  The port's entry-major stream is compared in
the JAX block layout.  Both segment stages are covered: the host-staged
``seg_pre`` and the device derivation (``seg_pre=None``), which must also
equal each other inside the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from piet_tpu.config import RenderConfig  # noqa: E402
from piet_tpu.ops.coarse import coarse_rasterize as jax_coarse  # noqa: E402
from piet_tpu.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu.renderer.renderer import prepare_scene  # noqa: E402
from piet_tpu.renderer.segstage import build_seg_pre  # noqa: E402
from piet_tpu.scene import fixtures  # noqa: E402
from piet_tpu.scene.svg import make_tiger  # noqa: E402
from piet_tpu_torch.ops.coarse import (cand_inputs,  # noqa: E402
                                       coarse_rasterize, derive_seg_stage,
                                       stream_from_jax_layout,
                                       stream_to_jax_layout)
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    device_scene_from_numpy)

LEAVES = ("stream", "first", "n_entries", "counts", "solid")

SCENES = [
    ("tiger_1x", lambda: make_tiger(scale=1.0), (512, 512), 32),
    ("path_test", lambda: fixtures.get_scene("path_test"), (256, 256), 32),
    ("animated", lambda: fixtures.get_scene("animated"), (512, 512), 32),
    ("gradients", lambda: fixtures.get_scene("gradients"), (256, 256), 16),
    ("holes", lambda: fixtures.get_scene("holes"), (256, 256), 16),
    ("star_evenodd", lambda: fixtures.get_scene("star_evenodd"), (256, 256),
     32),
]


def _kw(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates)


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32) if x.dtype.kind == "f" else x.astype(np.int64)


@pytest.mark.parametrize("name,make,wh,th", SCENES,
                         ids=[s[0] for s in SCENES])
def test_coarse_entries_match_jax(name, make, wh, th):
    scene = make()
    cfg = fit_capacities(scene, RenderConfig(
        width=wh[0], height=wh[1], tile_height=th, tile_width=128))
    jdev = prepare_scene(scene, cfg)
    want = jax_coarse(jdev, cmd_capacity=cfg.cmd_capacity,
                      max_deltas=cfg.max_deltas, output="entries",
                      sort_impl="xla", pair="off", hitfuse="off", **_kw(cfg))
    dev = device_scene_from_numpy(jax.tree.map(np.asarray, jdev), "cpu")
    got = coarse_rasterize(dev, **_kw(cfg))
    assert int(got.n_entries.sum()) > 0
    for leaf in LEAVES:
        g = getattr(got, leaf)
        if leaf == "stream":
            g = stream_to_jax_layout(g)
        w = _bits(getattr(want, leaf))
        g = _bits(g.numpy())
        if leaf == "solid":
            g = g & 0xFFFFFFFF
        np.testing.assert_array_equal(g, w, err_msg=f"{name}: {leaf}")
    for k in ("n_segments", "n_hits", "n_candidates", "n_deltas",
              "live_entries"):
        assert int(got.diag[k]) == int(want.diag[k]), k


def _assert_entries_equal(got, want, what):
    for leaf in LEAVES:
        g = getattr(got, leaf)
        if leaf == "stream":
            g = stream_to_jax_layout(g)
        g = _bits(g.numpy())
        if leaf == "solid":
            g = g & 0xFFFFFFFF
        w = getattr(want, leaf)
        if isinstance(w, torch.Tensor):
            w = stream_to_jax_layout(w) if leaf == "stream" else w
            w = w.numpy()
        w = _bits(w)
        if leaf == "solid":
            w = w & 0xFFFFFFFF
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {leaf}")


@pytest.mark.parametrize("name,make,wh,th", SCENES,
                         ids=[s[0] for s in SCENES])
def test_coarse_derived_segments_match_jax(name, make, wh, th):
    """seg_pre=None: the segment stage derived on the device (expand_rows,
    gather_monotone), word for word against JAX's derivation and against
    the port's own host-staged route."""
    scene = make()
    cfg = fit_capacities(scene, RenderConfig(
        width=wh[0], height=wh[1], tile_height=th, tile_width=128))
    jdev = prepare_scene(scene, cfg, seg_pre=False)
    want = jax_coarse(jdev, cmd_capacity=cfg.cmd_capacity,
                      max_deltas=cfg.max_deltas, output="entries",
                      sort_impl="xla", pair="off", hitfuse="off", **_kw(cfg))
    dev = device_scene_from_numpy(jax.tree.map(np.asarray, jdev), "cpu")
    assert dev.seg_pre is None
    taps = {}
    got = coarse_rasterize(dev, taps=taps, **_kw(cfg))
    assert "expand" in taps and len(taps["gatherm"]) == 2
    assert int(got.n_entries.sum()) > 0
    _assert_entries_equal(got, want, name)
    for k in ("n_segments", "n_hits", "n_candidates", "n_deltas",
              "live_entries"):
        assert int(got.diag[k]) == int(want.diag[k]), k
    staged = coarse_rasterize(
        device_scene_from_numpy(jax.tree.map(
            np.asarray, prepare_scene(scene, cfg)), "cpu"), **_kw(cfg))
    _assert_entries_equal(got, staged, f"{name} vs seg_pre route")


@pytest.mark.parametrize("name,make,wh,th", SCENES[:3],
                         ids=[s[0] for s in SCENES[:3]])
def test_derived_segment_rows_equal_host_stage(name, make, wh, th):
    """The device-derived (S, 27) rows equal build_seg_pre's on every live
    segment, and the hit counts and offsets everywhere.  Dead rows are
    read by no record (hit count 0): there the derivation keeps the JAX
    device pass's words (c = -0.0, half width 0.5, widths clamped to 1)
    where the host stage writes zeros."""
    scene = make()
    cfg = fit_capacities(scene, RenderConfig(
        width=wh[0], height=wh[1], tile_height=th, tile_width=128))
    dev = device_scene_from_numpy(
        jax.tree.map(np.asarray, prepare_scene(scene, cfg)), "cpu")
    ci = cand_inputs(dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                     tile_w=cfg.tile_width, tile_h=cfg.tile_height)
    sp = derive_seg_stage(dev, ci.cand_pack[:, 15:24],
                          tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                          max_segments=cfg.max_segments)
    host = build_seg_pre(scene, cfg)
    n = int(host.n_segs[0])
    assert int(sp.n_segs[0]) == n and int(sp.n_hits[0]) == int(
        host.n_hits[0])
    np.testing.assert_array_equal(sp.seg_rows[:n].numpy().view(np.uint32),
                                  host.seg_rows[:n])
    np.testing.assert_array_equal(sp.hit_counts.numpy(), host.hit_counts)
    np.testing.assert_array_equal(sp.hit_excl.numpy(), host.hit_excl)


@pytest.mark.parametrize("row0,rows", [(0, 3), (2, 3), (5, 3)])
def test_coarse_slab_matches_jax(row0, rows):
    """A window of tile rows [row0, row0 + rows), with the host segment
    stage built for that window, as a row-sharded caller stages it."""
    scene = fixtures.get_scene("clip_star")
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256,
                                             tile_height=32, tile_width=128))
    slab = dataclasses.replace(cfg, height=rows * cfg.tile_height)
    jdev = prepare_scene(scene, cfg)._replace(
        seg_pre=build_seg_pre(scene, slab, row0=row0))
    kw = dict(_kw(cfg), tiles_y=rows, row0=row0)
    want = jax_coarse(jdev, cmd_capacity=cfg.cmd_capacity,
                      max_deltas=cfg.max_deltas, output="entries",
                      sort_impl="xla", pair="off", hitfuse="off", **kw)
    got = coarse_rasterize(
        device_scene_from_numpy(jax.tree.map(np.asarray, jdev), "cpu"), **kw)
    assert int(got.n_entries.sum()) > 0
    for leaf in LEAVES:
        g = getattr(got, leaf)
        if leaf == "stream":
            g = stream_to_jax_layout(g)
        g = _bits(g.numpy())
        if leaf == "solid":
            g = g & 0xFFFFFFFF
        np.testing.assert_array_equal(g, _bits(getattr(want, leaf)),
                                      err_msg=f"row0={row0}: {leaf}")


@pytest.mark.parametrize("row0", [2, 5])
def test_coarse_slab_derived_segments_match_jax(row0):
    """A tile-row window with the segment stage derived on the device."""
    scene = fixtures.get_scene("clip_star")
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256,
                                             tile_height=32, tile_width=128))
    jdev = prepare_scene(scene, cfg, seg_pre=False)
    kw = dict(_kw(cfg), tiles_y=3, row0=row0)
    want = jax_coarse(jdev, cmd_capacity=cfg.cmd_capacity,
                      max_deltas=cfg.max_deltas, output="entries",
                      sort_impl="xla", pair="off", hitfuse="off", **kw)
    got = coarse_rasterize(
        device_scene_from_numpy(jax.tree.map(np.asarray, jdev), "cpu"), **kw)
    assert int(got.n_entries.sum()) > 0
    _assert_entries_equal(got, want, f"row0={row0}")


def test_stream_layout_round_trip():
    x = torch.arange(256 * 16, dtype=torch.float32).reshape(256, 16)
    blocks = stream_to_jax_layout(x)
    assert blocks.shape == (2, 16, 128)
    assert float(blocks[1, 3, 5]) == float(x[128 + 5, 3])
    assert torch.equal(stream_from_jax_layout(blocks), x)


@pytest.mark.parametrize("what", ["pairing"])
def test_uncovered_paths_raise(what):
    """Entry pairing is not ported.  (Grids whose packed sort key passes
    2^24 take the unpacked two-key sort: tests/test_torch_unpacked.py.)"""
    scene = fixtures.get_scene("path_test")
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256))
    dev = device_scene_from_numpy(
        jax.tree.map(np.asarray, prepare_scene(scene, cfg)), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        coarse_rasterize(dev, pair="compact", **_kw(cfg))
