"""The unpacked sort-key route of the port's coarse pass against the JAX
package's, word for word, on the CPU.

Where the packed key ``tile * 2*(NI+1) + item*2 + class`` would reach
2^24, both coarse passes sort on two f32 keys, (tile, item*2 + class)
(piet_tpu/ops/coarse.py:1070-1113).  The configuration trips that on a
small scene: 1024^2 in 16x16 tiles (4,096 tiles) with room for 2,048
items, so 4,096 x 4,098 >= 2^24, on the cardioid of tests/test_coarse.py.
Both outputs (entries and dense) with both segment stages (host-staged
and derived on the device) are compared, and the frames of both routes
are held bitwise to the numpy oracle.  The JAX side runs its staged
record route eagerly, as tests/test_torch_coarse.py describes.
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
from piet_tpu_torch.ops.coarse import (coarse_rasterize,  # noqa: E402
                                       stream_to_jax_layout)
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    Renderer, device_scene_from_numpy)
from piet_tpu_torch.scene.fixtures import make_cardioid  # noqa: E402

ENTRIES = ("stream", "first", "n_entries", "counts", "solid")
DENSE = ("tags", "args", "counts", "solid", "overflow")


def unpacked_config(scene):
    """The scene's fitted capacities at 1024^2 in 16x16 tiles, with room
    for 2,048 items: a packed key would reach 2^24."""
    cfg = fit_capacities(scene, RenderConfig(width=1024, height=1024,
                                             tile_height=16, tile_width=16))
    return dataclasses.replace(cfg, max_items=2048)


@pytest.fixture(scope="module")
def scene_cfg():
    scene = make_cardioid(center=(512.0, 512.0), r=400.0)
    return scene, unpacked_config(scene)


def test_config_trips_the_unpacked_route(scene_cfg):
    _, cfg = scene_cfg
    n_tiles = cfg.tiles_x * cfg.tiles_y
    assert n_tiles * 2 * (cfg.max_items + 1) >= 2 ** 24
    assert n_tiles < 2 ** 24 and 2 * cfg.max_items + 2 < 2 ** 24


def _kw(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates)


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.itemsize == 4 else x


@pytest.mark.parametrize("output", ["entries", "dense"])
@pytest.mark.parametrize("seg_pre", [True, False],
                         ids=["host_segments", "derived_segments"])
def test_unpacked_coarse_matches_jax(scene_cfg, output, seg_pre):
    scene, cfg = scene_cfg
    jdev = jax_renderer.prepare_scene(scene, cfg, seg_pre=seg_pre)
    extra = ({"cmd_capacity": cfg.cmd_capacity} if output == "dense"
             else {})
    want = jax_coarse(jdev, cmd_capacity=cfg.cmd_capacity,
                      max_deltas=cfg.max_deltas, output=output,
                      sort_impl="xla", pair="off", hitfuse="off",
                      **_kw(cfg))
    dev = device_scene_from_numpy(jax.tree.map(np.asarray, jdev), "cpu")
    assert (dev.seg_pre is None) == (not seg_pre)
    taps = {}
    got = coarse_rasterize(dev, output=output, taps=taps, **extra,
                           **_kw(cfg))
    keys, _, bounds = taps["sort"]
    assert len(keys) == 2 and bounds == (cfg.tiles_x * cfg.tiles_y,
                                         2 * cfg.max_items + 2)
    for leaf in ENTRIES if output == "entries" else DENSE:
        g = getattr(got, leaf)
        if leaf == "stream":
            g = stream_to_jax_layout(g)
        np.testing.assert_array_equal(_bits(g.numpy()),
                                      _bits(getattr(want, leaf)),
                                      err_msg=f"{output}: {leaf}")
    live = (got.n_entries if output == "entries" else got.counts).sum()
    assert int(live) > 0
    for k in ("n_segments", "n_hits", "n_candidates", "n_deltas"):
        assert int(got.diag[k]) == int(want.diag[k]), k


@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_unpacked_render_equals_oracle(scene_cfg, fine_impl):
    scene, cfg = scene_cfg
    img = Renderer(cfg, device="cpu", fine_impl=fine_impl).render(scene)
    np.testing.assert_array_equal(img, cpu_render_scene(scene, cfg))
