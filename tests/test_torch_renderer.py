"""The port's renderer (piet_tpu_torch/renderer/renderer.py) end to end on
the CPU: bitwise against the numpy oracle, within the shared CPU image
policy of the JAX package's interpret-mode image, and its staging,
capacity and device contracts.

PyTorch runs eagerly and rounds every operation on its own, so the port's
CPU image is held to the oracle bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from _imgcmp import assert_images_match  # noqa: E402
from piet_tpu.config import RenderConfig  # noqa: E402
from piet_tpu.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu.renderer import renderer as jax_renderer  # noqa: E402
from piet_tpu.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu.renderer.segstage import build_seg_pre  # noqa: E402
from piet_tpu.scene import fixtures  # noqa: E402
from piet_tpu.scene.svg import make_tiger  # noqa: E402
from piet_tpu_torch.ops.coarse import DeviceScene, SegPre  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    Renderer, SceneCapacityError, device_scene_from_numpy, prepare_scene,
    render_slab)

SCENES = [
    ("tiger_1x", lambda: make_tiger(scale=1.0), (512, 512), 32),
    ("path_test", lambda: fixtures.get_scene("path_test"), (256, 256), 32),
    ("animated", lambda: fixtures.get_scene("animated", size=384),
     (384, 384), 32),
    ("gradients", lambda: fixtures.get_scene("gradients"), (256, 256), 16),
    ("holes", lambda: fixtures.get_scene("holes"), (256, 256), 16),
    ("star_evenodd", lambda: fixtures.get_scene("star_evenodd"), (256, 256),
     32),
    ("clip_star", lambda: fixtures.get_scene("clip_star"), (256, 256), 16),
]


@pytest.mark.parametrize("name,make,wh,th", SCENES,
                         ids=[s[0] for s in SCENES])
def test_cpu_render_bitwise_equals_oracle(name, make, wh, th):
    scene = make()
    r = Renderer.for_scene(scene, *wh, device="cpu", tile_height=th,
                           tile_width=128, fine_impl="entries")
    img = r.render(scene)
    assert img.shape == (wh[1], wh[0], 4) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, cpu_render_scene(scene, r.config),
                                  err_msg=name)
    assert r.last_stats["live_entries"] > 0


@pytest.mark.parametrize("row0", [0, 3, 5])
def test_cpu_slab_bitwise_equals_oracle_rows(row0):
    """render_slab over tile rows [row0, row0 + 3), with the segment stage
    built for that window, gives the oracle's rows of the full frame."""
    scene = fixtures.get_scene("clip_star")
    r = Renderer.for_scene(scene, 256, 256, device="cpu", tile_height=32,
                           tile_width=128, fine_impl="entries")
    cfg, rows = r.config, 3
    slab = dataclasses.replace(cfg, height=rows * cfg.tile_height)
    dev = prepare_scene(scene, cfg, "cpu")
    sp = build_seg_pre(scene, slab, row0=row0)
    dev = dev._replace(seg_pre=SegPre(*(
        torch.from_numpy(np.ascontiguousarray(getattr(sp, f)).view(np.int32))
        for f in SegPre._fields)))
    img, _ = render_slab(dev, cfg, tiles_y=rows, row0=row0,
                         fine_impl="entries")
    got = img.numpy().view(np.uint8).reshape(rows * cfg.tile_height, -1, 4)
    y0 = row0 * cfg.tile_height
    want = cpu_render_scene(scene, cfg)[y0:y0 + rows * cfg.tile_height]
    np.testing.assert_array_equal(got[:, :cfg.width], want)


@pytest.mark.parametrize("name", ["gradients", "holes"])
def test_cpu_render_matches_jax_interpret(name):
    scene = fixtures.get_scene(name)
    cfg = fit_capacities(scene, RenderConfig(
        width=256, height=256, tile_height=16, tile_width=128))
    want = jax_renderer.Renderer(cfg, fine_impl="pallas",
                                 interpret=True).render(scene)
    got = Renderer(cfg, device="cpu", fine_impl="entries").render(scene)
    assert_images_match(got, want, err_msg=name)


def _leaf_bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype.itemsize == 4 else x


def test_prepare_scene_equals_jax_staging():
    """The port's staging gives the JAX package's leaves bit for bit, and
    device_scene_from_numpy carries JAX leaves across unchanged."""
    scene = fixtures.get_scene("animated", size=256)
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256))
    jleaves = jax.tree.map(np.asarray, jax_renderer.prepare_scene(scene, cfg))
    mine = prepare_scene(scene, cfg, "cpu")
    carried = device_scene_from_numpy(jleaves, "cpu")
    for dev in (mine, carried):
        for f in DeviceScene._fields:
            if f == "seg_pre":
                continue
            np.testing.assert_array_equal(
                _leaf_bits(getattr(dev, f).numpy()),
                _leaf_bits(getattr(jleaves, f)), err_msg=f)
        for f in SegPre._fields:
            got = getattr(dev.seg_pre, f)
            assert got.dtype == torch.int32, f
            np.testing.assert_array_equal(
                got.numpy(), _leaf_bits(getattr(jleaves.seg_pre, f)),
                err_msg=f)


@pytest.mark.parametrize("field,match", [
    ("max_items", "max_items"), ("max_points", "max_points"),
    ("max_hits", "hit_overflow"), ("max_candidates", "cand_overflow"),
    ("max_segments", "seg_overflow")])
def test_too_small_capacity_raises(field, match):
    scene = make_tiger(scale=0.5)
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256))
    small = dataclasses.replace(cfg, **{field: 128})
    with pytest.raises(SceneCapacityError, match=match):
        Renderer(small, device="cpu", fine_impl="entries").render(scene)


def test_cuda_renderer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=128, height=128)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer.for_scene(fixtures.get_scene("path_test"), 128, 128,
                           device="cuda")
