"""Device affine animation (piet_tpu_torch/scene/affine.py) against the JAX
package's, and its frames against the numpy oracle.

``transform_device_scene`` is multiplies, adds, one division and one
sqrt, each rounded on its own: given the same numpy ``mats`` it equals
JAX's on the CPU bitwise, under ``jax.jit`` as well as op by op (XLA:CPU
contracts none of these products into FMAs).  ``rotation_about`` goes
through ``cos``/``sin``, which differ by up to 1 ulp between the two
libraries; its translation words compound that, so the matrices are
compared within 8 ulp.  ``host_transform_scene`` is numpy on both sides
and compared bitwise.  Frames hold the exactness contract of
tests/test_affine.py: the image rendered from the device-computed arrays
equals the numpy oracle fed those arrays, bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.renderer.renderer import prepare_scene as jax_prepare  # noqa
from piet_tpu.scene import affine as jaffine  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    device_scene_from_numpy, fetch_scene, prepare_scene)
from piet_tpu_torch.scene import affine, fixtures  # noqa: E402
from piet_tpu_torch.scene.scene import SceneBuilder  # noqa: E402

SIZE = 256


def _demo_scene():
    b = SceneBuilder()
    b.fill([(30.0, 40.0), (200.0, 60.0), (120.0, 220.0)], 0xCC2200FF)
    b.polyline([(20.0, 20.0), (236.0, 20.0), (236.0, 236.0),
                (20.0, 236.0), (20.0, 20.0)], 0x003399FF, width=5.0)
    b.fill([(60.0, 140.0), (180.0, 120.0), (210.0, 200.0),
            (90.0, 230.0)], 0x22AA44A0)
    b.circle(128.0, 128.0, 30.0)
    return b.build()


def _cfg(scene):
    cfg = fit_capacities(scene, RenderConfig(
        width=SIZE, height=SIZE, tile_height=16, tile_width=128),
        bucket=True)
    # Transformed frames change record counts; leave generous room.
    return dataclasses.replace(cfg, max_hits=8 * cfg.max_hits,
                               max_candidates=8 * cfg.max_candidates)


SCENES = {"demo": _demo_scene,
          "gradients": lambda: fixtures.get_scene("gradients", size=SIZE),
          "clipped_demo": lambda: fixtures.get_scene("clipped_demo")}


def _mats(kind, n_items):
    if kind == "identity":
        return affine.identity_mats(n_items)
    if kind == "global":
        return np.asarray(jaffine.rotation_about(
            128.0, 128.0, jnp.float32(0.35), 0.8))
    rng = np.random.default_rng(1)                   # per-item affines
    m = rng.uniform(-1.5, 1.5, (n_items, 6)).astype(np.float32)
    m[:, 4:] = rng.uniform(-40, 40, (n_items, 2))
    return m


@pytest.mark.parametrize("kind", ["identity", "global", "per_item"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_transform_matches_jax_bitwise(name, kind):
    scene = SCENES[name]()
    cfg = _cfg(scene)
    mats = _mats(kind, cfg.max_items)
    jbase = jax_prepare(scene, cfg, seg_pre=False)
    jab = jaffine.build_base(scene, cfg)
    want = jax.jit(lambda: jaffine.transform_device_scene(jbase, jab,
                                                          mats))()
    base = device_scene_from_numpy(jax.tree.map(np.asarray, jbase), "cpu")
    got = affine.transform_device_scene(
        base, affine.build_base(scene, cfg, "cpu"), mats)
    assert got.seg_pre is None
    for f in ("points", "bboxes", "clips", "grads"):
        np.testing.assert_array_equal(
            np.ascontiguousarray(getattr(got, f).numpy()).view(np.uint32),
            np.ascontiguousarray(np.asarray(getattr(want, f))).view(
                np.uint32), err_msg=f"{name}/{kind}: {f}")


def test_build_base_matches_jax():
    scene = _demo_scene()
    cfg = _cfg(scene)
    got = affine.build_base(scene, cfg, "cpu")
    want = jaffine.build_base(scene, cfg)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("t", [0.0, 0.7, 1.1, 3.9])
def test_rotation_about_matches_jax(t):
    got = affine.rotation_about(832.0, 832.0, torch.tensor(t), 1.15).numpy()
    want = np.asarray(jaffine.rotation_about(832.0, 832.0, jnp.float32(t),
                                             1.15))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 8, ulps


def test_host_transform_scene_matches_jax():
    m = np.asarray(jaffine.rotation_about(128.0, 128.0, jnp.float32(0.5),
                                          0.9))
    got = affine.host_transform_scene(_demo_scene(), m)
    want = jaffine.host_transform_scene(_demo_scene(), m)
    np.testing.assert_array_equal(got.points.view(np.uint32),
                                  want.points.view(np.uint32))
    np.testing.assert_array_equal(got.bboxes, want.bboxes)


def test_identity_transform_preserves_geometry():
    scene = fixtures.get_scene("gradients", size=SIZE)
    cfg = _cfg(scene)
    base = prepare_scene(scene, cfg, "cpu", seg_pre=False)
    dev = affine.transform_device_scene(
        base, affine.build_base(scene, cfg, "cpu"),
        affine.identity_mats(cfg.max_items))
    n = scene.n_items
    np.testing.assert_array_equal(dev.points[:scene.n_points].numpy(),
                                  scene.points)
    assert (np.abs(dev.bboxes[:n].numpy() - scene.bboxes) <= 1).all()
    np.testing.assert_array_equal(dev.clips[:n].numpy(), scene.clips)
    np.testing.assert_array_equal(dev.grads[:n].numpy(), scene.grads)


@pytest.mark.parametrize("name,t", [("demo", 0.35), ("demo", 1.1),
                                    ("gradients", 0.5),
                                    ("clipped_demo", 0.9)])
def test_frame_bitwise_equals_oracle(name, t):
    scene = SCENES[name]()
    cfg = _cfg(scene)
    render_t = affine.make_affine_render_fn(
        cfg, scene, lambda tt: affine.rotation_about(128.0, 128.0, tt, 0.8),
        device="cpu", fine_impl="entries")
    img, stats = render_t(t)
    assert int(stats["hit_overflow"]) == int(stats["cand_overflow"]) == 0
    got = img.numpy().view(np.uint8).reshape(SIZE, SIZE, 4)
    frame = fetch_scene(render_t.scene_at(t), scene.n_items, scene.n_points)
    np.testing.assert_array_equal(got, cpu_render_scene(frame, cfg))


def test_render_fn_deterministic_and_moving():
    scene = _demo_scene()
    render_t = affine.make_affine_render_fn(
        _cfg(scene), scene,
        lambda t: affine.rotation_about(128.0, 128.0, t, 1.0), device="cpu",
        fine_impl="entries")
    a1, _ = render_t(0.25)
    a2, _ = render_t(0.25)
    b, _ = render_t(0.5)
    assert torch.equal(a1, a2)
    assert not torch.equal(a1, b)

