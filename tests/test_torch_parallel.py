"""Row-slab rendering in the port (piet_tpu_torch/parallel/sharding.py)
against the JAX package's ShardedRenderer on the conftest's 8-device CPU
mesh.

Eight mesh positions on the CPU (``["cpu"] * 8``), each a slab with its
segments derived on the device at its ``row0``: every position's stats
equal JAX's; the image is within tests/_imgcmp.py's tolerance of JAX's
(XLA:CPU contracts multiply-adds) and bitwise equal to the numpy oracle
and to the port's one-slab frame.  The interleaved partition against the
contiguous one, both routes, and JAX's errors for a mesh that does not
divide the grid.
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
from piet_tpu.config import RenderConfig as JConfig  # noqa: E402
from piet_tpu.parallel import ShardedRenderer as JaxSharded  # noqa: E402
from piet_tpu.scene.fixtures import make_cardioid as jax_cardioid  # noqa
from piet_tpu.scene.svg import make_tiger as jax_tiger  # noqa: E402
from piet_tpu_torch import entry  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.parallel import (ShardedRenderer,  # noqa: E402
                                     make_sharded_render_fn)
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import Renderer  # noqa: E402
from piet_tpu_torch.scene.fixtures import make_cardioid  # noqa: E402
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402
from test_fuzz import random_scene  # noqa: E402

CFG_KW = dict(width=512, height=512, tile_height=16, tile_width=16,
              cmd_capacity=128, max_items=256, max_points=1024,
              max_segments=1024, max_hits=1 << 15, max_candidates=1 << 12,
              max_deltas=1 << 11)
TIGER_KW = dict(width=224, height=256, tile_height=16, tile_width=16,
                cmd_capacity=768, max_items=512, max_points=1 << 15,
                max_segments=1 << 15, max_hits=1 << 16,
                max_candidates=1 << 13, max_deltas=1 << 13)
CPU8 = ["cpu"] * 8


def _mesh(n=8):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} virtual cpu devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("y",))


def _cardioid(mod):
    return mod(center=(256.0, 256.0), r=200.0)


#: name -> (port scene, JAX scene, config keywords, interleave).
CASES = {
    "cardioid": (lambda: _cardioid(make_cardioid),
                 lambda: _cardioid(jax_cardioid), CFG_KW, 1),
    "cardioid interleave 2": (lambda: _cardioid(make_cardioid),
                              lambda: _cardioid(jax_cardioid), CFG_KW, 2),
    "tiger 1x": (lambda: make_tiger(scale=1.0),
                 lambda: jax_tiger(scale=1.0), TIGER_KW, 1),
}


def _assert_stats_equal(got, want):
    """Every per-position stat of the port's equals JAX's per device."""
    assert set(got) <= set(want), set(got) - set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]).reshape(-1),
                                      err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax_oracle_and_one_slab(name):
    make, jmake, kw, il = CASES[name]
    scene = make()
    cfg = RenderConfig(**kw)
    jr = JaxSharded(JConfig(**kw), _mesh(), fine_impl="xla", interleave=il)
    want = jr.render(jmake())
    r = ShardedRenderer(cfg, CPU8, fine_impl="dense", interleave=il)
    img = r.render(scene)
    assert img.shape == (cfg.height, cfg.width, 4) and img.dtype == np.uint8
    _assert_stats_equal(r.last_stats, jr.last_stats)
    assert_images_match(img, want, err_msg=name)
    np.testing.assert_array_equal(img, cpu_render_scene(scene, cfg))
    # The one-slab frame: capacities are per slab, so one slab needs the
    # whole viewport's records.
    whole = fit_capacities(scene, dataclasses.replace(cfg), bucket=True)
    np.testing.assert_array_equal(
        img, Renderer(whole, "cpu", fine_impl="dense").render(scene))


@pytest.mark.parametrize("impl", ["dense", "entries"])
def test_interleaved_matches_contiguous(impl):
    scene = _cardioid(make_cardioid)
    cfg = RenderConfig(**CFG_KW)
    contiguous = ShardedRenderer(cfg, CPU8, fine_impl=impl)
    balanced = ShardedRenderer(cfg, CPU8, fine_impl=impl, interleave=2)
    a, b = contiguous.render(scene), balanced.render(scene)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, cpu_render_scene(scene, cfg))
    assert int(balanced.last_stats["max_tile_cmds"].max()) == int(
        contiguous.last_stats["max_tile_cmds"].max())
    assert all(int(v.sum()) == 0 for k, v in balanced.last_stats.items()
               if k.endswith("overflow"))
    # Two positions on the card's shape of mesh: blocks 0, 2 and 1, 3.
    fn = make_sharded_render_fn(cfg, ["cpu"] * 2, impl, interleave=2)
    assert fn.blocks(0) == [0, 2] and fn.blocks(1) == [1, 3]


def test_fuzz_scene_sharded(monkeypatch):
    """One scene of tests/test_fuzz.py (seed 7) over the 8 positions, on
    the entries route with pairing, against the oracle."""
    from test_fuzz import SIZE
    scene = random_scene(7)
    cfg = fit_capacities(scene, RenderConfig(width=SIZE, height=SIZE,
                                             tile_height=16, tile_width=16))
    for impl, pair in (("dense", "off"), ("entries", "compact")):
        monkeypatch.setenv("PIET_PAIR", pair)
        r = ShardedRenderer(cfg, CPU8, fine_impl=impl)
        assert r._render._pair == pair
        np.testing.assert_array_equal(r.render(scene),
                                      cpu_render_scene(scene, cfg))


def test_sharded_fn_layout_and_one_step_per_device():
    """The step's image: the padded framebuffer (contiguous) or the
    position-major blocks (interleaved); per-position stats of shape (N,);
    one step per distinct device."""
    from piet_tpu_torch.renderer.renderer import prepare_scene
    scene = _cardioid(make_cardioid)
    # Four slabs hold twice the candidates of eight.
    cfg = dataclasses.replace(RenderConfig(**CFG_KW),
                              max_candidates=1 << 13)
    dev = prepare_scene(scene, cfg, "cpu", seg_pre=False)
    fn = make_sharded_render_fn(cfg, ["cpu"] * 4)
    img, stats = fn(dev)
    assert img.shape == (cfg.padded_height, cfg.padded_width)
    assert all(v.shape == (4,) for v in stats.values())
    assert not any(int(v.sum()) for k, v in stats.items()
                   if k.endswith("overflow"))
    assert fn.n_graphs() == 1
    fn2 = make_sharded_render_fn(cfg, ["cpu"] * 4, interleave=2)
    blocks, _ = fn2(dev)
    assert blocks.shape == (8, cfg.padded_height // 8, cfg.padded_width)
    # Block g of the frame is position g % 4's block g // 4.
    for g in range(8):
        k = (g % 4) * 2 + g // 4
        rows = slice(g * blocks.shape[1], (g + 1) * blocks.shape[1])
        assert torch.equal(blocks[k], img[rows])


@pytest.mark.parametrize("kw,match", [
    (dict(devices=["cpu"] * 3), "not divisible by mesh size 3"),
    (dict(devices=["cpu"] * 8, interleave=3),
     "rows-per-device 4 not divisible by interleave 3")])
def test_mesh_that_does_not_divide_raises_as_jax(kw, match):
    cfg = RenderConfig(**CFG_KW)
    with pytest.raises(ValueError, match=match):
        ShardedRenderer(cfg, **kw)
    n = len(kw["devices"])
    with pytest.raises(ValueError, match=match):
        JaxSharded(JConfig(**CFG_KW), _mesh(n),
                   interleave=kw.get("interleave", 1))


def test_capacity_is_per_slab_and_raises():
    scene = _cardioid(make_cardioid)
    cfg = dataclasses.replace(RenderConfig(**CFG_KW), max_hits=1024)
    from piet_tpu_torch.renderer.renderer import SceneCapacityError
    with pytest.raises(SceneCapacityError, match="hit_overflow"):
        ShardedRenderer(cfg, CPU8).render(scene)


def test_dryrun_multichip_on_the_cpu():
    entry.dryrun_multichip(8, device="cpu")
