"""The port's dense PTCL interpreters on the CPU against the JAX package's
and the numpy oracle: ``fine_rasterize`` (piet_tpu_torch/ops/fine.py, the
counterpart of the TPU kernel ``_fine_kernel``) and ``fine_rasterize_xla``
(ops/fine_xla.py), through their plain versions.

The JAX kernels run as the JAX package's own tests run them: the Pallas
kernel in interpret mode, the XLA interpreter jitted, both through
XLA:CPU, which may contract products into FMAs, so those images are held
to the tests/_imgcmp.py policy.  The port's plain interpreters round every
operation on their own and are held bitwise to the oracle's
``cpu_render_ptcl`` off bailed tiles (the present composite owns those).
The PTCLs are the oracle's own (``cpu_tile_scene``), and synthetic ones
(``raster/synth_ptcl.py``) that put group commands and command streaks
where the CUDA kernel changes course (slots 0, 31, 32, 127, 128 and
across the 128-command chunk), a count above the capacity and a zero
count, at tile widths 16, 24 and 128.
"""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from _imgcmp import assert_images_match  # noqa: E402
from piet_tpu.ops.fine import fine_rasterize as jax_fine  # noqa: E402
from piet_tpu.ops.fine_xla import \
    fine_rasterize_xla as jax_fine_xla  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.ops.fine import fine_rasterize_plain  # noqa: E402
from piet_tpu_torch.ops.fine_xla import \
    fine_rasterize_xla_plain  # noqa: E402
from piet_tpu_torch.raster.cpu_fine import cpu_render_ptcl  # noqa: E402
from piet_tpu_torch.raster.cpu_tiler import cpu_tile_scene  # noqa: E402
from piet_tpu_torch.raster.ptcl import ARG_WORDS, CMD_BEGIN_CLIP  # noqa
from piet_tpu_torch.raster.synth_ptcl import synth_dense_ptcl  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.scene import fixtures  # noqa: E402
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402

GROUP_SCENES = [
    ("clip_star", fixtures.make_clip_star),
    ("gradient_demo", fixtures.make_gradient_demo),
    ("holes_demo", fixtures.make_holes_demo),
]


FINE_CASES = [
    ("path_test", fixtures.make_path_test,
     dict(width=320, height=832, tile_height=16, tile_width=16,
          cmd_capacity=128)),
    ("cardioid", lambda: fixtures.make_cardioid(center=(256.0, 256.0),
                                                r=200.0),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=128)),
    ("tiger_1x", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=16,
          cmd_capacity=768)),
    ("tiger_1x_tpu_tiles", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=128,
          cmd_capacity=2688)),
]


def _oracle_ptcl(scene, cfg):
    """The oracle's PTCL and image, and the fine arguments built from it."""
    ptcl = cpu_tile_scene(scene, cfg)
    counts = ptcl.counts.reshape(cfg.tiles_y, cfg.tiles_x)
    args = ptcl.args.reshape(ptcl.n_tiles, -1)
    kw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              cmd_capacity=cfg.cmd_capacity)
    return ptcl, (counts, ptcl.tags, args), kw


def _img(u32, cfg):
    img = np.ascontiguousarray(np.asarray(u32)).view(np.uint8).reshape(
        cfg.padded_height, cfg.padded_width, 4)
    return img[:cfg.height, :cfg.width].copy()


def _bail_px(ptcl, cfg):
    solid = ptcl.solid.reshape(cfg.tiles_y, cfg.tiles_x) != 0
    return np.repeat(np.repeat(solid, cfg.tile_height, 0), cfg.tile_width,
                     1)[:cfg.height, :cfg.width]


@pytest.mark.parametrize("name,make,cfg_kw", FINE_CASES,
                         ids=[c[0] for c in FINE_CASES])
def test_fine_plain_matches_jax_and_oracle(name, make, cfg_kw):
    """fine_rasterize_plain vs JAX's Pallas kernel in interpret mode
    (path_test, cardioid) or its jitted XLA interpreter (the tigers, where
    the interpreter is slow), and bitwise vs the oracle off bailed tiles;
    the group interpreter computes the same pixels on these tags."""
    cfg = RenderConfig(**cfg_kw)
    ptcl, args, kw = _oracle_ptcl(make(), cfg)
    got = fine_rasterize_plain(*(torch.from_numpy(a) for a in args), **kw)
    if name.startswith("tiger"):
        want = jax_fine_xla(*args, **kw)
    else:
        want = jax_fine(*args, **kw, interpret=True)
    bail = _bail_px(ptcl, cfg)
    img = _img(got.numpy(), cfg)
    img[bail] = 0
    jimg = _img(want, cfg)
    jimg[bail] = 0
    gold = cpu_render_ptcl(ptcl, cfg)
    gold[bail] = 0
    assert_images_match(img, jimg, err_msg=name)
    np.testing.assert_array_equal(img, gold, err_msg=name)
    if not name.startswith("tiger"):    # (the tigers' take seconds each)
        assert torch.equal(got, fine_rasterize_xla_plain(
            *(torch.from_numpy(a) for a in args), **kw))


def test_fine_unknown_tag_paints_magenta():
    """A group tag reaching the non-group interpreter paints the
    reference's debug magenta, as JAX's kernel does; tag 9 is a no-op."""
    T, cap = 2, 128
    tags = np.zeros((T, cap), np.int32)
    args = np.zeros((T, cap * ARG_WORDS), np.float32)
    tags[0, :2] = [9, CMD_BEGIN_CLIP]
    tags[1, 0] = 9
    counts = np.array([[2, 1]], np.int32)
    kw = dict(tile_h=16, tile_w=128, cmd_capacity=cap)
    want = np.asarray(jax_fine(counts, tags, args, **kw, interpret=True))
    got = fine_rasterize_plain(torch.from_numpy(counts),
                               torch.from_numpy(tags),
                               torch.from_numpy(args), **kw).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    px = got.view(np.uint32)
    assert (px[:, :128] == 0xFFFF00FF).all()     # magenta, alpha 0xFF
    assert (px[:, 128:] == 0xFFFFFFFF).all()     # white


@pytest.mark.parametrize("name,make", GROUP_SCENES,
                         ids=[s[0] for s in GROUP_SCENES])
def test_fine_xla_plain_matches_jax_and_oracle(name, make):
    scene = make(256)
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256,
                                             tile_height=16, tile_width=128))
    ptcl, args, kw = _oracle_ptcl(scene, cfg)
    tags = ptcl.tags[ptcl.tags != 0]
    assert (tags >= CMD_BEGIN_CLIP).any()
    got = fine_rasterize_xla_plain(*(torch.from_numpy(a) for a in args),
                                   **kw)
    bail = _bail_px(ptcl, cfg)
    img = _img(got.numpy(), cfg)
    img[bail] = 0
    jimg = _img(jax_fine_xla(*args, **kw), cfg)
    jimg[bail] = 0
    gold = cpu_render_ptcl(ptcl, cfg)
    gold[bail] = 0
    assert_images_match(img, jimg, err_msg=name)
    np.testing.assert_array_equal(img, gold, err_msg=name)


SYNTH_WIDTHS = [16, 24, 128]


def _synth(tile_w, groups):
    cap = 256
    counts, tags, args = synth_dense_ptcl(tile_w, tile_w=tile_w, tile_h=16,
                                          cap=cap, groups=groups)
    kw = dict(tile_h=16, tile_w=tile_w, cmd_capacity=cap)
    return (counts, tags, args), kw


def _u8(u32):
    """Packed RGBA8 words as (height, width, 4) bytes."""
    u32 = np.ascontiguousarray(np.asarray(u32))
    return u32.view(np.uint8).reshape(*u32.shape, 4)


@pytest.mark.parametrize("tile_w", SYNTH_WIDTHS)
def test_dense_plain_group_map_matches_jax_on_synthetic_ptcl(tile_w):
    """The group interpreter's plain version against JAX's jitted
    fine_rasterize_xla on a synthetic PTCL: group commands first at slots
    0, 31, 32, 127 and 128, streaks across the chunk boundary, a count
    above the capacity (JAX reads the no-op in the last slot again) and a
    zero count."""
    args, kw = _synth(tile_w, groups=True)
    assert (args[1] >= CMD_BEGIN_CLIP).any()
    got = fine_rasterize_xla_plain(*(torch.from_numpy(a) for a in args),
                                   **kw).numpy()
    want = np.asarray(jax.jit(jax_fine_xla, static_argnames=(
        "tile_h", "tile_w", "cmd_capacity"))(*args, **kw))
    assert got.shape == want.shape == (32, 3 * tile_w)
    assert_images_match(_u8(got), _u8(want), err_msg=f"tile_w {tile_w}")
    # The empty tile stays white.
    assert (got.view(np.uint32)[16:, 2 * tile_w:] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("tile_w", SYNTH_WIDTHS)
def test_dense_plain_core_map_matches_jax_on_synthetic_ptcl(tile_w):
    """_fine_kernel's tag map on a synthetic PTCL without group commands:
    the plain version against JAX's Pallas kernel in interpret mode (counts
    clamped to the capacity there: its chunk loop reads past the row
    otherwise) and its jitted XLA interpreter; both plain instantiations
    give the same pixels on these tags."""
    args, kw = _synth(tile_w, groups=False)
    counts, tags, words = args
    t_args = tuple(torch.from_numpy(a) for a in args)
    got = fine_rasterize_plain(*t_args, **kw).numpy()
    want = np.asarray(jax_fine(np.minimum(counts, kw["cmd_capacity"]), tags,
                               words, **kw, interpret=True))
    assert_images_match(_u8(got), _u8(want), err_msg=f"tile_w {tile_w}")
    want_xla = np.asarray(jax.jit(jax_fine_xla, static_argnames=(
        "tile_h", "tile_w", "cmd_capacity"))(*args, **kw))
    assert_images_match(_u8(got), _u8(want_xla), err_msg=f"tile_w {tile_w}")
    assert torch.equal(torch.from_numpy(got),
                       fine_rasterize_xla_plain(*t_args, **kw))
