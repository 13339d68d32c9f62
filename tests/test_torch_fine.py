"""Kernel D's plain version (piet_tpu_torch/ops/fine.py) against the JAX
package's ``fine_rasterize_entries`` in Pallas interpret mode.

Both sides interpret the same entry stream: the JAX coarse pass's output,
converted to the port's entry-major layout.  The images are held to the
shared CPU image policy (tests/_imgcmp.py: <= 2 codes on <= 1e-3 of the
pixels, for XLA:CPU's FMA contraction inside the interpreted kernel); the
port's own images are bitwise against the numpy oracle
(tests/test_torch_renderer.py).
"""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _imgcmp import assert_images_match  # noqa: E402
from piet_tpu.config import RenderConfig  # noqa: E402
from piet_tpu.ops.coarse import coarse_rasterize  # noqa: E402
from piet_tpu.ops.fine import fine_rasterize_entries as jax_fine  # noqa: E402
from piet_tpu.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu.renderer.renderer import (  # noqa: E402
    _solid_to_present_u32, prepare_scene)
from piet_tpu.scene import fixtures  # noqa: E402
from piet_tpu.scene.svg import make_tiger  # noqa: E402
from piet_tpu_torch.ops.coarse import stream_from_jax_layout  # noqa: E402
from piet_tpu_torch.ops.fine import fine_rasterize_entries  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


SCENES = [
    ("tiger_1x", lambda: make_tiger(scale=1.0), (256, 256), 32),
    ("animated", lambda: fixtures.get_scene("animated", size=256), (256, 256),
     32),
    ("gradients", lambda: fixtures.get_scene("gradients"), (256, 256), 16),
    ("holes", lambda: fixtures.get_scene("holes"), (256, 256), 16),
]


@pytest.mark.parametrize("name,make,wh,th", SCENES,
                         ids=[s[0] for s in SCENES])
def test_plain_fine_matches_jax_interpret(name, make, wh, th):
    scene = make()
    cfg = fit_capacities(scene, RenderConfig(
        width=wh[0], height=wh[1], tile_height=th, tile_width=128))
    ce = coarse_rasterize(
        prepare_scene(scene, cfg), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        cmd_capacity=cfg.cmd_capacity, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates,
        output="entries", sort_impl="xla", pair="off", hitfuse="off")
    present = _solid_to_present_u32(ce.solid)
    kw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              tiles_x=cfg.tiles_x)
    want = np.asarray(jax_fine(ce.first, ce.n_entries, present, ce.stream,
                               runs=True, paired=False, interpret=True, **kw))
    got = fine_rasterize_entries(
        _t(ce.first), _t(ce.n_entries),
        _t(np.asarray(present).view(np.int32)),
        stream_from_jax_layout(_t(ce.stream)), **kw).numpy()
    assert got.shape == want.shape
    assert int(np.asarray(ce.n_entries).sum()) > 0
    assert_images_match(
        np.ascontiguousarray(got).view(np.uint8).reshape(got.shape + (4,)),
        np.ascontiguousarray(want).view(np.uint8).reshape(want.shape + (4,)),
        err_msg=name)


def test_empty_tiles_write_the_present_colour():
    """n == 0: white for solid 0, else the present bytes as they are."""
    T, tw, th = 4, 128, 8
    solid = torch.tensor([0, 0x11223344, 0, -1], dtype=torch.int32)
    stream = torch.zeros((128, 16))
    zeros = torch.zeros(T, dtype=torch.int32)
    img = fine_rasterize_entries(zeros, zeros, solid, stream, tile_h=th,
                                 tile_w=tw, tiles_x=2)
    assert img.shape == (2 * th, 2 * tw)
    assert (img[:th, :tw] == -1).all()
    assert (img[:th, tw:] == 0x11223344).all()
    assert (img[th:, :tw] == -1).all() and (img[th:, tw:] == -1).all()
    # jnp agrees on the same empty stream.
    want = np.asarray(jax_fine(
        jnp.zeros(T, jnp.int32), jnp.zeros(T, jnp.int32),
        jnp.asarray(solid.numpy().view(np.uint32)),
        jnp.zeros((1, 16, 128), jnp.float32), tile_h=th, tile_w=tw,
        tiles_x=2, runs=False, paired=False, interpret=True))
    np.testing.assert_array_equal(img.numpy().view(np.uint32), want)
