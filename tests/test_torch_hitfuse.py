"""Kernels A and B's plain versions (piet_tpu_torch/ops/candfuse.py,
hitfuse.py) against the JAX wrappers in Pallas interpret mode, bitwise.

Inputs are the staged tiger at scale 1.0 on a 512^2 viewport with 16x128
tiles (the inputs of tests/test_hitfuse.py), staged once by the JAX
package and handed to both sides as the same numpy leaves.  Records are
compared in full: the live prefix word for word, and past the live total
the dead-record contract (candidates: all-zero rows; hits: all-zero words
with key = tile = +inf).  Kernel B's plain version is also held in both of
its key modes (packed, and the unpacked two-key sort's).
"""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.config import RenderConfig  # noqa: E402
from piet_tpu.ops.candfuse import cand_records_fused as jax_cand  # noqa: E402
from piet_tpu.ops.hitfuse import hit_records_fused as jax_hit  # noqa: E402
from piet_tpu.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu.renderer.renderer import prepare_scene  # noqa: E402
from piet_tpu.scene.svg import make_tiger  # noqa: E402
from piet_tpu_torch.ops.candfuse import (cand_prep,  # noqa: E402
                                         cand_records_fused)
from piet_tpu_torch.ops.hitfuse import (K_KEY, K_NCMDS,  # noqa: E402
                                        K_TILE, OUT_WORDS,
                                        hit_records_fused, split_fused)
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    device_scene_from_numpy)


@pytest.fixture(scope="module")
def staged():
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(
        width=512, height=512, tile_height=16, tile_width=128,
        cmd_capacity=512))
    leaves = jax.tree.map(np.asarray, prepare_scene(scene, cfg))
    return cfg, leaves, device_scene_from_numpy(leaves, "cpu")


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32) if x.dtype.kind == "f" else x


def test_cand_records_match_jax_interpret(staged):
    cfg, _, dev = staged
    ci = cand_prep(dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                   tile_w=cfg.tile_width, tile_h=cfg.tile_height)
    total = int(ci.total[0])
    assert 0 < total <= cfg.max_candidates
    got = cand_records_fused(*ci, 0, cfg.max_candidates, tiles_x=cfg.tiles_x)
    want = jax_cand(
        jax.lax.bitcast_convert_type(jnp.asarray(ci.cand_pack.numpy()),
                                     jnp.float32),
        jnp.asarray(ci.counts.numpy()), jnp.asarray(ci.excl.numpy()),
        jnp.int32(total), 0, cfg.max_candidates, tiles_x=cfg.tiles_x,
        interpret=True)
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0]))
    assert not _bits(got[0].numpy())[total:].any()      # dead rows zero
    for name, g, w in zip(("tile", "ty", "tx"), got[1:], want[1:]):
        np.testing.assert_array_equal(
            g.numpy()[:total], np.asarray(w)[:total].astype(np.int32),
            err_msg=name)


def test_hit_records_match_jax_interpret(staged):
    cfg, leaves, dev = staged
    sp = dev.seg_pre
    total = int(sp.n_hits[0])
    assert 0 < total <= cfg.max_hits
    kw = dict(tile_w=cfg.tile_width, tile_h=cfg.tile_height,
              tiles_x=cfg.tiles_x, stride=2 * (cfg.max_items + 1))
    got = split_fused(hit_records_fused(
        sp.seg_rows, sp.hit_counts, sp.hit_excl, sp.n_hits, 0, cfg.max_hits,
        **kw))
    jsp = leaves.seg_pre
    want = jax_hit(
        jax.lax.bitcast_convert_type(jnp.asarray(jsp.seg_rows), jnp.float32),
        jnp.asarray(jsp.hit_counts), jnp.asarray(jsp.hit_excl),
        jnp.int32(total), 0, cfg.max_hits, interpret=True, **kw)
    assert set(got) == set(want) | {"tile"}
    for name in want:
        np.testing.assert_array_equal(_bits(got[name].numpy()),
                                      _bits(want[name]), err_msg=name)
    dead_key = got["key"].numpy()[total:]
    assert np.isinf(dead_key).all()
    assert np.isinf(got["tile"].numpy()[total:]).all()
    assert not _bits(got["rows"].numpy())[total:].any()


def test_hit_records_key_modes(staged):
    """stride > 0: word 16 is the packed key tile * stride + item * 2;
    stride == 0: it is item * 2, the unpacked sort's second key.  Word 23
    (the tile, the unpacked sort's first key) and every other word are the
    same in both modes; both keys are +inf on records without commands."""
    cfg, _, dev = staged
    sp = dev.seg_pre
    stride = 2 * (cfg.max_items + 1)
    kw = dict(tile_w=cfg.tile_width, tile_h=cfg.tile_height,
              tiles_x=cfg.tiles_x)
    args = (sp.seg_rows, sp.hit_counts, sp.hit_excl, sp.n_hits, 0,
            cfg.max_hits)
    packed = hit_records_fused(*args, stride=stride, **kw)
    unpacked = hit_records_fused(*args, stride=0, **kw)
    others = [k for k in range(OUT_WORDS) if k != K_KEY]
    np.testing.assert_array_equal(_bits(packed[:, others].numpy()),
                                  _bits(unpacked[:, others].numpy()))
    tile = packed[:, K_TILE].numpy()
    live = np.isfinite(tile)
    assert live.sum() > 0
    assert (packed[:, K_NCMDS].numpy()[live] > 0).all()
    assert not (packed[:, K_NCMDS].numpy()[~live] > 0).any()
    pk, uk = packed[:, K_KEY].numpy(), unpacked[:, K_KEY].numpy()
    assert np.isinf(pk[~live]).all() and np.isinf(uk[~live]).all()
    t = tile[live].astype(np.int64)
    np.testing.assert_array_equal(pk[live].astype(np.int64),
                                  t * stride + uk[live].astype(np.int64))
    assert (uk[live] < stride).all() and (t < cfg.tiles_x * cfg.tiles_y).all()
