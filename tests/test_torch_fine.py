"""Kernel D's plain version (piet_tpu_torch/ops/fine.py) against the JAX
package's ``fine_rasterize_entries`` in Pallas interpret mode.

Both sides interpret the same entry stream: the JAX coarse pass's output,
converted to the port's entry-major layout.  The images are held to the
shared CPU image policy (tests/_imgcmp.py: <= 2 codes on <= 1e-3 of the
pixels, for XLA:CPU's FMA contraction inside the interpreted kernel); the
port's own images are bitwise against the numpy oracle
(tests/test_torch_renderer.py).  The synthetic streams of
raster/synth_entries.py (unpaired, compact and hole, of the same
commands) go through both as well, and the plain version's images of
them are bitwise against each other and the numpy oracle.
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
from piet_tpu_torch.layout.entry_stream import (  # noqa: E402
    W_RUN, W_S0_TAG, W_S1_TAG)
from piet_tpu_torch.ops.coarse import (  # noqa: E402
    stream_from_jax_layout, stream_to_jax_layout)
from piet_tpu_torch.ops.fine import fine_rasterize_entries  # noqa: E402
from piet_tpu_torch.raster.ptcl import (  # noqa: E402
    CMD_BEGIN_CLIP, CMD_FILL, CMD_FILL_EDGE, CMD_LINE)
from piet_tpu_torch.raster.synth_entries import (  # noqa: E402
    synth_entry_streams)


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


# ---- synthetic paired streams (raster/synth_entries.py) -------------------

SYNTH = [(0, 128), (1, 16)]  # seed, tile width


def _synth_image(s, mode):
    st = s.streams[mode]
    img = fine_rasterize_entries(
        _t(st.first), _t(st.n_entries),
        torch.zeros(st.first.shape, dtype=torch.int32), _t(st.stream),
        tile_h=s.tile_h, tile_w=s.tile_w, tiles_x=s.tiles_x,
        paired=mode != "off")
    return np.ascontiguousarray(img.numpy()).view(np.uint8).reshape(
        s.oracle.shape)


@pytest.mark.parametrize("seed,tw", SYNTH)
def test_plain_synthetic_streams_equal_oracle(seed, tw):
    """The plain version on the three streams of the same commands: each
    paired image (compact, hole) bitwise equal to the unpaired image and
    to the numpy oracle of the command lists."""
    s = synth_entry_streams(seed, tile_w=tw)
    unpaired = _synth_image(s, "off")
    np.testing.assert_array_equal(unpaired, s.oracle)
    assert len(np.unique(unpaired.reshape(-1, 4), axis=0)) > 50
    for mode in ("compact", "hole"):
        np.testing.assert_array_equal(_synth_image(s, mode), unpaired,
                                      err_msg=mode)


def _classes(rows):
    t0, t1 = rows[:, W_S0_TAG], rows[:, W_S1_TAG]
    hole = (t0 == 0) & (t1 == 0)
    f1, f2 = (t0 == 0) & (t1 == CMD_FILL), (t0 == CMD_FILL) & (t1 == CMD_FILL)
    l1, l2 = (t0 == CMD_LINE) & (t1 == 0), (t0 == CMD_LINE) & (t1 == CMD_LINE)
    return hole, f1, f2, l1, l2


def _crosses_chunk(cls, lo, hi):
    """A streak of ``cls`` entries in [lo, hi) across a 32-entry chunk
    boundary of the tile (kernel D stages 32 entries at a time)."""
    return any(cls[lo + b - 1] and cls[lo + b] for b in range(32, hi - lo, 32))


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_streams_cover_the_paired_cases(seed):
    """The synthetic streams hold the cases the paired instantiation must
    get right: F2 / F1 and L2 / L1 streaks across the chunk boundary, a
    fill edge with a slot-1 fill between two fill streaks, a begin clip
    right after a paired streak, holes inside and at the ends of streaks
    and a tile of holes only."""
    s = synth_entry_streams(seed, tile_w=128)
    off = s.streams["off"]
    assert (off.stream[:, W_RUN] != 0).any()
    for mode in ("compact", "hole"):
        st = s.streams[mode]
        rows = st.stream
        assert rows.shape[0] % 128 == 0 and not rows[:, W_RUN].any()
        hole, f1, f2, l1, l2 = _classes(rows)
        assert f1.any() and f2.any() and l1.any() and l2.any()
        lo, hi = int(st.first[0]), int(st.first[0] + st.n_entries[0])
        assert _crosses_chunk(f2 | (f1 | hole), lo, hi)
        assert _crosses_chunk(l2 | (l1 | hole), lo, hi)
        # F2 / F1 of two paths back to back (past the F2's hole).
        nxt = 2 if mode == "hole" else 1
        assert (f2[lo:hi - nxt] & f1[lo + nxt:hi]).any()
        # Tile 1: an edge with its fill between two fill streaks, and the
        # first begin clip right after a paired fill streak.
        lo, hi = int(st.first[1]), int(st.first[1] + st.n_entries[1])
        t0 = rows[lo:hi, W_S0_TAG]
        edge = np.flatnonzero((t0 == CMD_FILL_EDGE)
                              & (rows[lo:hi, W_S1_TAG] == CMD_FILL))
        fill = (f1 | f2)[lo:hi]
        assert any(fill[e - 1] and fill[e + 1] for e in edge)
        clip = int(np.flatnonzero(t0 == CMD_BEGIN_CLIP)[0])
        assert f2[lo + clip - 1] or (mode == "hole" and hole[lo + clip - 1]
                                     and f2[lo + clip - 2])
        if mode == "hole":
            assert hole[lo] and hole[lo + 1]        # at the start of a tile
            assert (hole[:-1] & f2[1:]).any()       # inside a streak
            t4 = int(st.first[4] + st.n_entries[4])
            assert hole[t4 - 3:t4].all()            # at the end of a tile
            assert st.n_entries[2] == 5 and hole[
                st.first[2]:st.first[2] + 5].all()  # only holes
        else:
            assert st.n_entries[2] == 0 and not hole[:hi].any()


@pytest.mark.parametrize("mode", ["off", "compact", "hole"])
def test_plain_synthetic_streams_match_jax_interpret(mode):
    """The synthetic streams through JAX's kernel D in Pallas interpret
    mode (run dispatch on the unpaired stream, the paired branch on the
    others) and the port's plain version, under the CPU image policy."""
    s = synth_entry_streams(0, tile_w=128)
    st = s.streams[mode]
    want = np.asarray(jax_fine(
        jnp.asarray(st.first), jnp.asarray(st.n_entries),
        jnp.zeros(st.first.shape, jnp.uint32),
        jnp.asarray(stream_to_jax_layout(_t(st.stream)).numpy()),
        tile_h=s.tile_h, tile_w=s.tile_w, tiles_x=s.tiles_x,
        paired=mode != "off", runs=mode == "off", interpret=True))
    assert_images_match(
        _synth_image(s, mode),
        np.ascontiguousarray(want).view(np.uint8).reshape(want.shape + (4,)),
        err_msg=mode)
