"""Entry pairing in the port (piet_tpu_torch/ops/pairing.py, the coarse
pass's ``pair=``, kernel D's paired branch) against the JAX package.

The same inputs go through both: ``pair_entries`` on a seeded synthetic
stream, and ``coarse_rasterize(pair=...)`` on the cases of
tests/test_pairing.py, word for word in both modes (the JAX pass eager,
on its staged record route).  The paired images from kernel D's plain
version are held bitwise against the numpy oracle and the unpaired image.
The compaction's plain version is held against the expansion with 0/1
counts and against the JAX package's compaction on its edge cases.
"""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
jnp = jax.numpy

from piet_tpu.ops import pairing as jpairing  # noqa: E402
from piet_tpu.ops.coarse import coarse_rasterize as jax_coarse  # noqa: E402
from piet_tpu.renderer.renderer import prepare_scene  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.layout.entry_stream import (  # noqa: E402
    ENTRY_WORDS, W_META, W_S0_TAG, W_S1_TAG)
from piet_tpu_torch.ops import pairing  # noqa: E402
from piet_tpu_torch.ops.coarse import (coarse_rasterize,  # noqa: E402
                                       stream_to_jax_layout)
from piet_tpu_torch.ops.expand import expand_rows  # noqa: E402
from piet_tpu_torch.ops.fine import fine_rasterize_entries  # noqa: E402
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu_torch.raster.ptcl import (CMD_FILL, CMD_FILL_EDGE,  # noqa: E402
                                        CMD_LINE, CMD_SOLID)
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    Renderer, _solid_to_present_u32, device_scene_from_numpy)
from test_pairing import CASES  # noqa: E402

LEAVES = ("stream", "first", "n_entries", "counts", "solid")


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32) if x.dtype.kind == "f" else x.astype(np.int64)


@pytest.mark.parametrize("value,want", [(None, "off"), ("0", "off"),
                                        ("1", "compact"), ("hole", "hole"),
                                        ("compact", "compact")])
def test_pair_mode_from_env_is_jax_s(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("PIET_PAIR", raising=False)
    else:
        monkeypatch.setenv("PIET_PAIR", value)
    assert pairing.pair_mode_from_env() == jpairing.pair_mode_from_env() \
        == want


def _synth_stream(seed: int, E: int = 1024, n_tiles: int = 12):
    """A sorted entry stream with long pairable runs: plain fills and
    lines of a few (tile, item) groups, broken by edges and solids, with
    a dead tail; random operand words (NaN and -0.0 patterns included)."""
    rng = np.random.default_rng(seed)
    n_live = E - 100
    tile = np.sort(rng.integers(0, n_tiles, n_live))
    item = np.sort(rng.integers(0, 6, n_live))
    key = (tile * 64 + item * 2 + rng.integers(0, 2, n_live)).astype(
        np.float32)
    key = np.sort(key)
    rows = rng.standard_normal((E, ENTRY_WORDS)).astype(np.float32)
    rows.view(np.uint32)[:, 3][::17] = 0x7FC00001
    rows[::13, 5] = -0.0
    cls = rng.choice(4, n_live, p=[0.45, 0.35, 0.1, 0.1])
    tag0 = np.select([cls == 0, cls == 1, cls == 2, cls == 3],
                     [0.0, CMD_LINE, CMD_FILL_EDGE, CMD_SOLID])
    tag1 = np.where((cls == 0) | (cls == 2), float(CMD_FILL), 0.0)
    rows[:n_live, W_S0_TAG] = tag0
    rows[:n_live, W_S1_TAG] = tag1
    meta = 1 + (cls == 3) * 4 + (cls == 1) * 8
    rows[:n_live, W_META] = meta
    rows[n_live:] = 0.0
    keys = np.concatenate([key, np.full(E - n_live, np.inf, np.float32)])
    live = np.arange(E) < n_live
    e_tile = np.concatenate([tile, np.full(E - n_live, n_tiles)]).astype(
        np.int32)
    e_ncmds = np.where(live, 1, 0).astype(np.int32)
    opaque = live & (np.concatenate([cls, np.zeros(E - n_live, int)]) == 3)
    clear = live & (np.concatenate([cls, np.zeros(E - n_live, int)]) == 1)
    return rows, keys, live, e_tile, e_ncmds, opaque, clear, n_tiles


@pytest.mark.parametrize("mode", ["compact", "hole"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_entries_matches_jax(mode, seed):
    rows, keys, live, e_tile, e_ncmds, opq, clr, n_tiles = _synth_stream(
        seed)
    want = jpairing.pair_entries(
        jnp.asarray(rows), (jnp.asarray(keys),), jnp.asarray(live),
        jnp.asarray(e_tile), jnp.asarray(e_ncmds), jnp.asarray(opq),
        jnp.asarray(clr), n_tiles, expand_impl="xla", mode=mode)
    t = torch.from_numpy
    got = pairing.pair_entries(
        t(rows.view(np.int32).copy()), (t(keys),), t(live), t(e_tile),
        t(e_ncmds), t(opq), t(clr), n_tiles, mode=mode)
    np.testing.assert_array_equal(got.rows.numpy().view(np.uint32),
                                  _bits(want.rows))
    for f in ("live", "e_tile", "e_ncmds", "e_is_opaque", "e_is_clear"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    merged = int((got.e_ncmds == 2).sum())
    assert merged > 50, merged
    if mode == "compact":
        assert int(got.live.sum()) == int(live.sum()) - merged


def test_compaction_routes_agree():
    """The compaction's plain version (the scatter and gather) equals the
    expansion with 0/1 counts (expand_rows, as the TPU package ran it),
    and compact_rows on the CPU is the plain version, with the total."""
    rows, keys, live, *_ = _synth_stream(2)
    keep = torch.from_numpy(live) & (torch.rand(live.shape[0],
                                                generator=torch.Generator()
                                                .manual_seed(2)) < 0.6)
    bundle = torch.from_numpy(rows.view(np.int32).copy())
    a, total = pairing.compact_rows_plain(bundle, keep)
    b = expand_rows(bundle, keep.to(torch.int32), bundle.shape[0])
    assert torch.equal(a, b)
    got, got_total = pairing.compact_rows(bundle, keep)
    assert torch.equal(got, a) and torch.equal(got_total, total)
    n = int(keep.sum())
    assert total.dtype == torch.int32 and total.shape == () and total == n
    assert torch.equal(a[:n], bundle[keep]) and not a[n:].any()


#: Compaction edge cases: which rows are kept, and E (the kernel's blocks
#: are 512 rows: 1100 and 1537 end in a ragged block).
COMPACT_CASES = [("all kept", 1100), ("none kept", 1100),
                 ("last kept", 1100), ("all kept", 1024), ("random", 1537)]


def _keep_case(case, E, rng):
    if case == "all kept":
        return np.ones(E, bool)
    if case == "none kept":
        return np.zeros(E, bool)
    if case == "last kept":
        return np.arange(E) == E - 1
    return rng.uniform(size=E) < 0.4


@pytest.mark.parametrize("expand_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case,E", COMPACT_CASES,
                         ids=[f"{c}-{e}" for c, e in COMPACT_CASES])
def test_compact_rows_plain_matches_jax(case, E, expand_impl):
    """compact_rows_plain against the JAX package's compaction: its
    pair_entries on rows that nothing pairs (tail commands), so that it
    keeps exactly its live rows, through the scatter and gather and
    through its expand engine in interpret mode."""
    rng = np.random.default_rng(E)
    n_tiles = 9
    rows = rng.standard_normal((E, ENTRY_WORDS)).astype(np.float32)
    rows.view(np.uint32)[::11, 3] = 0x7FC00001
    rows[::13, 5] = -0.0
    rows[:, W_S0_TAG] = CMD_SOLID
    rows[:, W_S1_TAG] = 0.25
    keep = _keep_case(case, E, rng)
    e_tile = np.sort(rng.integers(0, n_tiles, E)).astype(np.int32)
    ncmds = rng.integers(1, 3, E).astype(np.int32)
    opq, clr = rng.uniform(size=E) < 0.3, rng.uniform(size=E) < 0.5
    want = jpairing.pair_entries(
        jnp.asarray(rows), (jnp.asarray(np.arange(E, dtype=np.float32)),),
        jnp.asarray(keep), jnp.asarray(e_tile), jnp.asarray(ncmds),
        jnp.asarray(opq), jnp.asarray(clr), n_tiles,
        expand_impl=expand_impl, mode="compact")
    cols = [torch.from_numpy(c.astype(np.int32))[:, None]
            for c in (e_tile, ncmds, opq, clr)]
    bundle = torch.cat([torch.from_numpy(rows.view(np.int32).copy())]
                       + cols, dim=1)
    got, total = pairing.compact_rows_plain(bundle, torch.from_numpy(keep))
    n = int(keep.sum())
    assert total.dtype == torch.int32 and int(total) == n
    np.testing.assert_array_equal(np.asarray(want.live), np.arange(E) < n)
    np.testing.assert_array_equal(got[:, :ENTRY_WORDS].numpy().view(
        np.uint32), _bits(want.rows))
    live = np.arange(E) < n
    np.testing.assert_array_equal(
        np.where(live, got[:, ENTRY_WORDS].numpy(), n_tiles),
        np.asarray(want.e_tile))
    for j, f in ((1, "e_ncmds"), (2, "e_is_opaque"), (3, "e_is_clear")):
        np.testing.assert_array_equal(
            got[:, ENTRY_WORDS + j].numpy().astype(
                np.asarray(getattr(want, f)).dtype),
            np.asarray(getattr(want, f)), f)
    assert not got[n:].any()


def _kw(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates)


@pytest.mark.parametrize("mode", ["compact", "hole"])
@pytest.mark.parametrize("name,make,cfg_kw", CASES,
                         ids=[c[0] for c in CASES])
def test_coarse_paired_matches_jax(name, make, cfg_kw, mode):
    """coarse_rasterize(pair=mode) word for word against JAX's (its
    W_RUN words left as the rows carry them), and the paired image from
    kernel D's plain version bitwise against the oracle and the unpaired
    image."""
    cfg = RenderConfig(**cfg_kw)
    scene = make()
    jdev = prepare_scene(scene, cfg)
    want = jax_coarse(jdev, cmd_capacity=cfg.cmd_capacity,
                      max_deltas=cfg.max_deltas, output="entries",
                      sort_impl="xla", pair=mode, hitfuse="off", **_kw(cfg))
    dev = device_scene_from_numpy(jax.tree.map(np.asarray, jdev), "cpu")
    got = coarse_rasterize(dev, pair=mode, **_kw(cfg))
    for leaf in LEAVES:
        g = getattr(got, leaf)
        if leaf == "stream":
            g = stream_to_jax_layout(g)
        g = _bits(g.numpy())
        if leaf == "solid":
            g = g & 0xFFFFFFFF
        np.testing.assert_array_equal(g, _bits(getattr(want, leaf)),
                                      err_msg=f"{name} {mode}: {leaf}")
    for k in ("n_segments", "n_hits", "n_candidates", "live_entries"):
        assert int(got.diag[k]) == int(want.diag[k]), k
    plain = coarse_rasterize(dev, **_kw(cfg))
    n_paired = int(got.diag["live_entries"])
    n_plain = int(plain.diag["live_entries"])
    if mode == "compact" and name != "cardioid":
        assert n_paired < n_plain, (n_paired, n_plain)

    fk = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              tiles_x=cfg.tiles_x)

    def image(ce, paired):
        img = fine_rasterize_entries(
            ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
            ce.stream, 0, paired=paired, **fk)[:cfg.height, :cfg.width]
        return np.ascontiguousarray(img.numpy()).view(np.uint8).reshape(
            cfg.height, cfg.width, 4)

    img = image(got, True)
    np.testing.assert_array_equal(img, cpu_render_scene(scene, cfg))
    np.testing.assert_array_equal(img, image(plain, False))


def test_paired_stream_needs_the_paired_interpreter():
    """An F2 / L2 entry read as unpaired drops its second record: the
    flag is what makes the paired image right."""
    name, make, cfg_kw = CASES[3]          # the 1x tiger: fills and lines
    cfg = RenderConfig(**cfg_kw)
    scene = make()
    dev = prepare_scene(scene, cfg)
    ce = coarse_rasterize(device_scene_from_numpy(
        jax.tree.map(np.asarray, dev), "cpu"), pair="compact", **_kw(cfg))
    rows = ce.stream
    f2 = (rows[:, W_S0_TAG] == CMD_FILL) & (rows[:, W_S1_TAG] == CMD_FILL)
    l2 = (rows[:, W_S0_TAG] == CMD_LINE) & (rows[:, W_S1_TAG] == CMD_LINE)
    assert int(f2.sum()) > 0 and int(l2.sum()) > 0
    args = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
            ce.stream, 0)
    fk = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              tiles_x=cfg.tiles_x)
    assert not torch.equal(fine_rasterize_entries(*args, paired=False, **fk),
                           fine_rasterize_entries(*args, paired=True, **fk))


@pytest.mark.parametrize("mode", ["compact", "hole"])
def test_renderer_takes_the_mode_from_the_environment(monkeypatch, mode):
    """PIET_PAIR is read when a step is built, on the entries route only;
    the frame is the oracle's."""
    name, make, cfg_kw = CASES[1]          # the cardioid
    cfg = RenderConfig(**cfg_kw)
    scene = make()
    monkeypatch.setenv("PIET_PAIR", mode)
    r = Renderer(cfg, device="cpu", fine_impl="entries")
    assert r._pair == mode
    assert Renderer(cfg, device="cpu", fine_impl="dense")._pair == "off"
    np.testing.assert_array_equal(r.render(scene),
                                  cpu_render_scene(scene, cfg))
    monkeypatch.setenv("PIET_PAIR", "sideways")
    with pytest.raises(ValueError, match="unknown pair mode"):
        Renderer(cfg, device="cpu", fine_impl="entries")
    monkeypatch.delenv("PIET_PAIR")
    assert Renderer(cfg, device="cpu", fine_impl="entries")._pair == "off"
