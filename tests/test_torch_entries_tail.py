"""The coarse pass's entries tail: ``ops/entries_tail.py::entries_tail``
(the kernel ``csrc/entries_tail.cu``) against its plain version
``ops/entries_tail.py::entries_tail_plain``.

On the CPU: :func:`kernel_model`, the kernel's algorithm in numpy (each
tile's run of entries by integer searches, the run words by chunks of the
kernel's block from the run's end backwards with the next class boundary
carried between chunks, the index maxima, the bail, the command sum from
the first kept entry), equals the plain version word for word -- stream
with its run words, first, entries, commands and bail colour -- on the
entries passes of tests/test_torch_dense_tail.py's cases, the group
scenes and the unpacked key mode, unpaired and (some) paired "compact" and
"hole"; and on synthetic streams: empty tiles, an all-dead stream, bail
tiles with and without an opaque entry, a clearing entry after the last
opaque one, streaks longer than ``RUN_CAP``, streaks that end at a tile's
end, tiles deeper than the kernel's chunk.  The plain version is the JAX
pass's tail: on tests/test_torch_coarse.py's scenes it gives the JAX
entries output (where JAX is installed).  The wrapper runs the plain
version on CPU tensors (no launch), its argument checks raise, and the
probes keep the sorted gather's stream without run words.

On the card (``cuda``): the kernel against the plain version word for
word on the passes of those scenes, the benchmark's three scenes and an
animated 4K tiger pose, unpaired and paired, packed and unpacked keys, and
on the synthetic streams; one launch an entries pass and none on the
dense route; a captured entries frame's ``runs`` stage the kernel and the
pass's overflow counters.

No JAX here but in the one comparison that imports it: on the card,
``python -m pytest --noconftest tests/test_torch_entries_tail.py -q``.
"""

import functools
import re

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

from piet_tpu_torch import kernels, tracing  # noqa: E402
from piet_tpu_torch.layout.entry_stream import (  # noqa: E402
    ENTRY_WORDS, META_CLEAR_BIT, META_NCMDS_MASK, META_OPAQUE_BIT, RUN_CAP,
    W_BAIL, W_META, W_RUN, W_S0_TAG, W_S1_TAG)
from piet_tpu_torch.ops import coarse, entries_tail  # noqa: E402
from piet_tpu_torch.raster.ptcl import (  # noqa: E402
    CMD_DRAW_FILL, CMD_FILL, CMD_FILL_EDGE, CMD_LINE, CMD_SOLID)
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    make_render_fn, prepare_scene)
from test_torch_cand_rows import CASES  # noqa: E402
from test_torch_dense_tail import _bench_case, _pass_kw  # noqa: E402

#: The kernel's block, which is also its run-word chunk.
THREADS = int(re.search(r"constexpr int THREADS = (\d+);",
                        (kernels.CSRC / "entries_tail.cu").read_text())[1])
NO_BOUNDARY = 2 ** 31 - 1


# ---- the kernel's algorithm in numpy ---------------------------------------

def _i32(t):
    a = t.cpu().numpy() if torch.is_tensor(t) else t
    return np.ascontiguousarray(a).view(np.int32)


def kernel_model(stream, e_tile, *, n_tiles, run_words):
    """csrc/entries_tail.cu's algorithm in numpy, on (E, 16) int32 rows
    and (E,) int32 tiles.  Returns ``(stream, first, n_entries, counts,
    solid)`` and the longest tile run (in entries)."""
    rows = stream.copy()
    E = rows.shape[0]
    f = rows.view(np.float32)
    meta = f[:, W_META].astype(np.int32)
    t0, t1 = f[:, W_S0_TAG], f[:, W_S1_TAG]
    cls = np.where((t0 == 0.0) & (t1 == CMD_FILL), 1,
                   np.where((t0 == CMD_LINE) & (t1 == 0.0), 2, 0))
    bounds = np.searchsorted(e_tile, np.arange(n_tiles + 1), side="left")
    if run_words:
        rows[bounds[n_tiles]:, W_RUN] = 0
    out = np.zeros((4, n_tiles), np.int32)
    deepest = 0
    for t in range(n_tiles):
        first, end = int(bounds[t]), int(bounds[t + 1])
        deepest = max(deepest, end - first)
        opq, clr = -1, -2
        next_cls, next_b = -1, end
        hi = end
        while hi > first:
            lo = max(first, hi - THREADS)
            e = np.arange(lo, hi)
            m = meta[lo:hi]
            if (m & META_OPAQUE_BIT).any():
                opq = max(opq, int(e[(m & META_OPAQUE_BIT) != 0].max()))
            if (m & META_CLEAR_BIT).any():
                clr = max(clr, int(e[(m & META_CLEAR_BIT) != 0].max()))
            if run_words:
                c = cls[lo:hi]
                after = np.append(c[1:], next_cls)
                v = np.where(after != c, e + 1, NO_BOUNDARY)
                nb = np.minimum(np.minimum.accumulate(v[::-1])[::-1], next_b)
                ln = np.minimum(nb - e, RUN_CAP).astype(np.float32)
                w = np.where(c == 1, ln, np.where(c == 2, -ln,
                                                  np.float32(0.0)))
                rows[lo:hi, W_RUN] = w.astype(np.float32).view(np.int32)
                next_b = min(next_b, int(v.min()))
                next_cls = int(c[0])
            hi -= THREADS
        bail = clr < opq
        total = 0
        if not bail:
            begin = opq if opq >= 0 else first
            total = int((meta[begin:end] & META_NCMDS_MASK).sum())
        first_live = opq if opq >= 0 else first if end > first else E - 1
        n = 0 if bail else end - first_live
        out[:, t] = (first_live if n > 0 else 0, n, 0 if bail else total,
                     0 if not bail else rows[opq, W_BAIL] if opq >= 0
                     else -1)
    return (rows, *out), deepest


def assert_tail_equal(got, want, what):
    for name, g, w in zip(("stream", "first", "n_entries", "counts",
                           "solid"), got, want):
        np.testing.assert_array_equal(_i32(g), _i32(w),
                                      err_msg=f"{what}: {name}")


# ---- the cases -------------------------------------------------------------

def entries_pass(scene, cfg, device, *, pair="off", seg_pre=True,
                 staged=None):
    """(the entries pass's output, the tail's (stream, e_tile) and
    keywords) on ``device``; ``staged`` a DeviceScene in place of
    ``scene``."""
    taps = {}
    dev = staged if staged is not None else prepare_scene(
        scene, cfg, device, seg_pre=seg_pre)
    out = coarse.coarse_rasterize(dev, output="entries", pair=pair,
                                  taps=taps, **_pass_kw(cfg))
    args, kw = taps["entries_tail"]
    return out, args, kw


#: (case, pair mode): every case unpaired, some paired too.
PASSES = [(n, "off") for n in CASES] + [
    (n, m) for n in ("tiger_1x", "bail", "path_test", "unpacked")
    for m in ("compact", "hole")]


@functools.lru_cache(maxsize=None)
def cpu_pass(name, pair):
    scene, cfg = CASES[name]()
    out, (stream, e_tile), kw = entries_pass(scene, cfg, "cpu", pair=pair)
    return out, (stream.numpy(), e_tile.numpy()), kw


_META = {"F": 1, "L": 1, "E": 2, "O": 1 | META_OPAQUE_BIT,
         "C": 1 | META_CLEAR_BIT, "Z": 0}
_TAGS = {"F": (0, CMD_FILL), "L": (CMD_LINE, 0), "E": (CMD_FILL_EDGE,
                                                       CMD_FILL),
         "O": (CMD_SOLID, 0), "C": (CMD_DRAW_FILL, 0), "Z": (0, 0)}


def synth_stream(tiles, n_dead, seed):
    """An (E, 16) int32 stream and its tiles from ``tiles``, one string of
    entry kinds a tile: F a plain fill, L a line, E a FillEdge with its
    Fill, O an opaque Solid (its bail colour random), C a clearing
    DrawFill, Z a hole (an all-zero row); then ``n_dead`` dead rows.  The
    operand words are random, the W_RUN words too (the tail writes them);
    the dead rows are random but for their tags and meta word."""
    rng = np.random.default_rng(seed)
    kinds = "".join(tiles)
    E = len(kinds) + n_dead
    rows = rng.integers(-2 ** 31, 2 ** 31, (E, ENTRY_WORDS), dtype=np.int64)
    rows = rows.astype(np.int32)
    f = rows.view(np.float32)
    for i, k in enumerate(kinds):
        if k == "Z":
            rows[i] = 0
            continue
        f[i, W_S0_TAG], f[i, W_S1_TAG] = _TAGS[k]
        f[i, W_META] = _META[k]
    f[len(kinds):, [W_S0_TAG, W_S1_TAG, W_META]] = 0.0
    e_tile = np.repeat(np.arange(len(tiles) + 1, dtype=np.int32),
                       [len(s) for s in tiles] + [n_dead])
    return rows, e_tile, len(tiles)


def _random_tile(rng, depth):
    """Streaks of random kinds and lengths, ``depth`` entries."""
    out = ""
    while len(out) < depth:
        k = rng.choice(list("FFFLLLEOCZ"))
        out += k * int(rng.integers(1, 40 if k in "FL" else 4))
    return out[:depth]


def _synth_cases():
    rng = np.random.default_rng(30)
    edges = [
        "",                                   # no entries
        "FLOFF",                              # bails on its opaque entry
        "FFLEL",                              # bails, no opaque entry
        "OFCLLF",                             # a clear after the last opaque
        "F" * (RUN_CAP + 300) + "L" * 300 + "C",  # a streak past RUN_CAP
        "CLLL", "LLC",                        # a line streak ends at a tile
        "FFF", "CFFZF",                       # fill streaks, then a hole
        "C" + "F" * (THREADS - 3) + "LLLLLL" + "F" * 10,  # across a chunk
        "C" + _random_tile(rng, 3 * THREADS + 17),  # four chunks
        "", "OOO", "",
    ]
    cases = {"edges": synth_stream(edges, 37, 0),
             "all_dead": (lambda r, t, n: (r, np.full_like(t, n), n))(
                 *synth_stream(["FLL", "OC"], 300, 1)),
             "one_tile_no_dead": synth_stream(["C" + "L" * 700], 0, 2)}
    for seed in range(3):
        r = np.random.default_rng(seed)
        tiles = [_random_tile(r, int(r.choice([0, 3, 30, 300, 900])))
                 for _ in range(24)]
        cases[f"random_{seed}"] = synth_stream(tiles, int(r.integers(0, 500)),
                                               10 + seed)
    return cases


SYNTH = _synth_cases()


# ---- on the CPU ------------------------------------------------------------

@pytest.mark.parametrize("name,pair", PASSES)
def test_kernel_model_equals_plain_on_the_passes(name, pair):
    """The kernel's algorithm gives the plain version's tail word for word
    on the pass's own inputs, and the pass's output is that tail."""
    out, (stream, e_tile), kw = cpu_pass(name, pair)
    assert kw["run_words"] == (pair == "off")
    want = entries_tail.entries_tail_plain(torch.from_numpy(stream),
                                           torch.from_numpy(e_tile), **kw)
    assert_tail_equal((out.stream, out.first, out.n_entries, out.counts,
                       out.solid), want, f"{name} {pair}: the pass")
    got, _ = kernel_model(stream, e_tile, **kw)
    assert_tail_equal(got, want, f"{name} {pair}")
    assert int(out.diag["live_entries"]) == int(want[2].sum()) > 0
    assert np.all(np.diff(e_tile) >= 0) and e_tile[-1] == kw["n_tiles"]


@pytest.mark.parametrize("name", list(SYNTH))
@pytest.mark.parametrize("run_words", [True, False])
def test_kernel_model_equals_plain_on_synthetic_streams(name, run_words):
    stream, e_tile, n_tiles = SYNTH[name]
    kw = dict(n_tiles=n_tiles, run_words=run_words)
    want = entries_tail.entries_tail_plain(torch.from_numpy(stream),
                                           torch.from_numpy(e_tile), **kw)
    got, deepest = kernel_model(stream, e_tile, **kw)
    assert_tail_equal(got, want, name)
    if name != "all_dead":
        assert deepest > THREADS
    if not run_words:
        np.testing.assert_array_equal(_i32(want[0]), stream)


def test_the_synthetic_streams_hold_what_they_are_for():
    """Run words capped at RUN_CAP and streaks cut at a tile's end; empty
    and bailing tiles with and without an opaque entry; a tile kept from
    its opaque entry past a clear; the all-dead stream's words zero."""
    stream, e_tile, n_tiles = SYNTH["edges"]
    s, first, n, counts, solid = (_i32(x) for x in
                                  entries_tail.entries_tail_plain(
                                      torch.from_numpy(stream),
                                      torch.from_numpy(e_tile),
                                      n_tiles=n_tiles, run_words=True))
    run = s[:, W_RUN].view(np.float32)
    assert run.max() == RUN_CAP and run.min() < 0
    b = np.searchsorted(e_tile, np.arange(n_tiles + 1))
    assert list(run[b[5]:b[6]]) == [0.0, -3.0, -2.0, -1.0]
    assert list(run[b[6]:b[6] + 2]) == [-2.0, -1.0]
    assert n[0] == counts[0] == first[0] == 0 and solid[0] == -1
    assert n[1] == 0 and solid[1] == stream[b[1] + 2, W_BAIL] != 0
    assert n[2] == 0 and solid[2] == -1
    assert solid[3] == 0 and first[3] == b[3] and n[3] == 6
    assert counts[3] == 6 and counts[8] == 4 and n[8] == 5
    assert list(run[b[8]:b[9]]) == [0.0, 2.0, 1.0, 0.0, 1.0]
    dead = SYNTH["all_dead"]
    d = _i32(entries_tail.entries_tail_plain(
        torch.from_numpy(dead[0]), torch.from_numpy(dead[1]),
        n_tiles=dead[2], run_words=True)[0])
    assert not d[:, W_RUN].any()


def test_the_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors: no launch, the plain version's words, and the input
    stream left as it was (a new stream returned)."""
    stream, e_tile, n_tiles = SYNTH["random_0"]
    s, t = torch.from_numpy(stream.copy()), torch.from_numpy(e_tile)
    tracing.reset_launches()
    got = entries_tail.entries_tail(s, t, n_tiles=n_tiles, run_words=True)
    assert tracing.LAUNCHES["entries_tail"] == 0
    assert_tail_equal(got, entries_tail.entries_tail_plain(
        s, t, n_tiles=n_tiles, run_words=True), "wrapper")
    np.testing.assert_array_equal(s.numpy(), stream)
    assert got[0].data_ptr() != s.data_ptr()


def test_the_cpu_pass_launches_no_entries_tail():
    scene, cfg = CASES["corner"]()
    tracing.reset_launches()
    out, _, _ = entries_pass(scene, cfg, "cpu")
    assert int(out.n_entries.sum()) > 0
    assert tracing.LAUNCHES["entries_tail"] == 0


def _bad_args():
    s = torch.zeros((256, ENTRY_WORDS), dtype=torch.int32)
    t = torch.zeros((256,), dtype=torch.int32)
    return {
        "stream dtype": ((s.float(), t), 4),
        "stream width": ((s[:, :15], t), 4),
        "tile dtype": ((s, t.long()), 4),
        "tile length": ((s, t[:-1]), 4),
        "no entries": ((s[:0], t[:0]), 4),
        "no tiles": ((s, t), 0),
        "f32 run keys": ((s, t), 2 ** 24 // 3),
        "devices": ((s, t.to("meta")), 4),
    }


@pytest.mark.parametrize("what", list(_bad_args()))
def test_the_argument_checks_raise(what):
    (s, t), n_tiles = _bad_args()[what]
    with pytest.raises(ValueError):
        entries_tail.entries_tail(s, t, n_tiles=n_tiles, run_words=True)


def _probe_check(device, pair):
    scene, cfg = CASES["tiger_1x"]()
    taps = {}
    out = coarse.coarse_rasterize(
        prepare_scene(scene, cfg, device), output="entries", pair=pair,
        taps=taps, with_probes=True, **_pass_kw(cfg))
    probes = out.diag["probes"]
    (stream, e_tile), kw = taps["entries_tail"]
    want = entries_tail.entries_tail_plain(stream.cpu(), e_tile.cpu(), **kw)
    assert_tail_equal((out.stream, out.first, out.n_entries, out.counts,
                       out.solid), want, "probed pass")
    (gathered,) = probes["sorted_gather"]
    if pair == "off":
        # The sorted gather's stream is the tail's input, without run
        # words; the runs probe is the stream with them.
        np.testing.assert_array_equal(_i32(gathered), _i32(stream))
        assert not _i32(gathered)[:, W_RUN].any()
        (runs,) = probes["runs"]
        np.testing.assert_array_equal(_i32(runs), _i32(want[0]))
        assert _i32(runs)[:, W_RUN].any()
    else:
        assert "runs" not in probes
    first, n_live, solid = probes["tile_reduce"]
    np.testing.assert_array_equal(_i32(n_live), _i32(want[2]))


@pytest.mark.parametrize("pair", ["off", "hole"])
def test_the_probes_of_runs_and_sorted_gather(pair):
    _probe_check("cpu", pair)


#: tests/test_torch_coarse.py's scenes: name, fixture, size, tile height.
JAX_SCENES = [("tiger_1x", 512, 32), ("path_test", 256, 32),
              ("gradients", 256, 16)]


@pytest.mark.parametrize("name,size,th", JAX_SCENES,
                         ids=[s[0] for s in JAX_SCENES])
def test_plain_equals_the_jax_entries_tail(name, size, th):
    """The plain version on the port's pass inputs gives the JAX pass's
    entries output (tests/test_torch_coarse.py's comparison, the JAX
    reference's staged route run eagerly), word for word."""
    jax = pytest.importorskip("jax")
    from piet_tpu.config import RenderConfig
    from piet_tpu.ops.coarse import coarse_rasterize as jax_coarse
    from piet_tpu.renderer.capacity import fit_capacities
    from piet_tpu.renderer.renderer import prepare_scene as jax_prepare
    from piet_tpu.scene import fixtures
    from piet_tpu.scene.svg import make_tiger
    from piet_tpu_torch.renderer.renderer import device_scene_from_numpy

    scene = (make_tiger(scale=1.0) if name == "tiger_1x"
             else fixtures.get_scene(name))
    cfg = fit_capacities(scene, RenderConfig(
        width=size, height=size, tile_height=th, tile_width=128))
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
              tile_w=cfg.tile_width, tile_h=cfg.tile_height,
              max_segments=cfg.max_segments, max_hits=cfg.max_hits,
              max_candidates=cfg.max_candidates)
    jdev = jax_prepare(scene, cfg)
    want = jax_coarse(jdev, cmd_capacity=cfg.cmd_capacity,
                      max_deltas=cfg.max_deltas, output="entries",
                      sort_impl="xla", pair="off", hitfuse="off", **kw)
    taps = {}
    coarse.coarse_rasterize(
        device_scene_from_numpy(jax.tree.map(np.asarray, jdev), "cpu"),
        taps=taps, **kw)
    (stream, e_tile), tkw = taps["entries_tail"]
    got = entries_tail.entries_tail_plain(stream, e_tile, **tkw)
    assert int(got[2].sum()) > 0
    got = (coarse.stream_to_jax_layout(got[0]),) + got[1:]
    for leaf, g in zip(("stream", "first", "n_entries", "counts", "solid"),
                       got):
        w = np.asarray(getattr(want, leaf))
        w = w.view(np.int32) if w.dtype.kind == "f" else w
        np.testing.assert_array_equal(
            _i32(g).astype(np.int64) & 0xFFFFFFFF,
            w.astype(np.int64) & 0xFFFFFFFF, err_msg=f"{name}: {leaf}")


# ---- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _anim_pose():
    from test_torch_seg_rows import _tiger_4k_pose
    st, cfg = _tiger_4k_pose(21)
    return None, cfg, st


#: name -> () -> (scene, config, staged or None): the card's passes.
CUDA_CASES = {
    **{n: (lambda c=c: c() + (None,)) for n, c in CASES.items()},
    **{n: (lambda n=n: _bench_case(n) + (None,))
       for n in ("tiger_4k", "beziers_10k", "glyph_page_5k")},
    "tiger_4k_anim_pose": _anim_pose,
}
CUDA_PASSES = [(n, "off") for n in CUDA_CASES] + [
    (n, m) for n in ("tiger_1x", "bail", "unpacked", "tiger_4k",
                     "beziers_10k", "tiger_4k_anim_pose")
    for m in ("compact", "hole")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,pair", CUDA_PASSES)
def test_cuda_entries_tail_equals_plain(name, pair):
    """The pass's tail on the card (the kernel, its run words written in
    place), word for word the plain version's on the same inputs copied to
    the CPU, in one launch; and the kernel called on those inputs again,
    its run words written into that input in place."""
    _need_card()
    scene, cfg, staged = CUDA_CASES[name]()
    with tracing.launches_apart() as launches:
        out, (stream, e_tile), kw = entries_pass(scene, cfg, "cuda",
                                                 pair=pair, staged=staged)
    torch.cuda.synchronize()
    assert launches["entries_tail"] == 1
    want = entries_tail.entries_tail_plain(stream.cpu(), e_tile.cpu(), **kw)
    assert_tail_equal((out.stream, out.first, out.n_entries, out.counts,
                       out.solid), want, f"{name} {pair}")
    assert int(out.diag["live_entries"]) == int(want[2].sum()) > 0
    s = stream.clone()
    got = entries_tail.entries_tail(s, e_tile, **kw)
    assert_tail_equal(got, want, f"{name} {pair} called again")
    assert got[0].data_ptr() == s.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SYNTH))
@pytest.mark.parametrize("run_words", [True, False])
def test_cuda_entries_tail_equals_plain_on_synthetic_streams(name,
                                                             run_words):
    _need_card()
    stream, e_tile, n_tiles = SYNTH[name]
    kw = dict(n_tiles=n_tiles, run_words=run_words)
    want = entries_tail.entries_tail_plain(torch.from_numpy(stream),
                                           torch.from_numpy(e_tile), **kw)
    tracing.reset_launches()
    got = entries_tail.entries_tail(torch.from_numpy(stream).cuda(),
                                    torch.from_numpy(e_tile).cuda(), **kw)
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["entries_tail"] == 1
    assert_tail_equal(got, want, name)


@pytest.mark.cuda
def test_cuda_one_launch_an_entries_pass_none_on_dense():
    _need_card()
    scene, cfg = CASES["tiger_1x"]()
    dev = prepare_scene(scene, cfg, "cuda")
    tracing.reset_launches()
    for pair in ("off", "compact", "hole"):
        coarse.coarse_rasterize(dev, output="entries", pair=pair,
                                **_pass_kw(cfg))
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["entries_tail"] == 3
    tracing.reset_launches()
    coarse.coarse_rasterize(dev, output="dense", **_pass_kw(cfg))
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["entries_tail"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["off", "hole"])
def test_cuda_the_probes_of_runs_and_sorted_gather(pair):
    _need_card()
    _probe_check("cuda", pair)


@pytest.mark.cuda
def test_cuda_runs_stage_is_the_kernel():
    """In a captured entries frame the stage after the sorted gather is
    the pass's overflow counters (6 nodes) and the kernel, and the tile
    reduction's the live-entry sum."""
    _need_card()
    scene, cfg = CASES["tiger_1x"]()
    render = make_render_fn(cfg, "cuda", fine_impl="entries")
    x = render.stage(prepare_scene(scene, cfg, "cuda"))
    tracing.reset_launches()
    render.flat(x)
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["entries_tail"] == 1
    (entry,) = render.step._entries.values()
    stages = dict(entry.stages)
    assert stages["runs"] <= 8 and stages["tile_reduce"] <= 2, entry.stages
