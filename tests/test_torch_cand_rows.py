"""The coarse pass's entry rows and sort keys: ``ops/cand_rows.py::
cand_rows`` (the kernel ``csrc/cand_rows.cu``) against its plain version
``ops/cand_rows.py::cand_rows_plain``.

On the CPU: :func:`kernel_model`, the kernel's algorithm in numpy (a
candidate's one class picked from its tag, flags, backdrop and command
count, then that class's operands), equals the plain version's rows and
keys word for word, dead slots and padding included, as the pass calls it
on tests/test_torch_dense_tail.py's cases (the configurations of
tests/test_coarse.py, the overflow, bail and corner scenes), the group
scenes (clips, layers, gradients, combined fills with holes), a rect-
clipped scene, a page of combined-fill glyphs (CONT/FINAL, ``CMD_WIND``)
and the unpacked key mode of tests/test_torch_unpacked.py; and on
synthetic records full of the values the words can hold (NaN payloads,
-0.0 and NaN backdrops, every item tag and flag, clipped and unclipped
rects).  The CPU pass launches no kernel.

On the card (``cuda``): the kernel against the plain version (run on the
same card tensors) word for word on those scenes, some also with the
segment stage derived on the card, on the benchmark's four scenes at
their fitted capacities and on synthetic records whose flags are NaN,
infinite or past int32; one launch a coarse pass on both routes; a
captured frame's ``rows`` stage at most 4 device nodes.

No JAX here: on the card,
``python -m pytest --noconftest tests/test_torch_cand_rows.py -q``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

from piet_tpu_torch import tracing  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.layout.entry_stream import (  # noqa: E402
    META_CLEAR_BIT, META_OPAQUE_BIT, W_META, W_S0_TAG)
from piet_tpu_torch.ops import cand_rows, coarse  # noqa: E402
from piet_tpu_torch.raster.ptcl import (  # noqa: E402
    CMD_BEGIN_CLIP, CMD_BEGIN_LAYER, CMD_CIRCLE, CMD_DRAW_FILL,
    CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD, CMD_END_CLIP, CMD_END_LAYER,
    CMD_SOLID, CMD_STROKE, CMD_WIND)
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    make_render_fn, prepare_scene)
from piet_tpu_torch.scene import fixtures  # noqa: E402
from piet_tpu_torch.scene.scene import (  # noqa: E402
    FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL, FLAG_FILL_CONT, FLAG_FILL_FINAL,
    FLAG_IN_GROUP, FLAG_POP_LAYER, TAG_CIRCLE, TAG_CLIP, TAG_FILL, TAG_LAYER,
    TAG_LINE, TAG_POLY, TAG_POP)
from test_torch_dense_tail import (  # noqa: E402
    CPU_CASES, GROUP_SCENES, _bench_case, _frame_steps, _group_case,
    _pass_kw)

I32, F32 = np.int32, np.float32
INF_BITS = int(np.float32(np.inf).view(np.int32))


# ---- the kernel in numpy ----------------------------------------------

def _f2i_sat(x):
    """f32 -> int32, saturating, NaN -> 0, toward zero (the card's)."""
    x = float(x)
    if x != x:
        return 0
    return int(max(min(x, 2147483647.0), -2147483648.0))


def _wrap(v):
    return (int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _fbits(v):
    return int(np.float32(v).view(np.int32))


def _cand_row(r, emit, bd_bits, valid):
    """Candidate record r's (32 int32 words) row of 16 words and whether
    it holds a command: csrc/cand_rows.cu::cand_slot."""
    f = r.view(F32)
    col, bbox, clip, grad = r[0:4], r[4:8], r[11:15], r[25:32]
    flags = _f2i_sat(f[10])
    color_bits, tag_item = int(r[9]), int(r[15])
    bd = np.int32(bd_bits).view(F32)
    bd_nz = bool(bd != 0.0)
    any_ = emit > 0
    rad = bool(flags & FLAG_BRUSH_RADIAL)
    grad_item = bool(flags & FLAG_BRUSH_LINEAR) or rad
    cont = bool(flags & FLAG_FILL_CONT)
    fin = bool(flags & FLAG_FILL_FINAL)
    ingroup = bool(flags & FLAG_IN_GROUP)
    even_odd = _fbits(flags & 1)

    cls = None
    if not valid:
        pass
    elif tag_item == TAG_CIRCLE:
        cls = "circle"
    elif tag_item == TAG_FILL:
        if cont:
            cls = "wind" if bd_nz else None
        elif grad_item:
            cls = "grad" if (any_ or bd_nz or fin) else None
        elif any_ or fin:
            cls = "drawfill"
        elif bd_nz:
            cls = "solid"
    elif tag_item in (TAG_POLY, TAG_LINE):
        cls = "stroke" if any_ else None
    elif tag_item == TAG_CLIP:
        cls = "clip"
    elif tag_item == TAG_LAYER:
        cls = "layer"
    elif tag_item == TAG_POP:
        cls = "pop"
    pop_layer = cls == "pop" and bool(flags & FLAG_POP_LAYER)

    a = [col[0], col[0], col[1], col[2], col[3], 0, 0, 0]
    rect = list(clip)
    tag = 0
    if cls == "circle":
        tag = CMD_CIRCLE
        a[:5] = list(bbox) + [0]
    elif cls == "drawfill":
        tag = CMD_DRAW_FILL
        a[0], a[5] = bd_bits, even_odd
    elif cls == "solid":
        tag = CMD_SOLID
        a[:5] = list(col) + [0]
    elif cls == "stroke":
        tag = CMD_STROKE
        a[0] = r[8]
    elif cls == "grad":
        tag = CMD_DRAW_RAD_GRAD if rad else CMD_DRAW_LIN_GRAD
        a = [bd_bits] + list(grad[:3]) + list(col)
        rect = list(grad[3:7])
    elif cls is not None:   # wind, clip, layer, pop
        tag = {"wind": CMD_WIND, "clip": CMD_BEGIN_CLIP,
               "layer": CMD_BEGIN_LAYER}.get(
            cls, CMD_END_LAYER if pop_layer else CMD_END_CLIP)
        a, rect = [0] * 8, [0] * 4
        if cls in ("wind", "clip"):
            a[0] = bd_bits
        if cls == "clip":
            a[1] = even_odd
        if pop_layer:
            with np.errstate(over="ignore", invalid="ignore"):
                a[0] = int((np.float32(2.0) * f[8]).view(np.int32))

    unclipped = (f[11] == F32(-1e9) and f[12] == F32(-1e9)
                 and f[13] == F32(1e9) and f[14] == F32(1e9))
    opaque = (cls == "solid" and (color_bits & 0xFF) == 0xFF and unclipped
              and not ingroup)
    clearing = (cls in ("circle", "drawfill", "stroke", "grad", "clip",
                        "layer", "pop")
                or (cls == "solid" and not (unclipped and not ingroup)))
    meta = ((cls is not None) | (META_OPAQUE_BIT if opaque else 0)
            | (META_CLEAR_BIT if clearing else 0))
    row = ([_fbits(tag)] + a + rect
           + [color_bits if opaque else 0, _fbits(meta), 0])
    return np.array(row, np.int64).astype(I32), cls is not None


def kernel_model(ca, cand_emit, backdrop, cand_tile, n_cand, hit_rec, *,
                 stride):
    """csrc/cand_rows.cu in numpy, on numpy arrays: ``(rows, keys)`` as
    :func:`cand_rows.cand_rows` returns them."""
    hit_i = np.ascontiguousarray(hit_rec).view(I32)
    ca_i = np.ascontiguousarray(ca).view(I32)
    bd_i = np.ascontiguousarray(backdrop).view(I32)
    H, C = hit_i.shape[0], ca_i.shape[0]
    n = int(np.asarray(n_cand).reshape(-1)[0])
    rows = np.zeros((H + C, 16), I32)
    rows[:H] = hit_i[:, :16]
    keys = [np.zeros(H + C, I32) for _ in range(1 if stride else 2)]
    if stride:
        keys[0][:H] = hit_i[:, 16]
    else:
        keys[0][:H], keys[1][:H] = hit_i[:, 23], hit_i[:, 16]
    for i in range(C):
        rows[H + i], live = _cand_row(ca_i[i], int(cand_emit[i]),
                                      int(bd_i[i]), i < n)
        tile, key_item = int(cand_tile[i]), _wrap(int(ca_i[i, 24]) * 2 + 1)
        if stride:
            k = [_wrap(tile * stride + key_item)]
        else:
            k = [tile, key_item]
        for key, v in zip(keys, k):
            key[H + i] = _fbits(np.float32(np.int32(v))) if live else INF_BITS
    return rows, tuple(k.view(F32) for k in keys)


# ---- cases --------------------------------------------------------------

def _np(t):
    a = t.cpu().numpy() if torch.is_tensor(t) else t
    return np.ascontiguousarray(a).view(np.int32)


def _fitted(make, size, tile_w=128, tile_h=32):
    def case():
        scene = make()
        return scene, fit_capacities(scene, RenderConfig(
            width=size, height=size, tile_width=tile_w, tile_height=tile_h))
    return case


def _glyphs():
    """200 glyphs of the benchmark's text page at 256^2: combined fills
    (CONT/FINAL, CMD_WIND) in deep fill-only tiles."""
    from frame_bench.reference.scene import text
    from frame_bench.workload import port_scene
    return port_scene(text.make_text_page(n_glyphs=200, size=256))


def _unpacked():
    """tests/test_torch_unpacked.py's configuration: the cardioid at
    1024^2 in 16x16 tiles with room for 2,048 items, so the packed key
    would reach 2^24 and the pass sorts on two keys."""
    scene = fixtures.make_cardioid(center=(512.0, 512.0), r=400.0)
    cfg = fit_capacities(scene, RenderConfig(width=1024, height=1024,
                                             tile_height=16, tile_width=16))
    return scene, dataclasses.replace(cfg, max_items=2048)


#: name -> () -> (scene, config): the CPU tests' scenes.
CASES = {
    **CPU_CASES,
    **{n: (lambda m=m: _group_case(m)) for n, m in GROUP_SCENES},
    "clipped": _fitted(fixtures.make_clipped_demo, 256, 16, 16),
    "glyphs": _fitted(_glyphs, 256),
    "unpacked": _unpacked,
}


def coarse_pass(scene, cfg, device, seg_pre=True, output="dense"):
    """(the cand_rows call's arguments and keywords, the pass's rows and
    sort keys) of one coarse pass."""
    taps = {}
    out = coarse.coarse_rasterize(
        prepare_scene(scene, cfg, device, seg_pre=seg_pre), output=output,
        taps=taps, with_probes=True, **_pass_kw(cfg))
    (rows,) = out.diag["probes"]["rows"]
    return taps["cand_rows"], rows, taps["sort"][0]


@functools.lru_cache(maxsize=None)
def cpu_case(name):
    scene, cfg = CASES[name]()
    (args, kw), rows, keys = coarse_pass(scene, cfg, "cpu")
    return ([a.numpy() for a in args], kw, _np(rows),
            tuple(_np(k) for k in keys))


def assert_rows_equal(got, want, what):
    (g_rows, g_keys), (w_rows, w_keys) = got, want
    assert len(g_keys) == len(w_keys), what
    for name, g, w in zip(("rows",) + ("key",) * len(g_keys),
                          (g_rows,) + tuple(g_keys),
                          (w_rows,) + tuple(w_keys)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


# ---- on the CPU -----------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_equals_the_plain_rows_and_keys(name):
    """The pass's rows and keys are the plain version's on its own
    arguments, and the kernel's algorithm in numpy gives them word for
    word on every slot: the hit records' copies, the candidates' tail
    commands, the dead candidates' words and the +inf keys."""
    args, kw, rows, keys = cpu_case(name)
    assert_rows_equal((rows, keys), cand_rows.cand_rows_plain(
        *(torch.from_numpy(a) for a in args), **kw), name)
    assert_rows_equal((rows, keys), kernel_model(*args, **kw), name)
    assert len(keys) == (2 if name == "unpacked" else 1)
    n_cand, H = int(args[4][0]), args[5].shape[0]
    assert n_cand > 0
    # Every live slot sorts before +inf, every candidate past n_cand after.
    assert (keys[0][H + n_cand:] == INF_BITS).all()


def test_the_scenes_hold_every_class():
    """Between them the CPU scenes' candidates emit every tail command,
    opaque solids that bail their tile and solids that cannot (clipped or
    in a group)."""
    tags, opaque, solid_clear = set(), 0, 0
    for name in CASES:
        args, _, rows, _ = cpu_case(name)
        cand = rows[args[5].shape[0]:]
        tag = cand[:, W_S0_TAG].view(np.float32).astype(np.int32)
        meta = cand[:, W_META].view(np.float32).astype(np.int32)
        tags |= set(tag.tolist())
        opaque += int(((meta & META_OPAQUE_BIT) != 0).sum())
        solid_clear += int(((tag == CMD_SOLID)
                            & ((meta & META_CLEAR_BIT) != 0)).sum())
    assert {CMD_CIRCLE, CMD_DRAW_FILL, CMD_SOLID, CMD_STROKE,
            CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD, CMD_WIND, CMD_BEGIN_CLIP,
            CMD_END_CLIP, CMD_BEGIN_LAYER, CMD_END_LAYER} <= tags, tags
    assert opaque > 0 and solid_clear > 0


def _synthetic(seed, C=3 * 256 + 37, H=2 * 256 + 5, stride=9, card=False):
    """Synthetic records as numpy arrays, in the pass's argument order:
    candidate records with random words (NaN payloads, -0.0, denormals),
    every item tag and tag past them, random flags (on the ``card`` also
    NaN, infinite and past int32), clipped and unclipped rects, opaque
    and translucent colours; counts around 0, backdrops of +-0.0, NaN and
    values; random hit records; ``stride`` 0 for the unpacked keys."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, 1e-45, np.nan, np.inf, -np.inf, 1.0,
                        -2.5, 0.5, 3e9], F32)
    words = rng.integers(-2 ** 31, 2 ** 31, (C, 32), dtype=np.int64)
    ca = words.astype(I32)
    caf = ca.view(F32)
    pick = rng.random((C, 32)) < 0.3
    caf[pick] = rng.choice(special, int(pick.sum()))
    ca[:, 15] = rng.integers(0, 9, C)
    flags = rng.integers(0, 128, C).astype(F32)
    if card:
        odd = rng.random(C) < 0.1
        flags[odd] = rng.choice(np.array([np.nan, np.inf, -np.inf, 3e9,
                                          -3e9, 0.5, -0.0, 77.9], F32),
                                int(odd.sum()))
    caf[:, 10] = flags
    uncl = rng.random(C) < 0.6
    caf[uncl, 11:15] = np.array([-1e9, -1e9, 1e9, 1e9], F32)
    one_off = uncl & (rng.random(C) < 0.2)
    caf[one_off, 11 + rng.integers(0, 4, int(one_off.sum()))] = 5.0
    opaque = rng.random(C) < 0.5
    ca[opaque, 9] |= 0xFF
    # Items and tiles small enough that the packed key stays in int32 off
    # the card (its int32 wrap is the card's, and its arithmetic wraps).
    hi = 2 ** 20 if card else 2 ** 10
    ca[:, 24] = rng.integers(0, hi, C)
    cand_tile = rng.integers(0, hi, C).astype(I32)
    emit = rng.integers(-1, 3, C).astype(I32)
    backdrop = rng.choice(special[:9], C).astype(F32)
    hit_rec = rng.integers(-2 ** 31, 2 ** 31, (H, 24),
                           dtype=np.int64).astype(I32).view(F32)
    n_cand = np.array([C - 41], I32)
    return ([ca, emit, backdrop, cand_tile, n_cand, hit_rec],
            dict(stride=stride))


@pytest.mark.parametrize("seed,stride", [(7, 9), (8, 0), (9, 4098)])
def test_kernel_model_equals_plain_on_synthetic_records(seed, stride):
    args, kw = _synthetic(seed, stride=stride)
    want = cand_rows.cand_rows_plain(*(torch.from_numpy(a) for a in args),
                                     **kw)
    assert_rows_equal(kernel_model(*args, **kw), want, f"seed {seed}")


def test_the_cpu_pass_launches_no_cand_rows():
    scene, cfg = CASES["corner"]()
    tracing.reset_launches()
    (args, _), rows, _ = coarse_pass(scene, cfg, "cpu")
    assert rows.shape == (cfg.max_hits + cfg.max_candidates, 16)
    assert tracing.LAUNCHES["cand_rows"] == 0


# ---- on the card ----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


#: name -> () -> (scene, config, seg_pre): the card tests' cases.
CUDA_CASES = {
    **{n: (lambda c=c: c() + (True,)) for n, c in CASES.items()},
    **{f"{n}_derived": (lambda c=CASES[n]: c() + (False,))
       for n in ("clip_star", "holes_demo", "glyphs", "unpacked",
                 "tiger_1x")},
    **{n: (lambda n=n: _bench_case(n) + (True,))
       for n in ("tiger_4k", "beziers_10k", "glyph_page_5k")},
    "tiger_4k_derived": lambda: _bench_case("tiger_4k") + (False,),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_cand_rows_equal_plain(name):
    """The kernel's rows and keys, word for word the plain version's on
    the same card tensors, on every slot, in one launch a pass."""
    _need_card()
    scene, cfg, seg_pre = CUDA_CASES[name]()
    with tracing.launches_apart() as launches:
        (args, kw), rows, keys = coarse_pass(scene, cfg, "cuda", seg_pre)
    torch.cuda.synchronize()
    assert launches["cand_rows"] == 1
    want = cand_rows.cand_rows_plain(*args, **kw)
    assert_rows_equal((rows, keys), want, name)
    assert len(keys) == (2 if name.startswith("unpacked") else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,stride", [(7, 9), (8, 0), (9, 2 ** 13 + 2)])
def test_cuda_cand_rows_equal_plain_on_synthetic_records(seed, stride):
    _need_card()
    args, kw = _synthetic(seed, stride=stride, card=True)
    args = [torch.from_numpy(a).cuda() for a in args]
    tracing.reset_launches()
    got = cand_rows.cand_rows(*args, **kw)
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["cand_rows"] == 1
    assert_rows_equal(got, cand_rows.cand_rows_plain(*args, **kw),
                      f"seed {seed}")


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["dense", "entries"])
def test_cuda_one_cand_rows_launch_a_pass(output):
    _need_card()
    scene, cfg = CASES["tiger_1x"]()
    dev = prepare_scene(scene, cfg, "cuda")
    tracing.reset_launches()
    for _ in range(3):
        coarse.coarse_rasterize(dev, output=output, **_pass_kw(cfg))
    torch.cuda.synchronize()
    assert tracing.LAUNCHES["cand_rows"] == 3


@pytest.mark.cuda
def test_cuda_rows_stage_is_at_most_4_nodes():
    """In a captured frame (dense, staged and spun on the card; entries)
    the stage from the backdrop to the rows is the kernel."""
    _need_card()
    steps = list(_frame_steps())
    scene, cfg = CASES["tiger_1x"]()
    render = make_render_fn(cfg, "cuda", fine_impl="entries")
    x = render.stage(prepare_scene(scene, cfg, "cuda"))
    steps.append((render.step, lambda: render.flat(x)))
    for step, call in steps:
        tracing.reset_launches()
        call()
        torch.cuda.synchronize()
        assert tracing.LAUNCHES["cand_rows"] == 1
        (entry,) = step._entries.values()
        stages = dict(entry.stages)
        assert 0 < stages["rows"] <= 4, entry.stages
