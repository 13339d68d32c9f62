"""The port's kernel plumbing (piet_tpu_torch/kernels.py): the dispatch
rule, the build contract and the launch counters; and, on a CUDA card
only, every kernel against its plain version at small shapes.

The CUDA tests carry the ``cuda`` marker and skip where no card is
present.  On a machine with a card and without jax (tests/conftest.py
imports jax), run them with
``python -m pytest --noconftest tests/test_torch_kernels.py -q``.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

from piet_tpu_torch import kernels, tracing
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.ops import (candfuse, coarse, expand, fine, fine_xla,
                                gatherm, hitfuse, keyed, probes, sort)
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene
from piet_tpu_torch.raster.synth_entries import synth_entry_streams
from piet_tpu_torch.raster.synth_ptcl import synth_dense_ptcl
from piet_tpu_torch.renderer.capacity import fit_capacities
from piet_tpu_torch.renderer.graph import device_ops as graph_device_ops
from piet_tpu_torch.renderer.renderer import (Renderer, _solid_to_present_u32,
                                              device_scene_from_numpy,
                                              fetch_scene, make_render_fn,
                                              pack_scene, prepare_scene,
                                              render_slab, unpack_scene)
from piet_tpu_torch.renderer.segstage import build_seg_pre
from piet_tpu_torch.scene import affine, animate, fixtures
from piet_tpu_torch.scene.svg import make_tiger
from _engine_cases import (CAND_SCENES, EXPAND_CASES, EXPAND_WORDS,
                           KEYED_SYNTH, adversarial_sitem, cand_scene_case,
                           expand_rows_case, keyed_synth_case,
                           synth_cand_pack)


def test_dispatch_rule():
    cpu = torch.zeros(4)
    assert kernels.on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError):
        kernels.on_cuda(torch.zeros(4, device="meta"))


def test_build_flags_keep_ieee_rounding():
    flags = kernels.NVCC_FLAGS
    for f in ("-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "arch=compute_90a,code=sm_90a"):
        assert f in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)


def _no_cuda_toolkit(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "NVCC_FALLBACK_PATHS", ())
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.delenv("CUDA_PATH", raising=False)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler raises; nothing falls back to the CPU."""
    _no_cuda_toolkit(monkeypatch, tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    _no_cuda_toolkit(monkeypatch, tmp_path)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        kernels.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_tracks_sources_and_flags(monkeypatch):
    a = kernels.library_path()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ["-g"])
    assert kernels.library_path() != a
    assert a.parent == kernels.BUILD_DIR


def test_plain_calls_do_not_count_launches():
    tracing.reset_launches()
    scene = fixtures.get_scene("path_test")
    Renderer.for_scene(scene, 256, 256, device="cpu").render(scene)
    assert all(v == 0 for v in tracing.LAUNCHES.values())


def test_launches_apart_keeps_counts_out():
    """Launches counted inside launches_apart go to its dict, not to
    LAUNCHES; add_launches adds such a dict back (a graph replay)."""
    tracing.reset_launches()
    tracing.LAUNCHES["sort"] = 2
    with tracing.launches_apart() as apart:
        tracing.LAUNCHES["sort"] += 1
        tracing.LAUNCHES["fine"] += 3
    assert tracing.LAUNCHES["sort"] == 2 and tracing.LAUNCHES["fine"] == 0
    assert apart["sort"] == 1 and apart["fine"] == 3
    assert set(apart) == set(tracing.LAUNCHES)
    tracing.add_launches(apart)
    tracing.add_launches(apart)
    assert tracing.LAUNCHES["sort"] == 4 and tracing.LAUNCHES["fine"] == 6
    tracing.reset_launches()


def _c_entry_points(text: str) -> dict:
    """``extern "C"`` functions of a source: name -> ctypes argument
    types, with object-like macros in the parameter lists expanded."""
    macros = {m.group(1): m.group(2).replace("\\\n", " ")
              for m in re.finditer(r"#define (\w+)((?:[^\n]*\\\n)*[^\n]*)",
                                   text)}
    entries = {}
    for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', text,
                         re.S):
        params = m.group(2)
        for name, body in macros.items():
            params = re.sub(rf"\b{name}\b", body, params)
        args = [a.strip() for a in params.split(",")]
        assert all("*" in a or re.match(r"(int|cudaStream_t) \w+$", a)
                   for a in args), (m.group(1), args)
        entries[m.group(1)] = [kernels._P if "*" in a or "cudaStream_t" in a
                               else kernels._I for a in args]
    return entries


def test_every_kernel_has_an_entry_point_and_a_counter():
    """Each .cu source defines C entry points, and one launch counter
    counts them (kernel D's paired instantiation and pairing's
    compaction in expand.cu have a second one each; the kernels of
    probes.cu and mosaic_probe.cu, the tools', one each); every entry
    point's ctypes signature matches its C parameters, the stream last."""
    names = {p.stem for p in kernels.CSRC.glob("*.cu")} - {"probes",
                                                            "mosaic_probe"}
    assert (names | {"fine_paired", "expand_pairing"} | set(probes.KERNELS)
            == set(tracing.LAUNCHES))
    found = {}
    for src in kernels.CSRC.glob("*.cu"):
        entries = _c_entry_points(src.read_text())
        assert entries, src.name
        found.update(entries)
    assert found == kernels._SIGNATURES
    assert all(a[-1] is kernels._P for a in found.values())


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512),
                         bucket=True)
    dev = prepare_scene(scene, cfg, "cuda")
    taps = {}
    ce = coarse.coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_width,
        tile_h=cfg.tile_height, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates, taps=taps)
    return cfg, taps, ce


def _same_bits(a, b):
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions(cuda_inputs):
    cfg, taps, ce = cuda_inputs
    ci, akw = taps["candfuse"]
    for g, w in zip(candfuse.cand_records_fused(*ci, **akw),
                    candfuse.cand_records_fused_plain(*ci, **akw)):
        assert _same_bits(g, w)
    hargs, bkw = taps["hitfuse"]
    assert _same_bits(hitfuse.hit_records_fused(*hargs, **bkw),
                      hitfuse.hit_records_fused_plain(*hargs, **bkw))
    keys, val, bounds = taps["sort"]
    gk, gv = sort.stable_sort_multi(keys, val, bounds)
    wk, wv = sort.stable_sort_multi_plain(keys, val)
    assert all(_same_bits(g, w) for g, w in zip(gk, wk))
    assert torch.equal(gv, wv)
    args = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
            ce.stream)
    kw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              tiles_x=cfg.tiles_x)
    assert torch.equal(fine.fine_rasterize_entries(*args, **kw),
                       fine.fine_rasterize_entries_plain(*args, **kw))


def _affine_tiger_hit_taps():
    """Kernel B's inputs on an affine-spun tiger frame, segments derived on
    the card (seg_pre=None)."""
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512,
                                             tile_height=16, tile_width=128),
                         bucket=True)
    cfg = dataclasses.replace(cfg, max_hits=8 * cfg.max_hits,
                              max_candidates=8 * cfg.max_candidates)
    render_t = affine.make_affine_render_fn(
        cfg, scene, lambda t: affine.rotation_about(256.0, 256.0, t, 0.9))
    taps = {}
    coarse.coarse_rasterize(
        render_t.scene_at(0.5), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        max_segments=cfg.max_segments, max_hits=cfg.max_hits,
        max_candidates=cfg.max_candidates, taps=taps)
    return taps["hitfuse"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["total 0", "total == cap", "stride 0",
                                  "affine tiger"])
def test_cuda_hitfuse_edge_cases(case, cuda_inputs):
    """Kernel B bitwise against its plain version: no live record (every
    block writes the dead pattern), every record live, the unpacked
    sort's key mode, and segments derived on the card."""
    _, taps, _ = cuda_inputs
    (rows, counts, excl, total), kw = taps["hitfuse"]
    if case == "total 0":
        total = torch.zeros_like(total)
    elif case == "total == cap":
        kw = dict(kw, cap=int(total.reshape(-1)[0]))
    elif case == "stride 0":
        kw = dict(kw, stride=0)
    else:
        (rows, counts, excl, total), kw = _affine_tiger_hit_taps()
    assert int(total.reshape(-1)[0]) <= kw["cap"]
    tracing.reset_launches()
    got = hitfuse.hit_records_fused(rows, counts, excl, total, **kw)
    assert tracing.LAUNCHES["hitfuse"] == 1
    assert _same_bits(got, hitfuse.hit_records_fused_plain(
        rows, counts, excl, total, **kw))


def _sort_case(n, n_keys, bound, seed, val_kind):
    rng = np.random.default_rng(seed)
    keys = []
    for _ in range(n_keys):
        k = rng.integers(0, bound, n).astype(np.float32)
        k[rng.uniform(size=n) < 0.3] = np.inf
        keys.append(torch.from_numpy(k).cuda())
    val = (torch.arange(n, 0, -1, dtype=torch.int32) if val_kind == "reversed"
           else torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n)
                                 .astype(np.int32)))
    return tuple(keys), val.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_keys,bound", [
    (67_584, 1, 412_360),            # the tiger's size: one cluster launch
    (196_608, 1, 2 ** 24),           # all the cluster holds
    (150_000, 2, 4096),              # two keys
    (1 << 20, 1, 2 ** 24),           # the device-memory route
    (196_609, 2, 2 ** 24),           # the same, one pair past the cluster
    (5, 1, 3),                       # fewer pairs than blocks
    (261_504, 1, 5_177_856),         # beziers_10k at 1024^2, fitted
    (368_640, 1, 7_340_544),         # the same, bucketed
    (368_640, 2, 28_674),            # beziers-sized, two keys
])
def test_cuda_sort_equals_plain(n, n_keys, bound):
    """The radix kernel against successive stable torch.sorts, bitwise, on
    both routes: dead +inf records, a val that is not increasing.  The
    device-memory route is one launch of the wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys, val = _sort_case(n, n_keys, bound, n + n_keys, "reversed"
                           if n_keys == 1 else "random")
    bounds = (bound,) * n_keys
    tracing.reset_launches()
    gk, gv = sort.stable_sort_multi(keys, val, bounds)
    assert tracing.LAUNCHES["sort"] == 1
    wk, wv = sort.stable_sort_multi_plain(keys, val)
    assert all(_same_bits(g, w) for g, w in zip(gk, wk))
    assert torch.equal(gv, wv)


@pytest.mark.cuda
def test_cuda_sort_negative_zero_keys():
    """A -0.0 key word is not the word its integer value gives back: the
    device-memory route then gathers the outputs by index instead of
    moving val with the key, and stays bitwise equal to the plain sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys, val = _sort_case(261_504, 1, 64, 5, "random")
    key = torch.where(keys[0] == 0, -0.0, keys[0])
    assert bool((key.view(torch.int32) == -2 ** 31).any())
    assert sort.sort_plan(261_504, (64,)).cluster == 0
    gk, gv = sort.stable_sort_multi((key,), val, (64,))
    wk, wv = sort.stable_sort_multi_plain((key,), val)
    assert _same_bits(gk[0], wk[0])
    assert torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,size,th,tw", [
    ("clip_star", lambda: fixtures.make_clip_star(256), 256, 16, 128),
    ("gradient_demo", lambda: fixtures.make_gradient_demo(256), 256, 16,
     128),
    ("holes_demo", lambda: fixtures.make_holes_demo(256), 256, 16, 128),
    ("tiger_16x16", lambda: make_tiger(scale=1.0), 256, 16, 16),
])
def test_cuda_fine_entries_equals_plain(name, make, size, th, tw):
    """Kernel D's stack path (the group fixtures) and 16x16 tiles against
    its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make()
    cfg = fit_capacities(scene, RenderConfig(width=size, height=size,
                                             tile_height=th, tile_width=tw))
    ce = coarse.coarse_rasterize(
        prepare_scene(scene, cfg, "cuda"), tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y, tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        max_segments=cfg.max_segments, max_hits=cfg.max_hits,
        max_candidates=cfg.max_candidates)
    args = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
            ce.stream)
    kw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              tiles_x=cfg.tiles_x)
    assert torch.equal(fine.fine_rasterize_entries(*args, **kw),
                       fine.fine_rasterize_entries_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_cuda_beziers_render_equals_oracle(fine_impl):
    """beziers_10k at 1024^2 (E = 368,640 records, bucketed): the sort
    takes the device-memory route; the frame bitwise against the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = fixtures.get_scene("beziers_10k")
    r = Renderer.for_scene(scene, 1024, 1024, device="cuda",
                           fine_impl=fine_impl)
    cfg = r.config
    n = cfg.max_hits + cfg.max_candidates
    bound = cfg.n_tiles * 2 * (cfg.max_items + 1)
    assert n > sort.CLUSTER * sort.CLUSTER_CHUNK
    assert sort.sort_plan(n, (bound,)).cluster == 0
    tracing.reset_launches()
    got = r.render(scene)
    assert tracing.LAUNCHES["sort"] == 1
    np.testing.assert_array_equal(got, cpu_render_scene(scene, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_cuda_unpacked_render_equals_oracle(fine_impl):
    """A grid whose packed sort key would pass 2^24: the two-key sort on
    the card, both routes, bitwise against the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = fixtures.make_cardioid(center=(512.0, 512.0), r=400.0)
    cfg = dataclasses.replace(fit_capacities(scene, RenderConfig(
        width=1024, height=1024, tile_height=16, tile_width=16)),
        max_items=2048)
    assert cfg.tiles_x * cfg.tiles_y * 2 * (cfg.max_items + 1) >= 2 ** 24
    tracing.reset_launches()
    got = Renderer(cfg, device="cuda", fine_impl=fine_impl).render(scene)
    assert tracing.LAUNCHES["sort"] == 1
    np.testing.assert_array_equal(got, cpu_render_scene(scene, cfg))


def _anim_taps(device):
    """Kernel inputs of one device-animation frame (seg_pre=None), at a
    small size."""
    tmpl = animate.template_scene(size=256, n=24, seed=5)
    cfg = fit_capacities(tmpl, RenderConfig(width=256, height=256,
                                            tile_height=16, tile_width=128),
                         bucket=True)
    base = prepare_scene(tmpl, cfg, device, seg_pre=False)
    params = animate.host_params(size=256, n=24, seed=5, device=device)
    taps = {}
    coarse.coarse_rasterize(
        animate.animate_device_scene(base, params, 0.7),
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_width,
        tile_h=cfg.tile_height, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates, taps=taps)
    return taps


@pytest.mark.cuda
def test_cuda_engines_equal_plain_versions():
    """expand, keyed and gatherm on the animation path's own inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    taps = _anim_taps("cuda")
    assert _same_bits(expand.expand_rows(*taps["expand"]),
                      expand.expand_rows_plain(*taps["expand"]))
    for g, w in zip(keyed.record_keyed_sums(*taps["keyed"]),
                    keyed.record_keyed_sums_plain(*taps["keyed"])):
        assert _same_bits(g, w)
    assert [name for name, _ in taps["gatherm"]] == ["endpoints",
                                                     "backdrop"]
    for name, args in taps["gatherm"]:
        call, plain, streams = gatherm.SITES[name]
        got, want = call(*args), plain(*args)
        for g, w in zip(*((x,) if torch.is_tensor(x) else x
                          for x in (got, want))):
            assert _same_bits(g, w)
        rows, idxs = streams(*args)
        for g, w in zip(gatherm.gather_monotone(rows, idxs),
                        gatherm.gather_monotone_plain(rows, idxs)):
            assert _same_bits(g, w)


@pytest.mark.cuda
def test_cuda_engines_edge_cases():
    """Bit patterns, zero counts, dropped keys and -0.0 sums on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    words = torch.tensor([[0x7FC00001, -2147483648, 1, 0x7F800000],
                          [0x00000003, 0x7FFFFFFF, -1, 0x00800000],
                          [5, 6, 7, 8]], dtype=torch.int32)
    rows = words.view(torch.float32).cuda()
    counts = torch.tensor([2, 0, 3], dtype=torch.int32).cuda()
    got = expand.expand_rows(rows, counts, 8)
    assert _same_bits(got, expand.expand_rows_plain(rows, counts, 8))
    assert torch.equal(got.view(torch.int32)[5:], torch.zeros(
        (3, 4), dtype=torch.int32, device="cuda"))
    vals = torch.tensor([[-0.0], [1.0], [-1.0], [2.0], [-0.0]]).cuda()
    keys = torch.tensor([0, 1, 1, 7, -3], dtype=torch.int32).cuda()
    out = keyed.keyed_sum(vals, keys, 3)
    assert _same_bits(out, keyed.keyed_sum_plain(vals, keys, 3))
    assert out.view(torch.int32).eq(0).all()     # +0.0 everywhere
    idx = (torch.tensor([0, 0, 2, 9], dtype=torch.int32).cuda(),
           torch.tensor([1, 2, 2, 2], dtype=torch.int32).cuda())
    for g, w in zip(gatherm.gather_monotone(rows, idx),
                    gatherm.gather_monotone_plain(rows, idx)):
        assert _same_bits(g, w)


def _keyed_record_case(case, cuda_inputs):
    if case.startswith("synthetic"):
        return keyed_synth_case(case.split(" ", 1)[1], "cuda")
    _, taps, _ = cuda_inputs
    rec, n_live, n_out = taps["keyed"]
    if case == "tiger, stride 0":
        (rows, counts, excl, total), kw = taps["hitfuse"]
        rec = hitfuse.hit_records_fused(rows, counts, excl, total,
                                        **dict(kw, stride=0))
    return rec, n_live, n_out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tiger, stride > 0", "tiger, stride 0"]
                         + [f"synthetic {k}" for k in KEYED_SYNTH])
def test_cuda_keyed_equals_plain(case, cuda_inputs):
    """The keyed kernel against its plain versions: two streams read in
    place from kernel B's records (both key layouts of the record, and the
    synthetic records: keys out of range, -0.0 values, live counts 0, 1,
    cap and past cap) in one launch, and one stream through keyed_sum."""
    rec, n_live, n_out = _keyed_record_case(case, cuda_inputs)
    tracing.reset_launches()
    got = keyed.record_keyed_sums(rec, n_live, n_out)
    assert tracing.LAUNCHES["keyed"] == 1
    want = keyed.record_keyed_sums_plain(rec, n_live, n_out)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert not bool((got[1].view(torch.int32) == -2 ** 31).any())
    for args in keyed.record_streams(rec, n_live, n_out):
        assert _same_bits(keyed.keyed_sum(*args),
                          keyed.keyed_sum_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("words", EXPAND_WORDS)
@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_cuda_expand_equals_plain(case, words):
    """The expand kernel against its plain version: sources owning more
    than a block, zero-count runs, ragged last blocks, totals of 0, 1 and
    cap and past cap, 1-40 words a row (two staging rounds at 40)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, counts, cap = expand_rows_case(case, words)
    rows, counts = torch.from_numpy(rows).cuda(), torch.from_numpy(
        counts).cuda()
    for excl in (None, torch.cumsum(counts, 0, dtype=torch.int32) - counts):
        tracing.reset_launches()
        got = expand.expand_rows(rows, counts, cap, excl)
        assert tracing.LAUNCHES["expand"] == 1
        assert _same_bits(got, expand.expand_rows_plain(rows, counts, cap,
                                                        excl))


def _device_ops(fn):
    """The device ops of one ``fn()``: the kernel, memset and memcpy
    nodes of a CUDA graph of it (renderer/graph.py::device_ops).
    torch.profiler traces dropped kernel records now and then on the
    H100 (a one-kernel call read 0 ops, three calls 1 op in every trace),
    so the exact counts below no longer rest on a trace."""
    fn()
    torch.cuda.synchronize()
    return graph_device_ops(fn)


@pytest.mark.cuda
def test_cuda_engine_calls_are_one_or_two_device_ops(cuda_inputs):
    """expand_rows with its offsets given is one device op (the kernel
    reads the live total itself); both keyed sums are a memset and one
    launch."""
    _, taps, _ = cuda_inputs
    args = _anim_taps("cuda")["expand"]
    ops = _device_ops(lambda: expand.expand_rows(*args))
    assert len(ops) == 1, ops
    ops = _device_ops(lambda: keyed.record_keyed_sums(*taps["keyed"]))
    assert len(ops) == 2, ops


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["entries", "dense"])
def test_cuda_one_keyed_launch_per_coarse_pass(output, cuda_inputs):
    """A coarse pass makes one keyed launch for both sums, host-staged or
    with segments derived on the card."""
    cfg, _, _ = cuda_inputs
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
              tile_w=cfg.tile_width, tile_h=cfg.tile_height,
              max_segments=cfg.max_segments, max_hits=cfg.max_hits,
              max_candidates=cfg.max_candidates, output=output,
              cmd_capacity=cfg.cmd_capacity)
    scene = make_tiger(scale=1.0)
    for seg_pre in (True, False):
        dev = prepare_scene(scene, cfg, "cuda", seg_pre=seg_pre)
        tracing.reset_launches()
        coarse.coarse_rasterize(dev, **kw)
        assert tracing.LAUNCHES["keyed"] == 1, (seg_pre, tracing.LAUNCHES)
        assert tracing.LAUNCHES["expand"] == (0 if seg_pre else 1)


@pytest.mark.cuda
def test_cuda_alpha_linear_is_correctly_rounded():
    """Every alpha code's linear value on the card equals the host
    decode's code / 255 (a division by a host scalar would not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes = torch.arange(256, dtype=torch.int32)
    want = (np.arange(256).astype(np.float32) / np.float32(255.0))
    got = animate.alpha_linear(codes.cuda()).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.0, 1.3])
def test_cuda_animated_frame_equals_oracle(t):
    """A device-animation frame on the card, bitwise against the numpy
    oracle fed the frame's own device-computed arrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tmpl = animate.template_scene(size=256, n=24, seed=5)
    cfg = fit_capacities(tmpl, RenderConfig(width=256, height=256,
                                            tile_height=16, tile_width=128),
                         bucket=True)
    render_t, _ = animate.make_animated_render_fn(cfg, size=256, n=24,
                                                  seed=5, fine_impl="entries")
    tracing.reset_launches()
    img, _ = render_t(t)
    launches = dict(tracing.LAUNCHES)
    assert launches.pop("fine_dense") == 0     # the entries route
    assert launches.pop("dense_tail") == 0
    assert launches.pop("fine_paired") == 0    # an unpaired stream
    assert launches.pop("expand_pairing") == 0
    assert all(v > 0 for k, v in launches.items()
               if k not in probes.KERNELS), tracing.LAUNCHES
    got = img.cpu().numpy().view(np.uint8).reshape(256, 256, 4)
    frame = fetch_scene(render_t.scene_at(t), tmpl.n_items, tmpl.n_points)
    np.testing.assert_array_equal(got, cpu_render_scene(frame, cfg))


@pytest.mark.cuda
def test_cuda_affine_frame_equals_oracle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = fixtures.get_scene("gradients", size=256)
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256,
                                             tile_height=16, tile_width=128),
                         bucket=True)
    cfg = dataclasses.replace(cfg, max_hits=8 * cfg.max_hits,
                              max_candidates=8 * cfg.max_candidates)
    render_t = affine.make_affine_render_fn(
        cfg, scene, lambda t: affine.rotation_about(128.0, 128.0, t, 0.9),
        fine_impl="entries")
    img, _ = render_t(0.5)
    got = img.cpu().numpy().view(np.uint8).reshape(256, 256, 4)
    frame = fetch_scene(render_t.scene_at(0.5), scene.n_items,
                        scene.n_points)
    np.testing.assert_array_equal(got, cpu_render_scene(frame, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("row0", [0, 3, 5])
def test_cuda_slab_bitwise_equals_oracle_rows(row0):
    """The kernels on a tile-row window [row0, row0 + 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = fixtures.get_scene("clip_star")
    r = Renderer.for_scene(scene, 256, 256, device="cuda", tile_height=32,
                           tile_width=128, fine_impl="entries")
    cfg, rows = r.config, 3
    slab = dataclasses.replace(cfg, height=rows * cfg.tile_height)
    sp = build_seg_pre(scene, slab, row0=row0)
    dev = prepare_scene(scene, cfg, "cuda")._replace(seg_pre=coarse.SegPre(*(
        torch.from_numpy(np.ascontiguousarray(getattr(sp, f)).view(np.int32))
        .cuda() for f in coarse.SegPre._fields)))
    img, _ = render_slab(dev, cfg, tiles_y=rows, row0=row0,
                         fine_impl="entries")
    got = img.cpu().numpy().view(np.uint8).reshape(rows * cfg.tile_height,
                                                   -1, 4)
    y0 = row0 * cfg.tile_height
    want = cpu_render_scene(scene, cfg)[y0:y0 + rows * cfg.tile_height]
    np.testing.assert_array_equal(got[:, :cfg.width], want)


CUDA_SCENES = [
    ("tiger_1x", lambda: make_tiger(scale=1.0), 512, 32),
    ("path_test", lambda: fixtures.get_scene("path_test"), 256, 32),
    ("animated", lambda: fixtures.get_scene("animated", size=512), 512, 32),
    ("gradients", lambda: fixtures.get_scene("gradients"), 256, 16),
    ("holes", lambda: fixtures.get_scene("holes"), 256, 16),
    ("star_evenodd", lambda: fixtures.get_scene("star_evenodd"), 256, 32),
    ("clip_star", lambda: fixtures.get_scene("clip_star"), 256, 16),
    ("clipped_demo", lambda: fixtures.get_scene("clipped_demo"), 256, 32),
    ("circles_rects", lambda: fixtures.get_scene(
        "circles_rects", n_circles=200, n_rects=200, size=512), 512, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,size,th", CUDA_SCENES,
                         ids=[s[0] for s in CUDA_SCENES])
def test_cuda_render_bitwise_equals_oracle(name, make, size, th):
    """Every command class through the kernels on the card: fills,
    strokes, circles, solids, clips, layers, gradients, winding carries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make()
    r = Renderer.for_scene(scene, size, size, device="cuda",
                           tile_height=th, tile_width=128,
                           fine_impl="entries")
    tracing.reset_launches()
    got = r.render(scene)
    # render() stages the scene for one frame, which derives its segments
    # on the card (one expansion); the entries route runs no dense
    # interpreter.
    launches = dict(tracing.LAUNCHES)
    assert launches.pop("expand") == 1
    assert launches.pop("fine_dense") == 0
    assert launches.pop("dense_tail") == 0
    assert launches.pop("fine_paired") == 0
    assert launches.pop("expand_pairing") == 0
    assert all(v > 0 for k, v in launches.items()
               if k not in probes.KERNELS), tracing.LAUNCHES
    np.testing.assert_array_equal(got, cpu_render_scene(scene, r.config),
                                  err_msg=name)


DENSE_SCENES = [
    ("tiger_1x", lambda: make_tiger(scale=1.0), 512, 32),
    ("clip_star", lambda: fixtures.make_clip_star(256), 256, 16),
    ("gradient_demo", lambda: fixtures.make_gradient_demo(256), 256, 16),
    ("holes_demo", lambda: fixtures.make_holes_demo(256), 256, 16),
]


def _dense_ptcl(make, size, th, device):
    scene = make()
    cfg = fit_capacities(scene, RenderConfig(width=size, height=size,
                                             tile_height=th, tile_width=128))
    out = coarse.coarse_rasterize(
        prepare_scene(scene, cfg, device), output="dense",
        cmd_capacity=cfg.cmd_capacity, tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y, tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        max_segments=cfg.max_segments, max_hits=cfg.max_hits,
        max_candidates=cfg.max_candidates)
    args = (out.counts.reshape(cfg.tiles_y, cfg.tiles_x), out.tags, out.args)
    kw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              cmd_capacity=cfg.cmd_capacity)
    return scene, cfg, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,size,th", DENSE_SCENES,
                         ids=[s[0] for s in DENSE_SCENES])
def test_cuda_fine_dense_equals_plain(name, make, size, th):
    """Both instantiations of the dense kernel against their plain
    versions on the card, on the dense coarse pass's own PTCL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, args, kw = _dense_ptcl(make, size, th, "cuda")
    tracing.reset_launches()
    assert torch.equal(fine.fine_rasterize(*args, **kw),
                       fine.fine_rasterize_plain(*args, **kw))
    assert torch.equal(fine_xla.fine_rasterize_xla(*args, **kw),
                       fine_xla.fine_rasterize_xla_plain(*args, **kw))
    assert tracing.LAUNCHES["fine_dense"] == 2


@pytest.mark.cuda
def test_cuda_fine_dense_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, (counts, tags, args), kw = _dense_ptcl(
        DENSE_SCENES[1][1], 256, 16, "cuda")
    with pytest.raises(TypeError):
        fine.fine_rasterize(counts, tags.float(), args, **kw)
    with pytest.raises(TypeError):
        fine_xla.fine_rasterize_xla(counts.long(), tags, args, **kw)
    t2 = torch.zeros((tags.shape[1], tags.shape[0]), dtype=torch.int32,
                     device="cuda").t()
    with pytest.raises(ValueError, match="contiguous"):
        fine.fine_rasterize(counts, t2, args, **kw)
    with pytest.raises(ValueError, match="multiple"):
        fine.fine_rasterize(counts, tags, args, **dict(kw, cmd_capacity=100))


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,size,th", DENSE_SCENES,
                         ids=[s[0] for s in DENSE_SCENES])
def test_cuda_dense_render_equals_oracle(name, make, size, th):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make()
    r = Renderer.for_scene(scene, size, size, device="cuda",
                           fine_impl="dense", tile_height=th, tile_width=128)
    tracing.reset_launches()
    got = r.render(scene)
    assert tracing.LAUNCHES["fine_dense"] == 1
    assert tracing.LAUNCHES["fine"] == 0
    assert r.last_stats["overflow_cmds"] == 0
    np.testing.assert_array_equal(got, cpu_render_scene(scene, r.config),
                                  err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,size,th", DENSE_SCENES,
                         ids=[s[0] for s in DENSE_SCENES])
def test_cuda_fine_dense_16x16_equals_plain(name, make, size, th):
    """Both instantiations at 16x16 tiles (4 pixels a thread)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make()
    cfg = fit_capacities(scene, RenderConfig(width=size, height=size,
                                             tile_height=16, tile_width=16))
    out = coarse.coarse_rasterize(
        prepare_scene(scene, cfg, "cuda"), output="dense",
        cmd_capacity=cfg.cmd_capacity, tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y, tile_w=16, tile_h=16,
        max_segments=cfg.max_segments, max_hits=cfg.max_hits,
        max_candidates=cfg.max_candidates)
    args = (out.counts.reshape(cfg.tiles_y, cfg.tiles_x), out.tags, out.args)
    kw = dict(tile_h=16, tile_w=16, cmd_capacity=cfg.cmd_capacity)
    assert torch.equal(fine.fine_rasterize(*args, **kw),
                       fine.fine_rasterize_plain(*args, **kw))
    assert torch.equal(fine_xla.fine_rasterize_xla(*args, **kw),
                       fine_xla.fine_rasterize_xla_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [True, False], ids=["groups", "core"])
@pytest.mark.parametrize("tile_w", [16, 24, 128])
def test_cuda_fine_dense_synthetic_equals_plain(tile_w, groups):
    """Both instantiations on the synthetic PTCLs (raster/synth_ptcl.py):
    group commands first at slots 0, 31, 32, 127 and 128, streaks across
    the chunk boundary, a count above the capacity and a zero count; a
    ragged edge at tile_w 24 (4 pixels a thread)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cap = 256
    args = tuple(torch.from_numpy(a).cuda() for a in synth_dense_ptcl(
        tile_w, tile_w=tile_w, tile_h=16, cap=cap, groups=groups))
    kw = dict(tile_h=16, tile_w=tile_w, cmd_capacity=cap)
    tracing.reset_launches()
    assert torch.equal(fine.fine_rasterize(*args, **kw),
                       fine.fine_rasterize_plain(*args, **kw))
    assert torch.equal(fine_xla.fine_rasterize_xla(*args, **kw),
                       fine_xla.fine_rasterize_xla_plain(*args, **kw))
    assert tracing.LAUNCHES["fine_dense"] == 2


# ---- kernel A and the row gathers on the card ------------------------------

def _cand_scene(case, cuda_inputs):
    """(DeviceScene on the card, rect keywords, candidate capacity)."""
    if case in CAND_SCENES:
        leaves, kw = cand_scene_case(case)
        return device_scene_from_numpy(leaves, "cuda"), kw, 4096
    if case == "tiger":
        cfg, taps, _ = cuda_inputs
        scene, kw = taps["cand_inputs"]
        return scene, kw, cfg.max_candidates
    if case == "tiger, packed views":
        cfg, _, _ = cuda_inputs
        buf = torch.from_numpy(pack_scene(make_tiger(scale=1.0), cfg).view(
            np.int32)).cuda()
        return unpack_scene(buf, cfg), dict(
            tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_width,
            tile_h=cfg.tile_height, row0=0), cfg.max_candidates
    scene = fixtures.get_scene("beziers_10k")
    r = Renderer.for_scene(scene, 1024, 1024, device="cuda")
    c = r.config
    return r.prepare(scene), dict(tiles_x=c.tiles_x, tiles_y=c.tiles_y,
                                  tile_w=c.tile_width, tile_h=c.tile_height,
                                  row0=0), c.max_candidates


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CAND_SCENES) + [
    "tiger", "tiger, packed views", "beziers_10k"])
def test_cuda_cand_inputs_equal_plain(case, cuda_inputs):
    """Kernel A's item rows (cand_prep) against the plain glue -- the
    adversarial scenes (offscreen, negative and reversed bboxes, slabs,
    dead items, NaN patterns, denormal widths, flags with the top bit),
    the tiger, the tiger as views of one packed buffer and beziers_10k's
    14,336 item slots (28 prep blocks) -- and the coarse pass's call (rows and
    expansion, one count) against the plain versions."""
    scene, kw, cap = _cand_scene(case, cuda_inputs)
    tracing.reset_launches()
    got = candfuse.cand_prep(scene, **kw)
    assert tracing.LAUNCHES["candfuse"] == 1
    want = candfuse.cand_inputs_plain(scene, **kw)
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert got.total.shape == (1,) and int(got.total[0]) > 0
    tracing.reset_launches()
    stage = candfuse.cand_prep_expand(scene, cap=cap, **kw)
    assert tracing.LAUNCHES["candfuse"] == 1
    plain = candfuse.cand_records_fused_plain(
        *want, kw["row0"], cap, tiles_x=kw["tiles_x"])
    assert all(_same_bits(g, w) for g, w in zip(stage[0], want))
    assert all(_same_bits(g, w) for g, w in zip(stage[1:], plain[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_cuda_cand_expand_equals_plain(case):
    """Kernel A's expansion alone (cand_records_fused) against its plain
    version: owners of many blocks, zero-count runs, totals of 0, 1, cap
    and past cap, ragged last blocks; cand_tx included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts, cap = EXPAND_CASES[case]
    pack, excl = synth_cand_pack(counts, seed=cap)
    args = [torch.from_numpy(a).cuda() for a in (pack, counts, excl)]
    args.append(torch.tensor([int(counts.sum())], dtype=torch.int32,
                             device="cuda"))
    tracing.reset_launches()
    got = candfuse.cand_records_fused(*args, 3, cap, tiles_x=6)
    assert tracing.LAUNCHES["candfuse"] == 1
    want = candfuse.cand_records_fused_plain(*args, 3, cap, tiles_x=6)
    assert len(got) == len(want) == 4
    assert all(_same_bits(g, w) for g, w in zip(got, want))


def _endpoint_args(case):
    if case.startswith("adversarial"):
        sitem, pts, n_segs = adversarial_sitem(seed=int(case[-1]))
        return [torch.from_numpy(a).cuda() for a in (sitem, pts, n_segs)]
    (_, args), _ = _anim_taps("cuda")["gatherm"]
    sitem, points, n_segs = args
    if case.endswith("4-byte aligned points"):
        # A view one word into a buffer: the 4-byte gather path.
        buf = torch.empty(points.numel() + 1, dtype=torch.float32,
                          device="cuda")
        buf[1:] = points.reshape(-1)
        points = buf[1:].view(-1, 2)
        assert points.data_ptr() % 8
    return [sitem, points, n_segs]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["animated", "animated, 4-byte aligned "
                                  "points", "adversarial 1",
                                  "adversarial 2"])
def test_cuda_gather_endpoints_equal_plain(case):
    """The endpoint fetch against its plain version: the animated
    fixture's segment rows, one-point fills and clips, indices before and
    past the point table, dead slots (+0.0), NaN-pattern points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _endpoint_args(case)
    tracing.reset_launches()
    got = gatherm.gather_endpoints(*args)
    assert tracing.LAUNCHES["gatherm"] == 1
    want = gatherm.gather_endpoints_plain(*args)
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tiger", "synthetic"])
def test_cuda_backdrop_equals_plain(case, cuda_inputs):
    """The backdrop against its plain version: the tiger's running sums,
    and synthetic rows (zero and first-row starts, widths of 0) with -0.0
    and denormal sums."""
    if case == "tiger":
        _, taps, _ = cuda_inputs
        (name, args), = taps["gatherm"]
        assert name == "backdrop"
    else:
        counts, cap = EXPAND_CASES["owners_of_many_blocks"]
        pack, excl = synth_cand_pack(counts, seed=9)
        t = [torch.from_numpy(a).cuda() for a in (pack, counts, excl)]
        total = torch.tensor([int(counts.sum())], dtype=torch.int32,
                             device="cuda")
        ca, _, ty, _ = candfuse.cand_records_fused(*t, total, 0, cap,
                                                   tiles_x=6)
        rng = np.random.default_rng(2)
        csum = rng.integers(-4, 5, cap).astype(np.float32)
        csum[::17] = -0.0
        csum[3::29] = np.float32(1e-45)
        args = (torch.from_numpy(csum).cuda(), ca, ty)
    tracing.reset_launches()
    got = gatherm.backdrop_from_csum(*args)
    assert tracing.LAUNCHES["gatherm"] == 1
    assert _same_bits(got, gatherm.backdrop_from_csum_plain(*args))


@pytest.mark.cuda
def test_cuda_gather_monotone_piece_widths():
    """The generic gather in 16-, 8- and 4-byte pieces: 32-, 2- and 3-word
    rows, one to four streams, rows that are a view one word in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for words, offset, k in ((32, 0, 4), (2, 0, 2), (3, 0, 3), (32, 1, 1),
                             (2, 1, 4)):
        buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (700 * words + 1,),
                            generator=gen, device="cuda", dtype=torch.int32)
        rows = buf[offset:offset + 700 * words].view(700, words)
        idxs = tuple(torch.randint(-5, 710, (900,), generator=gen,
                                   device="cuda", dtype=torch.int32)
                     for _ in range(k))
        got = gatherm.gather_monotone(rows, idxs)
        want = gatherm.gather_monotone_plain(rows, idxs)
        assert len(got) == k
        assert all(_same_bits(g, w) for g, w in zip(got, want)), words


@pytest.mark.cuda
def test_cuda_candfuse_and_gatherm_device_ops(cuda_inputs):
    """Each gatherm call is one device op; kernel A's item rows are one
    (one prep block: the tiger's 512 item slots) or two (cand_count
    first: beziers_10k's 28 blocks), and the coarse pass's call (rows and
    expansion) one more.  Counted over three back-to-back calls in one
    captured graph."""
    _, taps, _ = cuda_inputs
    scene, kw = taps["cand_inputs"]
    assert scene.tags.shape[0] <= candfuse.PREP_ITEMS
    cap = taps["candfuse"][1]["cap"]
    bez, bez_kw, bez_cap = _cand_scene("beziers_10k", cuda_inputs)
    assert bez.tags.shape[0] > candfuse.PREP_ITEMS
    (_, bargs), = taps["gatherm"]
    (_, eargs), _ = _anim_taps("cuda")["gatherm"]
    rows, idxs = gatherm.endpoint_streams(*eargs)
    for name, fn, per_call in (
            ("cand_prep", lambda: candfuse.cand_prep(scene, **kw), 1),
            ("cand_prep_expand",
             lambda: candfuse.cand_prep_expand(scene, cap=cap, **kw), 2),
            ("cand_prep, beziers_10k",
             lambda: candfuse.cand_prep(bez, **bez_kw), 2),
            ("cand_prep_expand, beziers_10k",
             lambda: candfuse.cand_prep_expand(bez, cap=bez_cap, **bez_kw),
             3),
            ("backdrop", lambda: gatherm.backdrop_from_csum(*bargs), 1),
            ("endpoints", lambda: gatherm.gather_endpoints(*eargs), 1),
            ("gather_monotone",
             lambda: gatherm.gather_monotone(rows, idxs), 1)):
        ops = _device_ops(lambda: [fn() for _ in range(3)])
        assert len(ops) == 3 * per_call, (name, ops)


# ---- the frame as one CUDA graph (renderer/graph.py) ----------------------

def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_cuda_graph_replay_equals_eager(fine_impl):
    """The replayed frame equals the eager render_slab frame bit for bit,
    stats included, on a host-staged and a device-derived segment stage;
    the returned image is a fresh tensor."""
    _needs_cuda()
    scene = make_tiger(scale=1.0)
    r = Renderer.for_scene(scene, 512, 512, device="cuda",
                           fine_impl=fine_impl)
    render = make_render_fn(r.config, fine_impl=fine_impl)
    for seg_pre in (True, False):
        dev = prepare_scene(scene, r.config, "cuda", seg_pre=seg_pre)
        img, stats = render(dev)
        want, want_stats = r.render_device(dev)
        assert torch.equal(img, want)
        assert {k: int(v) for k, v in stats.items()} == {
            k: int(v) for k, v in want_stats.items()}
        img2, _ = render(dev)
        assert torch.equal(img2, img)
        assert img2.data_ptr() != img.data_ptr()
    assert render.n_graphs() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_cuda_graph_two_replays_beziers(fine_impl):
    """beziers_10k at 1024^2: the sort's device-memory route (a memset of
    its counters and programmatic dependent launches) and keyed's memset
    inside the graph: two replays in a row give the eager frame."""
    _needs_cuda()
    scene = fixtures.get_scene("beziers_10k")
    r = Renderer.for_scene(scene, 1024, 1024, device="cuda",
                           fine_impl=fine_impl)
    cfg = r.config
    assert sort.sort_plan(cfg.max_hits + cfg.max_candidates, (
        cfg.n_tiles * 2 * (cfg.max_items + 1),)).cluster == 0
    render = make_render_fn(cfg, fine_impl=fine_impl)
    dev = render.stage(prepare_scene(scene, cfg, "cuda"))
    a, _ = render(dev)
    b, _ = render(dev)
    want, _ = r.render_device(dev)
    assert torch.equal(a, want) and torch.equal(b, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_cuda_render_updated_equals_fresh_render(fine_impl):
    """render_updated copies moved points into the graph's static inputs,
    whose segments the graph derives on the card: the replay equals a
    fresh render."""
    _needs_cuda()
    scene = fixtures.make_animated_frame(0.3, size=256, n=24)
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256,
                                             tile_height=16, tile_width=128),
                         bucket=True)
    r = Renderer(cfg, "cuda", fine_impl=fine_impl)
    r.render_u32(scene)
    moved = dataclasses.replace(scene, points=scene.points + 2.0,
                                bboxes=scene.bboxes + 2)
    got = r.render_updated(moved)
    assert r._render.n_graphs() == 1
    fresh = Renderer(cfg, "cuda", fine_impl=fine_impl)
    assert torch.equal(got, fresh.render_u32(moved))
    np.testing.assert_array_equal(r._rgba8(got), cpu_render_scene(moved, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_cuda_launches_count_replays(fine_impl):
    """LAUNCHES after N replays is N times the launches the capture
    recorded; the warm-up and the capture add nothing."""
    _needs_cuda()
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512),
                         bucket=True)
    render = make_render_fn(cfg, fine_impl=fine_impl)
    dev = prepare_scene(scene, cfg, "cuda")
    tracing.reset_launches()
    render(dev)
    (entry,) = render.step._entries.values()
    captured = entry.launches
    route = "fine" if fine_impl == "entries" else "fine_dense"
    assert captured[route] == captured["keyed"] == captured["sort"] == 1
    assert dict(tracing.LAUNCHES) == captured
    for _ in range(4):
        render(dev)
    assert tracing.LAUNCHES == {k: 5 * n for k, n in captured.items()}


PAIR_SCENES = [
    ("tiger_1x", lambda: make_tiger(scale=1.0), 512, 32, 128),
    ("tiger_1x, 16x16 tiles", lambda: make_tiger(scale=1.0), 512, 16, 16),
    ("clip_star", lambda: fixtures.get_scene("clip_star"), 256, 16, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["compact", "hole"])
@pytest.mark.parametrize("name,make,size,th,tw", PAIR_SCENES,
                         ids=[s[0] for s in PAIR_SCENES])
def test_cuda_paired_fine_equals_plain(name, make, size, th, tw, mode,
                                       monkeypatch):
    """Kernel D's paired instantiation against its plain version on the
    card, on paired streams (F2 and L2 entries, holes, group commands)
    and on the synthetic streams of raster/synth_entries.py (streaks
    across the chunk boundary, holes, the state copy at a begin clip;
    their unpaired stream through run dispatch), each also against the
    numpy oracle; pairing's compaction (its own kernel) against its
    scatter and gather; the paired frame against the oracle."""
    _needs_cuda()
    for seed, stw in ((0, 128), (1, 16)):
        syn = synth_entry_streams(seed, tile_w=stw)
        for smode in ("off", mode):
            st = syn.streams[smode]
            sargs = tuple(torch.from_numpy(x).cuda() for x in (
                st.first, st.n_entries, np.zeros_like(st.first), st.stream))
            skw = dict(tile_h=syn.tile_h, tile_w=syn.tile_w,
                       tiles_x=syn.tiles_x, paired=smode != "off")
            tracing.reset_launches()
            sgot = fine.fine_rasterize_entries(*sargs, **skw)
            assert tracing.LAUNCHES["fine_paired" if smode != "off"
                                    else "fine"] == 1
            assert torch.equal(sgot, fine.fine_rasterize_entries_plain(
                *sargs, **skw)), (seed, stw, smode)
            np.testing.assert_array_equal(
                sgot.cpu().numpy().view(np.uint8).reshape(syn.oracle.shape),
                syn.oracle, err_msg=f"{seed} {stw} {smode}")
    from piet_tpu_torch.ops import pairing
    scene = make()
    cfg = fit_capacities(scene, RenderConfig(width=size, height=size,
                                             tile_height=th, tile_width=tw),
                         bucket=True)
    taps = {}
    ce = coarse.coarse_rasterize(
        prepare_scene(scene, cfg, "cuda"), tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y, tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        max_segments=cfg.max_segments, max_hits=cfg.max_hits,
        max_candidates=cfg.max_candidates, pair=mode, taps=taps)
    args = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
            ce.stream, 0)
    kw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              tiles_x=cfg.tiles_x, paired=True)
    tracing.reset_launches()
    got = fine.fine_rasterize_entries(*args, **kw)
    assert tracing.LAUNCHES["fine_paired"] == 1
    assert tracing.LAUNCHES["fine"] == 0
    assert torch.equal(got, fine.fine_rasterize_entries_plain(*args, **kw))
    if mode == "compact":
        bundle, keep = taps["pairing"]
        got, total = pairing.compact_rows(bundle, keep)
        want, want_total = pairing.compact_rows_plain(bundle, keep)
        assert torch.equal(got, want) and torch.equal(total, want_total)
    monkeypatch.setenv("PIET_PAIR", mode)
    r = Renderer(cfg, "cuda", fine_impl="entries")
    tracing.reset_launches()
    np.testing.assert_array_equal(r.render(scene),
                                  cpu_render_scene(scene, cfg))
    assert tracing.LAUNCHES["expand_pairing"] == (mode == "compact")
    assert tracing.LAUNCHES["expand"] == 1
    assert tracing.LAUNCHES["fine_paired"] == 1
    assert tracing.LAUNCHES["fine"] == 0


#: The compaction's cases on the card: which rows are kept and E (blocks
#: of 512 rows; the tiger's compact pass has E = 67,584).
CUDA_COMPACT_CASES = [("all kept", 1100), ("none kept", 1100),
                      ("last kept", 1100), ("first kept", 513),
                      ("random", 1), ("random", 1537),
                      ("random", 67_584), ("random", 368_640)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,E", CUDA_COMPACT_CASES,
                         ids=[f"{c}-{e}" for c, e in CUDA_COMPACT_CASES])
def test_cuda_compaction_equals_plain(case, E):
    """Pairing's compaction kernel against its plain version (the scatter
    and gather), rows and total, bit for bit; one launch counted under
    "expand_pairing", two device ops (its two launches), no expand."""
    _needs_cuda()
    from piet_tpu_torch.ops import pairing
    g = torch.Generator(device="cuda").manual_seed(E)
    bundle = torch.randint(-2 ** 31, 2 ** 31 - 1, (E, pairing.ROW_WORDS),
                           generator=g, device="cuda", dtype=torch.int32)
    idx = torch.arange(E, device="cuda")
    keep = {"all kept": idx >= 0, "none kept": idx < 0,
            "last kept": idx == E - 1, "first kept": idx == 0}.get(
        case, torch.rand(E, generator=g, device="cuda") < 0.35)
    tracing.reset_launches()
    got, total = pairing.compact_rows(bundle, keep)
    assert tracing.LAUNCHES["expand_pairing"] == 1
    assert tracing.LAUNCHES["expand"] == 0
    want, want_total = pairing.compact_rows_plain(bundle, keep)
    assert torch.equal(got, want) and torch.equal(total, want_total)
    assert total.shape == () and int(total) == int(keep.sum())
    ops = _device_ops(lambda: pairing.compact_rows(bundle, keep))
    assert ops == ["kernel", "kernel"], ops
    with pytest.raises(ValueError):
        pairing.compact_rows(bundle[:, :16].contiguous(), keep)
    with pytest.raises(TypeError):
        pairing.compact_rows(bundle, keep.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
@pytest.mark.parametrize("n,interleave", [(4, 1), (2, 2)])
def test_cuda_sharded_frame_equals_one_slab(n, interleave, fine_impl):
    """Row slabs on one card (each mesh's slabs one CUDA graph, segments
    derived at each slab's row0): the frame equals the one-slab frame and
    the oracle, bit for bit."""
    _needs_cuda()
    from piet_tpu_torch.parallel import ShardedRenderer
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512,
                                             tile_height=16, tile_width=128),
                         bucket=True)
    one = Renderer(cfg, "cuda", fine_impl=fine_impl).render(scene)
    sr = ShardedRenderer(cfg, ["cuda:0"] * n, fine_impl=fine_impl,
                         interleave=interleave)
    tracing.reset_launches()
    got = sr.render(scene)
    assert tracing.LAUNCHES["expand"] == n * interleave
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(got, cpu_render_scene(scene, cfg))
    assert sr._render.n_graphs() == 1
    assert np.array_equal(sr.render(scene), got)


@pytest.mark.cuda
def test_cuda_dryrun_multichip():
    _needs_cuda()
    from piet_tpu_torch import entry
    entry.dryrun_multichip(4)


@pytest.mark.cuda
@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_cuda_sharded_frame_on_two_cards(fine_impl):
    """Row slabs on two cards (cuda:0 and cuda:1, two slabs each): each
    card's slabs are one CUDA graph on that card, and the gathered frame
    equals the one-slab frame and the oracle, bit for bit."""
    _needs_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from piet_tpu_torch.parallel import ShardedRenderer
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512,
                                             tile_height=16, tile_width=128),
                         bucket=True)
    one = Renderer(cfg, "cuda:0", fine_impl=fine_impl).render(scene)
    for mesh, il in ((["cuda:0", "cuda:1"], 1),
                     (["cuda:0", "cuda:1", "cuda:0", "cuda:1"], 1),
                     (["cuda:1", "cuda:0"], 2)):
        sr = ShardedRenderer(cfg, mesh, fine_impl=fine_impl, interleave=il)
        tracing.reset_launches()
        got = sr.render(scene)
        assert tracing.LAUNCHES["expand"] == len(mesh) * il, mesh
        np.testing.assert_array_equal(got, one, err_msg=str(mesh))
        np.testing.assert_array_equal(got, cpu_render_scene(scene, cfg))
        assert sr._render.n_graphs() == 2
        assert np.array_equal(sr.render(scene), got)
    # The eager reference on the second card.
    r1 = Renderer(cfg, "cuda:1", fine_impl=fine_impl)
    img, _ = r1.render_device(r1.prepare(scene))
    np.testing.assert_array_equal(
        img.cpu().numpy().view(np.uint8).reshape(512, 512, 4), one)


# ---- the tools' kernels (csrc/probes.cu) ---------------------------------

@pytest.mark.cuda
def test_cuda_probe_div_equals_plain_and_numpy():
    """probe_numerics' division op, launched by probe_div and counted as
    "probe_div", on the tool's 2^20 operands and on a ragged cut of them
    (1027 words: the last thread's 3 words one by one): bitwise torch's
    division and numpy's IEEE quotient (-prec-div=true)."""
    _needs_cuda()
    from piet_tpu_torch.tools import div_probe
    a, b = div_probe.operands()
    for n in (a.size, 1027):
        an, bn = a.reshape(-1)[:n].copy(), b.reshape(-1)[:n].copy()
        at, bt = torch.from_numpy(an).cuda(), torch.from_numpy(bn).cuda()
        tracing.reset_launches()
        got = probes.probe_div(at, bt)
        assert tracing.LAUNCHES["probe_div"] == 1
        assert tracing.LAUNCHES["probe_numerics"] == 0
        assert _same_bits(got, probes.probe_div_plain(at, bt))
        assert _same_bits(got, probes.probe_numerics("div", at, bt))
        assert _same_bits(got.cpu(), torch.from_numpy(an / bn))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(probes.NUMERICS_OPS))
def test_cuda_probe_numerics_ragged_tail(name):
    """Each op on 1027 and 3 words of the tool's (16, 128) inputs: the
    words past the last multiple of 4 taken one by one, bitwise the plain
    version."""
    _needs_cuda()
    from piet_tpu_torch.tools import mosaic_numerics_probe as mnp
    batches = mnp.inputs([name])[name, (16, 128)]
    for n in (1027, 3):
        ins = [torch.from_numpy(np.stack(c)).reshape(-1)[:n].clone().cuda()
               for c in zip(*batches)]
        assert _same_bits(probes.probe_numerics(name, *ins),
                          probes.probe_numerics_plain(name, *ins)), n


@pytest.mark.cuda
def test_cuda_probes_raise_on_misaligned_operands():
    """The 16-byte loads need 16-byte aligned operands: a view one word
    into its storage raises ValueError, and nothing falls back."""
    _needs_cuda()
    x = torch.rand(2 * 1024 + 16, device="cuda")
    a, b = x[1:1025], x[1025:2049]
    assert a.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        probes.probe_div(a, x[:1024])
    with pytest.raises(ValueError, match="aligned"):
        probes.probe_numerics("lerp", x[:1024], b, x[1024:2048])
    d = torch.rand(257 * 16, device="cuda")[1:1 + 256 * 16].view(256, 16)
    with pytest.raises(ValueError, match="aligned"):
        probes.probe_delivery(d, "smem", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(probes.NUMERICS_OPS))
def test_cuda_probe_numerics_equals_plain_and_mirror(name):
    """Each op on the tool's inputs (16 batches, both shapes): bitwise
    its plain version on the card and the tool's strict numpy mirror."""
    _needs_cuda()
    from piet_tpu_torch.tools import mosaic_numerics_probe as mnp
    for (_, shape), batches in mnp.inputs([name]).items():
        got = mnp.run(name, batches, device="cuda")
        ins = [torch.from_numpy(np.stack(c)).cuda() for c in zip(*batches)]
        want = probes.probe_numerics_plain(name, *ins).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert mnp.compare(name, batches, got)[0] == 0, (name, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 128), (32, 128)])
@pytest.mark.parametrize("kind", list(probes.HALFMIX_KINDS))
def test_cuda_probe_halfmix_equals_plain(kind, shape):
    _needs_cuda()
    init = probes.halfmix_init(shape[0], "cuda")
    got = probes.probe_halfmix(init, kind, 3, 300)
    want = probes.probe_halfmix_plain(init, kind, 3, 300)
    assert got.shape == (3,) + shape
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 3])
@pytest.mark.parametrize("variant", list(probes.DELIVERY_VARIANTS))
def test_cuda_probe_delivery_equals_plain(variant, tiles):
    """256 entries of the tool's stream and of a mixed one (windows that
    fit, tag-3 entries), 2 passes; the dispatch variant also on the tool
    stream's first 87 entries, whose last is a tag-3 entry (the state
    ends finite).  Every tile's state bitwise the plain version and its
    count of chain updates delivery_passes'."""
    _needs_cuda()
    from piet_tpu_torch.tools import arg_delivery_bench
    d = arg_delivery_bench.data(256, device="cuda")
    cases = [d, arg_delivery_bench.mixed_data(256, "cuda")]
    if variant == "disp16":
        cases.append(d[:87].clone())
    for x in cases:
        got, passes = probes.probe_delivery(x, variant, 2, tiles)
        want, want_passes = probes.probe_delivery_plain(x, variant, 2, tiles)
        assert got.shape == want.shape == (tiles,) + want.shape[1:]
        assert _same_bits(got, want)
        assert passes.tolist() == want_passes.tolist() == (
            [probes.delivery_passes(x, variant, 2)] * tiles)
        if variant != "disp16" or x is not d:
            assert torch.isfinite(got).all()


# ---- the access-pattern probes (csrc/mosaic_probe.cu) ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fill", probes.FILLS)
def test_cuda_probe_mosaic_equals_plain(fill):
    """Every probe of the tool at both fills of its unwritten scratch:
    the kernel, one launch a probe, bitwise its plain version on the card
    and on the CPU (NaN words included)."""
    _needs_cuda()
    from piet_tpu_torch.tools import mosaic_probe
    tracing.reset_launches()
    for name in probes.MOSAIC_PROBES:
        x = torch.from_numpy(mosaic_probe.probe_input(name)).cuda()
        got = probes.probe_mosaic(name, x, fill)
        assert _same_bits(got, probes.probe_mosaic_plain(name, x, fill)), name
        assert _same_bits(got.cpu(),
                          probes.probe_mosaic_plain(name, x.cpu(), fill)), name
    assert tracing.LAUNCHES["probe_mosaic"] == len(probes.MOSAIC_PROBES)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["all", "few", "one"])
def test_cuda_probe_mosaic_batch_equals_plain(batch):
    """The batched launch at every mask the tool uses (all 22 probes, and
    the probes a run names: a few, one) at both fills and at each alone:
    one launch a call, every probe's slice bitwise its plain version on
    the card and on the CPU (NaN words included)."""
    _needs_cuda()
    from piet_tpu_torch.tools import mosaic_probe
    names = {"all": list(probes.MOSAIC_PROBES),
             "few": ["roll_dynamic", "stack_scalars", "rmw_dyn_row",
                     "splat11", "dyn2_read"],
             "one": ["dynsub_statlane"]}[batch]
    x = torch.from_numpy(mosaic_probe.probe_input(names[0])).cuda()
    fill_sets = (probes.FILLS, (probes.FILLS[0],), (probes.FILLS[1],))
    tracing.reset_launches()
    for fills in fill_sets:
        got = probes.probe_mosaic_batch(names, x, fills)
        torch.cuda.synchronize()
        assert got.shape == (len(fills), len(names), 8, 128)
        for f, fill in enumerate(fills):
            for j, name in enumerate(names):
                assert _same_bits(got[f, j], probes.probe_mosaic_plain(
                    name, x, fill)), (name, fill)
                assert _same_bits(got[f, j].cpu(), probes.probe_mosaic_plain(
                    name, x.cpu(), fill)), (name, fill)
    assert tracing.LAUNCHES["probe_mosaic"] == len(fill_sets)


@pytest.mark.cuda
def test_cuda_probe_dma16_equals_plain():
    """The four bulk copies into slot 1 in shared memory: t[1, 3, 3] of
    arange(1024 * 16) is 6195 at both fills; random rows at both fills,
    bitwise."""
    _needs_cuda()
    x = torch.arange(1024 * 16, dtype=torch.float32).reshape(1024, 16).cuda()
    for fill in probes.FILLS:
        assert (probes.probe_dma16(x, fill) == 6195.0).all()
    x = torch.randn(1024, 16).cuda()
    for fill in probes.FILLS:
        assert _same_bits(probes.probe_dma16(x, fill),
                          probes.probe_dma16_plain(x, fill))
