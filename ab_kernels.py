#!/usr/bin/env python3
"""Time the port's fine, hit-record, sort, keyed, expand, candfuse and
gatherm kernels of two source trees on one CUDA card, in turns, and
print each tree's compiler statistics.

    python3 ab_kernels.py ROOT_A ROOT_B
    python3 ab_kernels.py --ptxas ROOT
    python3 ab_kernels.py --sort-variants ROOT
    python3 ab_kernels.py --cand-variants ROOT

ROOT_A and ROOT_B are checkouts of this repository (e.g. a parent commit
unpacked with ``git archive`` into a gitignored directory, and the working
tree).  It runs A, B, B, A, every run in a process of its own that
imports ``piet_tpu_torch`` from its root, builds its kernels there and
times, on the static 1664^2 tiger (32x128 tiles) with CUDA events around
20 back-to-back calls behind a GPU spin:

  fine_dense   the dense interpreter, group instantiation (the dense
               frame's call) and non-group, on the frame's dense PTCL, and
               the group one at 16x16 tiles;
  hitfuse      kernel B on the frame's inputs;
  fine         kernel D on the frame's entry stream, and at 16x16 tiles;
  candfuse     kernel A as the tree's coarse pass calls it (the item rows
               and their expansion: one call where the tree has
               ``coarse.cand_stage``, else ``cand_inputs``' glue and
               ``cand_records_fused``), and the expansion alone, each with
               its device ops;

and counts the device ops of one static frame on each route
(torch.profiler).  On the affine-spun tiger at 1664^2 (t = 23/60, the
frame chip_smoke.py's engines are timed on; each tree's own
``chip_smoke.affine_tiger``), the engines of the coarse pass:

  keyed        all of a frame's keyed work as the tree's coarse pass
               calls it (one call on kernel B's records where the tree
               has ``record_keyed_sums``, else the glue and two
               ``keyed_sum`` calls), and the two sums as two
               ``keyed_sum`` calls without the glue;
  expand       ``expand_rows`` on the frame's item rows;
  gatherm      a frame's endpoint fetch and backdrop as the tree's coarse
               pass makes them (one call each where the tree has
               ``gatherm.gather_endpoints``, else the index glue, two
               ``gather_monotone`` calls and the masks), with their device
               ops, and the two ``gather_monotone`` calls alone on the same
               index streams;

and the device ops of an affine-tiger and an animated-fixture frame.
Then kernel C's device-memory route (above 196,608
pairs): the sort of beziers_10k's keys at 1024^2 (261,504 pairs with the
fitted capacities, 368,640 bucketed) and of 2^20 random pairs (seed 4),
each beside torch.sort on the same first key, and the beziers_10k frame (bucketed) on both routes: latency (median of
20 frames, CUDA events around each call), device busy per frame and
device ops per frame (torch.profiler over 10 frames).  Then ``nvcc
-Xptxas -v`` on each tree's fine_dense.cu, hitfuse.cu, fine.cu, sort.cu,
keyed.cu, expand.cu, candfuse.cu and gatherm.cu, with the build's flags: registers, spill bytes and
shared memory per kernel.  ``--sort-variants`` builds design variants of ROOT's
csrc/sort.cu (each a text substitution that must match the source once;
see SORT_VARIANTS), loads each library with ctypes and times its
device-memory route in turns on the same cases -- beziers_10k's keys at
both sizes, 2^20 random pairs with one and two keys -- beside torch.sort,
each bitwise against the plain sort (one variant skips the look-back and
is timed only), then each kernel's device time per call
(torch.profiler).  ``--cand-variants`` does the same for csrc/candfuse.cu
(CAND_VARIANTS): each variant's item rows alone and the coarse pass's call
(rows and expansion) on the static 1664^2 tiger, on beziers_10k at
1024^2 and on beziers_10k's items repeated to CAND_REPEATS item slots, in
turns, each compared bitwise with the plain version (the variants that
skip work are timed only) and beside the plain version's time.  Every line names the card and
its power limit.  Needs
one card; exits non-zero without one.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

SPIN_CYCLES = 50_000_000


def time_ms(fn, reps=20):
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls: CUDA
    events around the batch, enqueued behind a GPU spin."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_variants(kernels, source: str, variants: dict, entries):
    """Each variant of csrc/``source`` (text substitutions that must each
    match the source once), built into a shared library of its own (one
    nvcc each, all at once) and loaded with ctypes, its C ``entries``
    typed.  Returns ({name: library}, {name: source text})."""
    import ctypes
    src = (kernels.CSRC / source).read_text()
    out_dir = kernels.BUILD_DIR / f"{source.split('.')[0]}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, texts = {}, {}
    for k, (name, subs) in enumerate(variants.items()):
        text = src
        for a, b in subs:
            assert text.count(a) == 1, (name, a)
            text = text.replace(a, b)
        texts[name] = text
        (out_dir / f"v{k}.cu").write_text(text)
        cmds[name] = [kernels._nvcc()] + kernels.NVCC_FLAGS + [
            "-I", str(kernels.CSRC), "-shared", "-o",
            str(out_dir / f"v{k}.so"), str(out_dir / f"v{k}.cu")]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, c in cmds.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(cmds[name][-2])
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs, texts


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from piet_tpu_torch import kernels
    from piet_tpu_torch.host import make_tiger
    from piet_tpu_torch.ops import coarse, fine, fine_xla, hitfuse, sort
    from piet_tpu_torch.scene import fixtures
    from piet_tpu_torch.renderer.renderer import (Renderer,
                                                  _solid_to_present_u32)
    assert kernels.__file__.startswith(os.path.abspath(root)), kernels.__file__
    kernels.library()
    dev = torch.device("cuda")

    def device_ops(render_one):
        render_one()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render_one()
            torch.cuda.synchronize()
        return sum(e.device_type == DeviceType.CUDA for e in prof.events())

    def frame_profile(render_one, frames=10):
        """(median ms of 20 frames, CUDA events around each call; device
        busy ms per frame and device ops per frame over ``frames``)."""
        for _ in range(3):
            render_one()
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render_one()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                render_one()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / frames
        return statistics.median(times), busy, len(kern) / frames

    scene = make_tiger()
    out = {}
    for th, tw, tag in ((32, 128, ""), (16, 16, " 16x16")):
        r = Renderer.for_scene(scene, 1664, 1664, tile_height=th,
                               tile_width=tw, device=dev)
        cfg = r.config
        d = r.prepare(scene)
        kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                  tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                  max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                  max_candidates=cfg.max_candidates)
        taps = {}
        ce = coarse.coarse_rasterize(d, taps=taps, **kw)
        dense = coarse.coarse_rasterize(d, output="dense",
                                        cmd_capacity=cfg.cmd_capacity, **kw)
        dargs = (dense.counts.reshape(cfg.tiles_y, cfg.tiles_x), dense.tags,
                 dense.args)
        dkw = dict(tile_h=th, tile_w=tw, cmd_capacity=cfg.cmd_capacity)
        fargs = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
                 ce.stream)
        fkw = dict(tile_h=th, tile_w=tw, tiles_x=cfg.tiles_x)
        out["fine_dense group" + tag] = time_ms(
            lambda: fine_xla.fine_rasterize_xla(*dargs, **dkw))
        out["fine" + tag] = time_ms(
            lambda: fine.fine_rasterize_entries(*fargs, **fkw))
        if tag:
            continue
        out["fine_dense non-group"] = time_ms(
            lambda: fine.fine_rasterize(*dargs, **dkw))
        hargs, hkw = taps["hitfuse"]
        out["hitfuse"] = time_ms(
            lambda: hitfuse.hit_records_fused(*hargs, **hkw))
        out.update(kernel_a(d, cfg, taps, device_ops))
        for impl in ("entries", "dense"):
            rr = Renderer(cfg, dev, fine_impl=impl)
            out[f"device ops, {impl} frame"] = device_ops(
                lambda: rr.render_device(d))
    out.update(engines(root, scene, dev, device_ops))
    bez = fixtures.get_scene("beziers_10k")
    for bucket, tag in ((False, "261504 beziers fitted"),
                        (True, "368640 beziers bucketed")):
        r = Renderer.for_scene(bez, 1024, 1024, device=dev, bucket=bucket)
        cfg = r.config
        d = r.prepare(bez)
        taps = {}
        coarse.coarse_rasterize(
            d, taps=taps, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            tile_w=cfg.tile_width, tile_h=cfg.tile_height,
            max_segments=cfg.max_segments, max_hits=cfg.max_hits,
            max_candidates=cfg.max_candidates)
        keys, val, bounds = taps["sort"]
        assert val.shape[0] == int(tag.split()[0]), val.shape
        out[f"sort {tag}"] = time_ms(
            lambda: sort.stable_sort_multi(keys, val, bounds))
        out[f"torch.sort {tag}"] = time_ms(
            lambda: torch.sort(keys[0], stable=True))
        if not bucket:
            continue
        for impl in ("entries", "dense"):
            rr = Renderer(cfg, dev, fine_impl=impl)
            lat, busy, ops = frame_profile(lambda: rr.render_device(d))
            out[f"beziers frame {impl}, latency ms"] = lat
            out[f"beziers frame {impl}, device busy ms"] = busy
            out[f"beziers frame {impl}, device ops"] = ops
    gen = torch.Generator(device=dev).manual_seed(4)
    n = 1 << 20
    key = torch.randint(0, 2 ** 24, (n,), generator=gen,
                        device=dev).to(torch.float32)
    key[torch.rand(n, generator=gen, device=dev) < 0.2] = float("inf")
    val = torch.arange(n, dtype=torch.int32, device=dev)
    out["sort 1048576 random"] = time_ms(
        lambda: sort.stable_sort_multi((key,), val))
    out["torch.sort 1048576 random"] = time_ms(
        lambda: torch.sort(key, stable=True))
    print("AB " + json.dumps(out), flush=True)


def kernel_a(d, cfg, taps, device_ops) -> dict:
    """Kernel A on the static tiger, as the tree's coarse pass calls it and
    its expansion alone."""
    from piet_tpu_torch.ops import candfuse, coarse
    rk = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
              tile_w=cfg.tile_width, tile_h=cfg.tile_height, row0=0)
    cap = cfg.max_candidates
    if hasattr(coarse, "cand_stage"):
        def call():
            return coarse.cand_stage(d, cap=cap, **rk)
    else:
        def call():
            ci = coarse.cand_inputs(d, **rk)
            return candfuse.cand_records_fused(
                ci.cand_pack, ci.counts, ci.excl, ci.total, 0, cap,
                tiles_x=cfg.tiles_x)
    ci, akw = taps["candfuse"]
    return {
        "candfuse, item rows and expansion as the coarse pass calls them":
            time_ms(call),
        "device ops, candfuse as the coarse pass calls it": device_ops(call),
        "candfuse, expansion alone": time_ms(
            lambda: candfuse.cand_records_fused(*ci, **akw)),
    }


def _glue_endpoints(gatherm, sitem, points, n_segs):
    """The endpoint fetch as the coarse pass made it before it was one
    call: the index streams, gather_monotone, the masks."""
    import torch
    from piet_tpu_torch.scene.scene import TAG_CLIP, TAG_FILL
    i32 = torch.int32
    S = sitem.shape[0]
    np_max = points.shape[0] - 1
    seg_idx = torch.arange(S, dtype=i32, device=sitem.device)
    seg_valid = seg_idx < n_segs
    seg_local = seg_idx - sitem[:, 10]
    s_tag = sitem[:, 0]
    i0 = sitem[:, 2] + seg_local
    wrap = (((s_tag == TAG_FILL) | (s_tag == TAG_CLIP))
            & (seg_local + 1 == sitem[:, 1]))
    i0_g = torch.where(seg_valid, torch.clamp(i0, 0, np_max), np_max)
    j1_g = torch.where(seg_valid, torch.clamp(i0 + 1, 0, np_max), np_max)
    p0e, p1n = gatherm.gather_monotone(points, (i0_g, j1_g))
    p1e = torch.where(wrap[:, None], sitem.view(torch.float32)[:, 12:14],
                      p1n)
    return (torch.where(seg_valid[:, None], p0e, 0.0),
            torch.where(seg_valid[:, None], p1e, 0.0)), (i0_g, j1_g)


def _glue_backdrop(gatherm, csum, ca_i, cand_ty):
    """The backdrop as the coarse pass made it before it was one call."""
    import torch
    cap = csum.shape[0]
    crs = ca_i[:, 18] + (cand_ty - ca_i[:, 20]) * torch.clamp(ca_i[:, 23],
                                                             min=1)
    sb_idx = torch.clamp(crs - 1, 0, cap - 1)
    (sb,) = gatherm.gather_monotone(csum[:, None], (sb_idx,))
    return csum - torch.where(crs > 0, sb[:, 0], 0.0), sb_idx


def engines(root, scene, dev, device_ops) -> dict:
    """keyed and expand on the affine tiger's frame at t = 23/60, and the
    device ops of an affine-tiger and an animated-fixture frame."""
    import torch

    import chip_smoke
    from piet_tpu_torch.ops import coarse, expand, hitfuse, keyed
    assert chip_smoke.__file__.startswith(root), chip_smoke.__file__
    i32 = torch.int32
    t = 23.0 / 60.0
    cfg, render_t, _, _ = chip_smoke.affine_tiger(scene, dev)
    taps = {}
    coarse.coarse_rasterize(render_t.scene_at(t), taps=taps,
                            **chip_smoke.coarse_kw(cfg))
    hargs, hkw = taps["hitfuse"]
    rec = hitfuse.hit_records_fused(*hargs, **hkw)
    fused = hitfuse.split_fused(rec)
    n_hits, n_out = hargs[3], cfg.max_candidates

    def glue_args():
        """The two sums' inputs as the coarse pass built them before
        they became one call."""
        live = torch.arange(rec.shape[0], dtype=i32, device=dev) < n_hits
        d_val = fused["d_val"]
        dk = torch.where(live & (d_val != 0.0), fused["d_cand"].to(i32),
                         n_out)
        return [(fused["n_cmds"][:, None].contiguous(),
                 fused["h_cand"].to(i32), n_out),
                (d_val[:, None].contiguous(), dk, n_out)]

    def glue_and_two_calls():
        a, b = glue_args()
        return (keyed.keyed_sum(*a)[:, 0].to(i32), keyed.keyed_sum(*b)[:, 0])

    calls = glue_args()
    out = {}
    if hasattr(keyed, "record_keyed_sums"):
        out["keyed, a frame's sums as the coarse pass calls them"] = time_ms(
            lambda: keyed.record_keyed_sums(rec, n_hits, n_out))
    else:
        out["keyed, a frame's sums as the coarse pass calls them"] = time_ms(
            glue_and_two_calls)
    out["keyed, two keyed_sum calls, no glue"] = time_ms(
        lambda: [keyed.keyed_sum(*a) for a in calls])
    exp_args = taps["expand"]
    out["expand, affine tiger item rows"] = time_ms(
        lambda: expand.expand_rows(*exp_args))
    out["device ops, expand_rows call"] = device_ops(
        lambda: expand.expand_rows(*exp_args))
    # gatherm's two calls on the frame: the segment rows, the point
    # table, the live segment count, the deltas' running sum and the
    # candidate rows as the coarse pass holds them.
    from piet_tpu_torch.ops import candfuse, gatherm
    sitem = expand.expand_rows(*exp_args)
    points = render_t.scene_at(t).points
    n_segs = (exp_args[3][-1:] + exp_args[1][-1:]).to(i32)
    csum = torch.cumsum(keyed.record_keyed_sums(rec, n_hits, n_out)[1], 0)
    ci, akw = taps["candfuse"]
    ca, _, cand_ty, _ = candfuse.cand_records_fused(*ci, **akw)
    ca_i = ca.view(i32)
    if hasattr(gatherm, "gather_endpoints"):
        def fetches():
            return (gatherm.gather_endpoints(sitem, points, n_segs),
                    gatherm.backdrop_from_csum(csum, ca_i, cand_ty))
    else:
        def fetches():
            return (_glue_endpoints(gatherm, sitem, points, n_segs),
                    _glue_backdrop(gatherm, csum, ca_i, cand_ty))
    streams = [(points, _glue_endpoints(gatherm, sitem, points, n_segs)[1]),
               (csum[:, None], (_glue_backdrop(gatherm, csum, ca_i,
                                               cand_ty)[1],))]
    out["gatherm, a frame's fetches as the coarse pass makes them"] = (
        time_ms(fetches))
    out["device ops, gatherm fetches as the coarse pass makes them"] = (
        device_ops(fetches))
    out["gatherm, two gather_monotone calls on the frame's streams"] = (
        time_ms(lambda: [gatherm.gather_monotone(r, i)
                         for r, i in streams]))
    out["device ops, affine tiger frame"] = device_ops(lambda: render_t(t))
    _, anim_t, _, _ = chip_smoke.animated_fixture(dev)
    out["device ops, animated fixture frame"] = device_ops(
        lambda: anim_t(t))
    return out


def ptxas(root: str) -> str:
    sys.path.insert(0, root)
    from piet_tpu_torch import kernels
    lines = []
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("fine_dense", "hitfuse", "fine", "sort", "keyed",
                 "expand", "candfuse", "gatherm"):
        src = kernels.CSRC / f"{name}.cu"
        obj = kernels.BUILD_DIR / f"ptxas.{name}.o"
        res = subprocess.run(
            [kernels._nvcc()] + kernels.NVCC_FLAGS
            + ["-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
            capture_output=True, text=True, timeout=600)
        for ln in (res.stdout + res.stderr).splitlines():
            if re.search(r"Compiling entry|registers|spill", ln):
                lines.append(f"{name}: {ln.strip()}")
    return "\n".join(lines)


#: Design variants of csrc/sort.cu's device-memory route: name ->
#: (text, replacement) pairs.
_UPSWEEP_ATOMIC = """      if (wbase + 32 * j >= n) continue;
      const unsigned k0 = key_int(f0[j], s.bound[0]);"""
_UPSWEEP_ADD = """        atomicAdd(&h[p * BINS + (((s.sel[p] ? k1[j] : k0) >> s.shift[p]) &
                                 ((1u << s.bits[p]) - 1u))],
                  1u);"""
SORT_VARIANTS = {
    "as built": [],
    "upsweep match-aggregated": [
        (_UPSWEEP_ATOMIC, """      const bool ok = wbase + 32 * j < n;
      const unsigned k0 = key_int(f0[j], s.bound[0]);"""),
        (_UPSWEEP_ADD, """        const unsigned d =
            ok ? ((s.sel[p] ? k1[j] : k0) >> s.shift[p]) &
                     ((1u << s.bits[p]) - 1u)
               : (unsigned)BINS;
        const unsigned peers = __match_any_sync(FULL, d);
        if (ok && lane == __ffs(peers) - 1)
          atomicAdd(&h[p * BINS + d], (unsigned)__popc(peers));""")],
    "gather val (no carry)": [("    a.carry = !s.two;", "    a.carry = 0;")],
    "ballot match": [("    const unsigned peers = __match_any_sync(FULL, d);\n"
                      "    const unsigned before", """    unsigned peers = FULL;
#pragma unroll
    for (int b = 0; b < 9; ++b) {
      const unsigned bit = (d >> b) & 1u;
      const unsigned ones = __ballot_sync(FULL, bit);
      peers &= bit ? ones : ~ones;
    }
    const unsigned before""")],
    "look-back 1 word": [("constexpr int LOOK_W = 8;",
                          "constexpr int LOOK_W = 1;")],
    "tile 1024": [("constexpr int P_ITEMS = 7;", "constexpr int P_ITEMS = 4;")],
    "tile 2816": [("constexpr int P_ITEMS = 7;",
                   "constexpr int P_ITEMS = 11;")],
    "6 blocks an SM": [("__global__ void __launch_bounds__(P_THREADS)\n"
                        "sort_pass(",
                        "__global__ void __launch_bounds__(P_THREADS, 6)\n"
                        "sort_pass(")],
    "no dependent launch": [
        ("    attr[0].val.programmaticStreamSerializationAllowed = 1;",
         "    attr[0].val.programmaticStreamSerializationAllowed = 0;")],
    "no look-back (wrong, timed only)": [
        ("    if (part > 0) {\n      bool done",
         "    if (false) {\n      bool done")],
}


def sort_variants(root: str) -> None:
    sys.path.insert(0, root)
    import ctypes

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from piet_tpu_torch import kernels
    from piet_tpu_torch.ops import coarse, sort
    from piet_tpu_torch.renderer.renderer import Renderer
    from piet_tpu_torch.scene import fixtures
    card = card_line()
    libs, texts = build_variants(kernels, "sort.cu", SORT_VARIANTS,
                                 ("piet_sort",))
    tiles = {name: 256 * int(re.search(r"constexpr int P_ITEMS = (\d+);",
                                       text).group(1))
             for name, text in texts.items()}
    dev = torch.device("cuda")

    def run(name, keys, val, bounds):
        n = val.shape[0]
        plan = sort.sort_plan(n, bounds)._replace(chunk=tiles[name])
        flat = [x for p in plan.passes for x in p]
        scratch = torch.empty(sort.scratch_words(n, plan), dtype=torch.int32,
                              device=dev)
        ok = [torch.empty_like(k) for k in keys]
        ov = torch.empty_like(val)
        two = len(keys) == 2
        rc = libs[name].piet_sort(
            keys[0].data_ptr(), keys[1].data_ptr() if two else None,
            val.data_ptr(), ok[0].data_ptr(),
            ok[1].data_ptr() if two else None, ov.data_ptr(), n, bounds[0],
            bounds[1] if two else 0, len(plan.passes),
            (ctypes.c_int * len(flat))(*flat), 0, plan.chunk,
            scratch.data_ptr(), kernels.stream())
        assert rc == 0, (name, rc)
        return ok, ov

    cases = {}
    bez = fixtures.get_scene("beziers_10k")
    for bucket in (False, True):
        r = Renderer.for_scene(bez, 1024, 1024, device=dev, bucket=bucket)
        c, taps = r.config, {}
        coarse.coarse_rasterize(
            r.prepare(bez), taps=taps, tiles_x=c.tiles_x, tiles_y=c.tiles_y,
            tile_w=c.tile_width, tile_h=c.tile_height,
            max_segments=c.max_segments, max_hits=c.max_hits,
            max_candidates=c.max_candidates)
        keys, val, bounds = taps["sort"]
        cases[f"beziers_10k {val.shape[0]}"] = (keys, val, bounds)
    gen = torch.Generator(device=dev).manual_seed(4)
    n = 1 << 20
    for n_keys in (1, 2):
        keys = []
        for _ in range(n_keys):
            k = torch.randint(0, 2 ** 24, (n,), generator=gen,
                              device=dev).to(torch.float32)
            k[torch.rand(n, generator=gen, device=dev) < 0.2] = float("inf")
            keys.append(k)
        cases[f"random 2^20, {n_keys} key(s)"] = (
            tuple(keys), torch.randperm(n, generator=gen, device=dev).to(
                torch.int32), (2 ** 24,) * n_keys)
    for case, (keys, val, bounds) in cases.items():
        wk, wv = sort.stable_sort_multi_plain(keys, val)
        cols = [f"torch.sort {time_ms(lambda: torch.sort(keys[0], stable=True)):.4f}"]
        times = {name: [] for name in libs}
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                times[name].append(time_ms(lambda: run(name, keys, val,
                                                       bounds)))
        for name in libs:
            gk, gv = run(name, keys, val, bounds)
            same = torch.equal(gv, wv) and all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(gk, wk))
            cols.append(f"{name} {times[name][0]:.4f}/{times[name][1]:.4f}"
                        f"{'' if same else ' (differs from plain)'}")
        print(f"sort variants, {case} [{card}]: " + " | ".join(cols),
              flush=True)
        for name in libs:
            run(name, keys, val, bounds)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run(name, keys, val, bounds)
                torch.cuda.synchronize()
            by = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    m = re.search(r"sort_\w+|[Mm]emset", e.name)
                    key = m.group(0) if m else e.name[:30]
                    cnt, us = by.get(key, (0, 0.0))
                    by[key] = (cnt + 1, us + e.time_range.elapsed_us())
            print(f"  kernels, {case}, {name}: " + ", ".join(
                f"{k} {c / 10:.0f} x {us / c:.2f} us" for k, (c, us)
                in by.items()), flush=True)


#: Design variants of csrc/candfuse.cu: name -> (text, replacement) pairs.
CAND_VARIANTS = {
    "as built": [],
    "1024 items a block": [
        ("constexpr int PREP_THREADS = 512; ",
         "constexpr int PREP_THREADS = 1024;")],
    "256 items a block": [
        ("constexpr int PREP_THREADS = 512; ",
         "constexpr int PREP_THREADS = 256; ")],
    "each block counts every item before it (no cand_count)": [
        ("""  if (blockIdx.x > 0) {
    wait_prior();
    for (int j = tid; j < (int)blockIdx.x; j += PREP_THREADS)
      before += sums[j];
  }""", """#pragma unroll 4
  for (int j = tid; j < i0; j += PREP_THREADS)
    before += item_count(s, j, n_items, g);"""),
        ("  if (err == 0 && blocks > 1)\n    err = launch(cand_count",
         "  if (false)\n    err = launch(cand_count"),
        ("                 blocks > 1, stream, s, g, ni,",
         "                 false, stream, s, g, ni,")],
    "no row stores (wrong, timed only)": [
        ("  int4* dst = cand_pack + (size_t)i0 * QUADS;",
         "  if (ni > 0) return;\n  int4* dst = cand_pack + (size_t)i0 * QUADS;")],
    "each thread stores its row": [
        ("    int4* st = rows_sh + tid * QUADS;\n    const int sw = tid & (QUADS - 1);",
         "    int4* st = cand_pack + (size_t)i * QUADS;\n    const int sw = 0;"),
        ("  for (int k = tid; k < n_quads; k += PREP_THREADS) {",
         "  for (int k = tid; k < 0; k += PREP_THREADS) {")],
    "no work (wrong, timed only)": [
        ("  let_next_start();\n  extern",
         "  let_next_start();\n  if (ni > 0) return;\n  extern")],
}

#: Item slots of the scenes --cand-variants builds by repeating
#: beziers_10k's items, past any fixture (the prefix's growth with NI).
CAND_REPEATS = (131_072, 524_288)


def cand_variants(root: str) -> None:
    sys.path.insert(0, root)
    import types

    import torch

    from piet_tpu_torch import kernels
    from piet_tpu_torch.host import make_tiger
    from piet_tpu_torch.ops import candfuse, coarse
    from piet_tpu_torch.renderer.renderer import Renderer
    from piet_tpu_torch.scene import fixtures
    card = card_line()
    libs, _ = build_variants(kernels, "candfuse.cu", CAND_VARIANTS,
                             ("piet_cand_prep", "piet_cand_stage"))
    dev = torch.device("cuda")

    def run(name, scene, kw, cap, poison=False):
        """One call of a variant: the rows (piet_cand_prep), or the rows
        and their expansion (piet_cand_stage) where cap is given, as the
        coarse pass calls it.  With ``poison`` the outputs start as a
        marker pattern, so that words a variant leaves unwritten differ
        from the plain version's."""
        ni = scene.tags.shape[0]

        def out(shape):
            return (torch.full(shape, 0x5A5A5A5A, dtype=torch.int32,
                               device=dev) if poison else
                    torch.empty(shape, dtype=torch.int32, device=dev))
        rows = [out((ni, 32)), out((ni,)), out((ni,)), out((1,))]
        # Sized for the smallest block a variant takes (256 items).
        sums = out((ni // 256 + 1,))
        outs = [out((cap, 32)), out((cap,)), out((cap,))] if cap else []
        fields = [getattr(scene, f) for f, _, _ in candfuse.SCENE_FIELDS]
        ptrs = [t.data_ptr() for t in fields + [scene.n_items, sums] + rows
                + outs]
        grid = (kw["tiles_x"], kw["tiles_y"], kw["tile_w"], kw["tile_h"],
                kw["row0"])
        if cap:
            rc = libs[name].piet_cand_stage(*ptrs, ni, cap, *grid,
                                            kernels.stream())
        else:
            rc = libs[name].piet_cand_prep(*ptrs, ni, *grid,
                                           kernels.stream())
        assert rc == 0, (name, rc)
        return rows + outs

    def plain(scene, kw, cap):
        ci = coarse.cand_inputs_plain(scene, **kw)
        if not cap:
            return list(ci)
        return list(ci) + list(candfuse.cand_records_fused_plain(
            *ci, kw["row0"], cap, tiles_x=kw["tiles_x"])[:3])

    cases = {}
    for tag, sc, size in (("tiger 1664", make_tiger(), 1664),
                          ("beziers_10k 1024",
                           fixtures.get_scene("beziers_10k"), 1024)):
        r = Renderer.for_scene(sc, size, size, device=dev)
        c = r.config
        cases[tag] = (r.prepare(sc), dict(
            tiles_x=c.tiles_x, tiles_y=c.tiles_y, tile_w=c.tile_width,
            tile_h=c.tile_height, row0=0), c.max_candidates)
    bez, bez_kw, _ = cases["beziers_10k 1024"]
    for n in CAND_REPEATS:
        reps = -(-n // bez.tags.shape[0])
        big = types.SimpleNamespace(**{
            f: getattr(bez, f).repeat(reps, *[1] * (getattr(bez, f).dim()
                                                   - 1))[:n].contiguous()
            for f, _, _ in candfuse.SCENE_FIELDS})
        big.n_items = torch.tensor([n], dtype=torch.int32, device=dev)
        total = int(coarse.cand_inputs_plain(big, **bez_kw).total[0])
        cases[f"beziers_10k's items repeated to {n:,} slots"] = (
            big, bez_kw, -(-total // 128) * 128)
    for case, (scene, kw, cap) in cases.items():
        for what, c in (("item rows", None), ("rows and expansion", cap)):
            want = plain(scene, kw, c)
            times = {name: [] for name in libs}
            for order in (list(libs), list(reversed(libs))):
                for name in order:
                    times[name].append(time_ms(
                        lambda: run(name, scene, kw, c)))
            cols = []
            for name in libs:
                got = run(name, scene, kw, c, poison=True)
                torch.cuda.synchronize()
                same = all(torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
                           for g, w in zip(got, want))
                cols.append(f"{name} {times[name][0]:.4f}/"
                            f"{times[name][1]:.4f}"
                            f"{'' if same else ' (differs from plain)'}")
            cols.append(f"plain {time_ms(lambda: plain(scene, kw, c)):.4f}")
            print(f"candfuse variants, {case}, {what} [{card}]: "
                  + " | ".join(cols), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--worker")
    ap.add_argument("--ptxas")
    ap.add_argument("--sort-variants")
    ap.add_argument("--cand-variants")
    a = ap.parse_args()
    if a.worker:
        worker(a.worker)
        return 0
    if a.ptxas:
        print(ptxas(a.ptxas), flush=True)
        return 0
    if a.cand_variants:
        import torch
        if not torch.cuda.is_available():
            print("ab_kernels: needs a CUDA card", file=sys.stderr)
            return 1
        cand_variants(a.cand_variants)
        return 0
    if a.sort_variants:
        import torch
        if not torch.cuda.is_available():
            print("ab_kernels: needs a CUDA card", file=sys.stderr)
            return 1
        sort_variants(a.sort_variants)
        return 0
    import torch
    if not torch.cuda.is_available() or len(a.roots) != 2:
        print("ab_kernels: needs a CUDA card and two roots", file=sys.stderr)
        return 1
    card = card_line()
    roots = [os.path.abspath(r) for r in a.roots]
    runs = []
    for k in (0, 1, 1, 0):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             roots[k]], capture_output=True, text=True, timeout=900,
            cwd=roots[k])
        if res.returncode:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        got = json.loads(res.stdout.split("AB ", 1)[1].splitlines()[0])
        runs.append(("AB"[k], got))
    for key in runs[0][1]:
        seq = " / ".join(f"{t} {r[key]:.4f}" if isinstance(r[key], float)
                         else f"{t} {r[key]}" for t, r in runs)
        print(f"ab {key} [{card}]: {seq}", flush=True)
    for k, root in enumerate(roots):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ptxas", root], capture_output=True,
                             text=True, timeout=900, cwd=root)
        print(f"ptxas {'AB'[k]} ({root}):\n{res.stdout}{res.stderr[-2000:]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
