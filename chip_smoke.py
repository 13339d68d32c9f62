#!/usr/bin/env python3
"""Smoke run of the PyTorch port (piet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, one line each; any failure raises
and exits non-zero:

  1. the card's name and power limit (nvidia-smi's line, as it prints
     it), torch and CUDA versions;
  2. build the kernels from csrc/ with nvcc, one process per source
     (timed);
  3. every kernel against its plain PyTorch version on the same inputs,
     bitwise (tolerance 0): candfuse and hitfuse on the static 1664^2
     tiger's own inputs; sort on the tiger's keys, on the two keys of the
     unpacked configuration (below), on the tiger's keys with a val that
     is not increasing, and on 2^20 pairs (the device-memory route); fine
     (kernel D) on the tiger's entries (no group command: the stackless
     path), on the clip, gradient and multi-subpath fixtures' at 1024^2
     (the stack path) and on the tiger's at 16x16 tiles; expand, keyed and
     gatherm on the affine-animated tiger's (segments derived on the
     device); fine_dense on the static tiger's dense PTCL in both
     instantiations (fine_rasterize and fine_rasterize_xla), in the group
     one on the three fixtures, in both on the tiger's at 16x16 tiles and
     on the synthetic PTCLs of raster/synth_ptcl.py (tile widths 16, 24,
     128; group commands first at slots 0-128, streaks across the chunk
     boundary, counts above the capacity and zero); hitfuse also on the
     unpacked configuration's inputs (stride 0) and the affine tiger's
     (segments derived on the device);
  4. the static path: Renderer.for_scene(tiger, 1664, 1664).render() and
     the same at 3840x2160, with the launch counters reset just before
     and read just after each; the images must equal the numpy oracle
     bitwise, and every kernel of the path (all but expand and fine_dense)
     must have run;
  4b. the dense path (fine_impl="dense"): the same two tiger frames
     against the same oracle images, with fine_dense run, entries-fine
     not run and no PTCL overflow; the three group fixtures at 1024^2; one
     affine-tiger frame; and render_sequence, render_packed_u32 and
     render_updated on animated-fixture frames, each equal to render();
  4c. the unpacked configuration -- the cardioid at 1024^2 in 16x16
     tiles with room for 2,048 items, whose packed sort key would reach
     2^24 -- on both routes, bitwise against the oracle (the two-key
     sort);
  5. the device-animation paths, 2 frames each: the tiger under the
     affine spin/zoom at 1664^2 (make_affine_render_fn) and the animated
     fixture at 1024^2 (make_animated_render_fn).  Each frame must equal
     the numpy oracle rendered from that frame's own device-computed
     arrays, bitwise, with no capacity overflow; all seven kernels of the
     entries route must have run;
  6. timing with CUDA events: ms/frame on every path (both routes of the
     static tiger), device ms with the launch overhead hidden, a
     torch.profiler trace (device-busy share and top device ops), and each
     kernel beside its plain version, its bound and, where one PyTorch call
     computes the same function, that call; then kernel C's device-memory
     route on 2^20 pairs beside torch.sort, and both fine_dense
     instantiations beside the device ops of a dense frame.

The line before the last is the kernel table as JSON, each kernel with
the path whose run gave its launch count; the last line is {"ok": true,
"device": {...}}.  Exits non-zero without a result when no CUDA device is
present.
"""

import itertools
import json
import math
import statistics
import subprocess
import sys
import time


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


#: GPU spin before a timed batch (~25 ms at H100 clocks), so the host
#: enqueues the whole batch while the device is busy and the events then
#: time back-to-back device work, not the host's launch overhead.
SPIN_CYCLES = 50_000_000

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
#: float32 operations/s outside the tensor cores.  The data sheet's 67
#: TFLOP/s counts a fused multiply-add as two operations; the kernels are
#: built with -fmad=false, so every multiply and add runs on its own and
#: the attainable rate is half that.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
#: Float32 operations per pixel per command in the fine interpreter -- a
#: lower bound (a fill's trapezoid area or a line's distance field takes
#: more), so the fine bound is a least time.
FINE_OPS_PER_PIXEL_CMD = 10

#: Affine animation: the `animate --affine` defaults of the JAX package's
#: CLI (period, zoom, dt, frames), about the viewport centre.
PERIOD, ZOOM, DT, FRAMES = 4.0, 0.15, 1.0 / 60.0, 24
#: The two frames each animation path renders and checks.
T_FRAMES = (0.0, 23.0 / 60.0)


def time_ms(fn, reps: int, warm: int = 1,
            spin: int = SPIN_CYCLES) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs, by CUDA
    events around the batch, with the launch overhead hidden behind a GPU
    spin.  Where ``fn`` reads results on the host (the plain fine
    interpreter) or enqueues for longer than the spin, the number includes
    host time."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frame_ms(fn, reps: int, warm: int = 3) -> float:
    """Median time of one frame as a caller sees it: CUDA events around
    each call, host launch overhead included."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 20) -> float:
    """Host clock around ``reps`` back-to-back frames and one sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bitwise(a, b):
    """(mismatching elements, max abs error) of two same-shape tensors,
    compared on their bit patterns."""
    import torch
    a = a.contiguous()
    b = b.contiguous()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == torch.float32:
        ai, bi = a.view(torch.int32), b.view(torch.int32)
        diff = (a.double() - b.double()).abs()
    else:
        ai, bi = a, b
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs().double()
    bad = ai != bi
    n_bad = int(bad.sum())
    err = float(torch.nan_to_num(diff[bad], nan=float("inf")).max()) \
        if n_bad else 0.0
    return n_bad, err


def bound(n_bytes: float, n_ops: float = 0.0):
    """(least ms, what bounds it) for ``n_bytes`` moved and ``n_ops`` f32
    operations at the H100's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def row_bytes(n_rows: int, *tensors) -> int:
    """Bytes of ``n_rows`` rows of each tensor (rows along dim 0): what a
    kernel reads of inputs it reaches only at those rows."""
    return n_rows * sum(t[0].numel() * t.element_size() for t in tensors)


def profile_frames(render_one, card: str, tag: str, frames: int = 10,
                   top: int = 8) -> float:
    """Trace ``frames`` frames with torch.profiler; print the device-busy
    share and the ``top`` device ops by time per frame; return the device
    ops per frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        render_one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            render_one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    print(f"profile {tag} [{card}]: {len(kern) / frames:.0f} device ops "
          f"per frame, device busy {busy_us / frames / 1e3:.3f} ms of "
          f"{wall_us / frames / 1e3:.3f} ms/frame wall (busy share "
          f"{busy_us / wall_us:.3f}, profiler on)", flush=True)
    by_name = {}
    for e in kern:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / frames / 1e3:.4f} ms/frame in {n / frames:.0f} "
              f"launches: {name[:90]}", flush=True)
    return len(kern) / frames


def affine_tiger(scene, dev, fine_impl="entries"):
    """The tiger spinning and zooming about the 1664^2 viewport centre,
    capacities fitted over 5 host-transformed samples of the 24-frame
    sweep (the JAX package's `animate --affine`)."""
    import dataclasses

    import torch
    from piet_tpu_torch.host import RenderConfig, fit_capacities
    from piet_tpu_torch.scene import affine

    cfg = fit_capacities(scene, RenderConfig(width=1664, height=1664,
                                             tile_height=32, tile_width=128),
                         bucket=True)
    cx, cy = cfg.width / 2.0, cfg.height / 2.0
    for k in range(5):
        t = (FRAMES - 1) * DT * k / 4
        a = t * (2.0 * math.pi / PERIOD)
        m = affine.rotation_about(cx, cy, torch.tensor(a),
                                  1.0 + ZOOM * math.sin(a)).numpy()
        c = fit_capacities(affine.host_transform_scene(scene, m), cfg,
                           bucket=True)
        cfg = dataclasses.replace(
            cfg, max_hits=max(cfg.max_hits, c.max_hits),
            max_candidates=max(cfg.max_candidates, c.max_candidates),
            max_deltas=max(cfg.max_deltas, c.max_deltas),
            cmd_capacity=max(cfg.cmd_capacity, c.cmd_capacity))

    def mats_fn(t):
        a = t * (2.0 * math.pi / PERIOD)
        return affine.rotation_about(cx, cy, a, 1.0 + ZOOM * torch.sin(a))

    render_t = affine.make_affine_render_fn(cfg, scene, mats_fn, device=dev,
                                            fine_impl=fine_impl)
    return cfg, render_t, scene.n_items, scene.n_points


def animated_fixture(dev):
    """BASELINE config 5: the animated fixture at 1024^2 (n=200, seed 5),
    capacities fitted over 4 host-built frames of the 24-frame sweep (the
    JAX package's `animate`)."""
    import dataclasses

    from piet_tpu_torch.host import RenderConfig, fit_capacities
    from piet_tpu_torch.scene import animate
    from piet_tpu_torch.scene.fixtures import make_animated_frame

    tmpl = animate.template_scene()
    cfg = fit_capacities(tmpl, RenderConfig(width=1024, height=1024),
                         bucket=True)
    for k in range(1, 5):
        c = fit_capacities(make_animated_frame((FRAMES - 1) * DT * k / 4),
                           cfg, bucket=True)
        cfg = dataclasses.replace(
            cfg, max_segments=max(cfg.max_segments, c.max_segments),
            max_hits=max(cfg.max_hits, c.max_hits),
            max_candidates=max(cfg.max_candidates, c.max_candidates),
            max_deltas=max(cfg.max_deltas, c.max_deltas),
            cmd_capacity=max(cfg.cmd_capacity, c.cmd_capacity))
    render_t, tmpl = animate.make_animated_render_fn(cfg, device=dev)
    return cfg, render_t, tmpl.n_items, tmpl.n_points


def dense_inputs(staged, cfg):
    """(counts (tiles_y, tiles_x), tags, args, fine kwargs): the dense PTCL
    of a staged scene, as the dense route hands it to its interpreter."""
    from piet_tpu_torch.ops import coarse
    out = coarse.coarse_rasterize(staged, output="dense",
                                  cmd_capacity=cfg.cmd_capacity,
                                  **coarse_kw(cfg))
    return (out.counts.reshape(cfg.tiles_y, cfg.tiles_x), out.tags, out.args,
            dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
                 cmd_capacity=cfg.cmd_capacity))


def unpacked_config(scene):
    """The scene's fitted capacities at 1024^2 in 16x16 tiles with room
    for 2,048 items: 4,096 tiles x 2 * 2,049 >= 2^24, so the coarse pass
    sorts on the unpacked keys (tile, item * 2 + class)."""
    import dataclasses

    from piet_tpu_torch.host import RenderConfig, fit_capacities
    cfg = fit_capacities(scene, RenderConfig(width=1024, height=1024,
                                             tile_height=16, tile_width=16))
    cfg = dataclasses.replace(cfg, max_items=2048)
    assert cfg.n_tiles * 2 * (cfg.max_items + 1) >= 2 ** 24
    return cfg


def entries_inputs(staged, cfg):
    """(first, n_entries, present, stream) and kernel D's keywords: the
    entry stream of a staged scene, as the entries route hands it over."""
    from piet_tpu_torch.ops import coarse
    from piet_tpu_torch.renderer.renderer import _solid_to_present_u32
    ce = coarse.coarse_rasterize(staged, **coarse_kw(cfg))
    return ((ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
             ce.stream),
            dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
                 tiles_x=cfg.tiles_x))


def coarse_kw(cfg) -> dict:
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    sys.stdout.flush()

    import numpy as np
    import torch.nn.functional as F
    from piet_tpu_torch import kernels
    from piet_tpu_torch.host import cpu_render_scene, make_tiger
    from piet_tpu_torch.ops import (candfuse, coarse, expand, fine, fine_xla,
                                    gatherm, hitfuse, keyed, sort)
    from piet_tpu_torch.raster.synth_ptcl import synth_dense_ptcl
    from piet_tpu_torch.renderer.renderer import (Renderer,
                                                  _solid_to_present_u32,
                                                  fetch_scene)
    from piet_tpu_torch.scene import fixtures

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(kernels.BUILD_DIR.parent.parent)}", flush=True)

    dev = torch.device("cuda")
    scene = make_tiger()
    renderer = Renderer.for_scene(scene, 1664, 1664, tile_height=32,
                                  tile_width=128, device=dev)
    cfg = renderer.config
    staged = renderer.prepare(scene)
    ckw = coarse_kw(cfg)
    print(f"config 1664x1664: items {cfg.max_items} segments "
          f"{cfg.max_segments} hits {cfg.max_hits} candidates "
          f"{cfg.max_candidates} tiles {cfg.n_tiles}", flush=True)
    aff_cfg, aff_render, aff_ni, aff_np = affine_tiger(scene, dev)
    anim_cfg, anim_render, anim_ni, anim_np = animated_fixture(dev)
    for tag, c in (("affine tiger 1664x1664", aff_cfg),
                   ("animated 1024x1024", anim_cfg)):
        print(f"config {tag}: items {c.max_items} segments "
              f"{c.max_segments} hits {c.max_hits} candidates "
              f"{c.max_candidates} tiles {c.n_tiles}", flush=True)

    # ---- 3. kernels vs their plain versions, on the slice's inputs -----
    taps = {}
    entries = coarse.coarse_rasterize(staged, taps=taps, **ckw)
    atap = {}
    coarse.coarse_rasterize(aff_render.scene_at(T_FRAMES[1]), taps=atap,
                            **coarse_kw(aff_cfg))
    torch.cuda.synchronize()
    ci_in, akw = taps["candfuse"]
    hit_args, bkw = taps["hitfuse"]
    fine_args = (entries.first, entries.n_entries,
                 _solid_to_present_u32(entries.solid), entries.stream)
    fkw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
               tiles_x=cfg.tiles_x)
    exp_args = atap["expand"]
    keyed_calls = atap["keyed"]
    gather_calls = atap["gatherm"]
    # The dense PTCLs: the static tiger's, and the group fixtures' at
    # 1024^2 (clips and layers, gradients, multi-subpath winding carries).
    dense_in = [dense_inputs(staged, cfg)]
    group_scenes = {name: make(1024) for name, make in (
        ("clip_star", fixtures.make_clip_star),
        ("gradient_demo", fixtures.make_gradient_demo),
        ("holes_demo", fixtures.make_holes_demo))}
    group_renderers = {
        name: Renderer.for_scene(sc, 1024, 1024, tile_height=32,
                                 tile_width=128, device=dev,
                                 fine_impl="dense")
        for name, sc in group_scenes.items()}
    for name, gr in group_renderers.items():
        dense_in.append(dense_inputs(gr.prepare(group_scenes[name]),
                                     gr.config))
    tiger_dense = dense_in[0]
    # Both instantiations beyond the tiger at 32x128: its dense PTCL at
    # 16x16 tiles (4 pixels a thread) and the synthetic PTCLs.
    r16 = Renderer.for_scene(scene, 1664, 1664, tile_height=16,
                             tile_width=16, device=dev)
    both_in = [tiger_dense, dense_inputs(r16.prepare(scene), r16.config)]
    for tw, groups in itertools.product((16, 24, 128), (True, False)):
        both_in.append(tuple(torch.from_numpy(a).to(dev) for a in
                             synth_dense_ptcl(tw, tile_w=tw, tile_h=16,
                                              groups=groups))
                       + (dict(tile_h=16, tile_w=tw, cmd_capacity=256),))
    # Kernel D beyond the tiger (whose tiles hold no group command: the
    # stackless path): the group fixtures' entry streams (the stack path)
    # and the tiger's at 16x16 tiles.
    fine_cases = [("tiger 1664x1664", fine_args, fkw)]
    for name, gr in group_renderers.items():
        fine_cases.append((f"{name} 1024x1024", *entries_inputs(
            gr.prepare(group_scenes[name]), gr.config)))
    fine_cases.append(("tiger 1664x1664, 16x16 tiles",
                       *entries_inputs(r16.prepare(scene), r16.config)))

    # The unpacked configuration (phase 4c), and kernel C's four cases.
    cardioid = fixtures.make_cardioid(center=(512.0, 512.0), r=400.0)
    unp_cfg = unpacked_config(cardioid)
    utaps = {}
    coarse.coarse_rasterize(Renderer(unp_cfg, dev).prepare(cardioid),
                            taps=utaps, **coarse_kw(unp_cfg))
    sort_keys, sort_val, sort_bounds = taps["sort"]
    # Kernel B on the static tiger's inputs, the unpacked configuration's
    # (stride 0) and the affine tiger's (segments derived on the device).
    hit_cases = [taps["hitfuse"], utaps["hitfuse"], atap["hitfuse"]]
    gen = torch.Generator(device=dev).manual_seed(4)
    big_n = 1 << 20
    big_key = torch.randint(0, 2 ** 24, (big_n,), generator=gen,
                            device=dev).to(torch.float32)
    big_key[torch.rand(big_n, generator=gen, device=dev) < 0.2] = math.inf
    sort_cases = {
        "tiger": (sort_keys, sort_val, sort_bounds),
        "unpacked, two keys": utaps["sort"],
        "tiger, val reversed": (sort_keys, torch.flip(sort_val, [0]),
                                sort_bounds),
        "2^20 pairs": ((big_key,), torch.arange(big_n, dtype=torch.int32,
                                                device=dev), None)}
    for name, (k, v, b) in sort_cases.items():
        plan = sort.sort_plan(v.shape[0], b or (sort.KEY_LIMIT,) * len(k))
        route = (f"one launch, cluster of {plan.cluster} blocks of "
                 f"{plan.chunk} pairs" if plan.cluster else
                 f"device-memory route, {3 * len(plan.passes)} launches")
        print(f"sort case {name}: {v.shape[0]} pairs, {len(k)} key(s), "
              f"bounds {b}, {len(plan.passes)} digit passes {plan.passes}; "
              f"{route}", flush=True)

    # The one PyTorch call computing the same function, where there is
    # one (timed beside the kernel; the port never calls it).
    ex_rows, ex_counts, ex_cap, _ = exp_args
    ex_n = int(ex_counts.sum())
    keyed_lib_keys = [torch.where((a[1] >= 0) & (a[1] < a[2]), a[1],
                                  a[2]).long() for a in keyed_calls]
    gather_lib_idx = [[i.long() for i in idxs] for _, idxs in gather_calls]
    n_ent = sort_val.shape[0]
    fine_cmds = int(entries.counts.sum())
    tile_px = cfg.tile_width * cfg.tile_height
    img_bytes = cfg.tiles_x * cfg.tiles_y * tile_px * 4

    # Least bytes of each kernel on this run's data: each input row that
    # the outputs depend on read once, each output written once.  Rows of
    # a ragged source with a zero count, entries past a tile's live range,
    # values of dropped keys and gather rows no index reaches are not
    # counted.
    ci_live = int((ci_in.counts > 0).sum())
    cand_bytes = (row_bytes(ci_live, *ci_in[:3]) + nbytes(ci_in.total)
                  + akw["cap"] * (32 + 3) * 4)
    hit_live = int((hit_args[1] > 0).sum())
    hit_bytes = (row_bytes(hit_live, *hit_args[:3]) + nbytes(hit_args[3])
                 + bkw["cap"] * hitfuse.OUT_WORDS * 4)
    fine_bytes = (nbytes(*fine_args[:3])
                  + row_bytes(int(entries.n_entries.sum()), fine_args[3])
                  + img_bytes)
    # The dense interpreter reads each live command's 13 words once (a
    # tag and 12 operands), the counts, and writes the image.
    dense_cmds = int(tiger_dense[0].sum())
    dense_bytes = dense_cmds * 13 * 4 + nbytes(tiger_dense[0]) + img_bytes
    ex_live = int((ex_counts > 0).sum())
    exp_bytes = (row_bytes(ex_live, ex_rows, ex_counts, exp_args[3])
                 + ex_cap * ex_rows.shape[1] * 4)
    keyed_bytes = sum(nbytes(a[1]) + row_bytes(int((k < a[2]).sum()), a[0])
                      + a[2] * a[0].shape[1] * 4
                      for a, k in zip(keyed_calls, keyed_lib_keys))
    gather_bytes = sum(
        row_bytes(int(torch.unique(torch.cat(idxs)).numel()), r)
        + nbytes(*idxs) + len(idxs) * idxs[0].shape[0] * r.shape[1] * 4
        for r, idxs in gather_calls)

    table = {
        "candfuse": dict(
            route="cuda", source="piet_tpu_torch/csrc/candfuse.cu",
            replaces="piet_tpu/ops/candfuse.py:47",
            run=lambda: candfuse.cand_records_fused(*ci_in, **akw),
            plain=lambda: candfuse.cand_records_fused_plain(*ci_in, **akw),
            library=None,
            bytes=cand_bytes),
        "hitfuse": dict(
            route="cuda", source="piet_tpu_torch/csrc/hitfuse.cu",
            replaces="piet_tpu/ops/hitfuse.py:73",
            run=lambda: tuple(hitfuse.hit_records_fused(*a, **k)
                              for a, k in hit_cases),
            plain=lambda: tuple(hitfuse.hit_records_fused_plain(*a, **k)
                                for a, k in hit_cases),
            time=lambda: (hitfuse.hit_records_fused(*hit_args, **bkw),),
            time_plain=lambda: (hitfuse.hit_records_fused_plain(*hit_args,
                                                                **bkw),),
            library=None,
            bytes=hit_bytes),
        # Compared on the four cases; timed on the tiger's keys.
        "sort": dict(
            route="cuda", source="piet_tpu_torch/csrc/sort.cu",
            replaces="piet_tpu/ops/sort.py:111",
            run=lambda: sum((_flat(sort.stable_sort_multi(*c))
                             for c in sort_cases.values()), ()),
            plain=lambda: sum((_flat(sort.stable_sort_multi_plain(*c[:2]))
                               for c in sort_cases.values()), ()),
            time=lambda: sort.stable_sort_multi(sort_keys, sort_val,
                                                sort_bounds),
            time_plain=lambda: sort.stable_sort_multi_plain(sort_keys,
                                                            sort_val),
            library=lambda: torch.sort(sort_keys[0], stable=True),
            bytes=2 * n_ent * 8),
        # Compared on the four cases; timed on the static tiger.
        "fine": dict(
            route="cuda", source="piet_tpu_torch/csrc/fine.cu",
            replaces="piet_tpu/ops/fine.py:245",
            run=lambda: tuple(fine.fine_rasterize_entries(*a, **k)
                              for _, a, k in fine_cases),
            plain=lambda: tuple(fine.fine_rasterize_entries_plain(*a, **k)
                                for _, a, k in fine_cases),
            time=lambda: (fine.fine_rasterize_entries(*fine_args, **fkw),),
            time_plain=lambda: (fine.fine_rasterize_entries_plain(
                *fine_args, **fkw),),
            library=None,
            bytes=fine_bytes,
            ops=fine_cmds * tile_px * FINE_OPS_PER_PIXEL_CMD),
        "expand": dict(
            route="cuda", source="piet_tpu_torch/csrc/expand.cu",
            replaces="piet_tpu/ops/expand.py:81",
            run=lambda: (expand.expand_rows(*exp_args),),
            plain=lambda: (expand.expand_rows_plain(*exp_args),),
            library=lambda: F.pad(torch.repeat_interleave(
                ex_rows, ex_counts, dim=0, output_size=ex_n),
                (0, 0, 0, ex_cap - ex_n)),
            bytes=exp_bytes),
        "keyed": dict(
            route="cuda", source="piet_tpu_torch/csrc/keyed.cu",
            replaces="piet_tpu/ops/keyed.py:70",
            run=lambda: tuple(keyed.keyed_sum(*a) for a in keyed_calls),
            plain=lambda: tuple(keyed.keyed_sum_plain(*a)
                                for a in keyed_calls),
            library=lambda: tuple(
                torch.zeros((a[2] + 1, a[0].shape[1]), device=dev)
                .index_add_(0, k, a[0])
                for a, k in zip(keyed_calls, keyed_lib_keys)),
            bytes=keyed_bytes),
        "gatherm": dict(
            route="cuda", source="piet_tpu_torch/csrc/gatherm.cu",
            replaces="piet_tpu/ops/gatherm.py:52",
            run=lambda: sum((gatherm.gather_monotone(r, i)
                             for r, i in gather_calls), ()),
            plain=lambda: sum((gatherm.gather_monotone_plain(r, i)
                               for r, i in gather_calls), ()),
            library=lambda: tuple(r.index_select(0, i)
                                  for (r, _), ii in zip(gather_calls,
                                                        gather_lib_idx)
                                  for i in ii),
            bytes=gather_bytes),
        # Compared in both instantiations (the group one on the tiger's
        # and the fixtures' PTCLs, both on the tiger's, the 16x16 tiger's
        # and the synthetic ones); timed as the dense frame runs it: the
        # group one on the tiger.
        "fine_dense": dict(
            route="cuda", source="piet_tpu_torch/csrc/fine_dense.cu",
            replaces="piet_tpu/ops/fine.py:65",
            run=lambda: tuple(fine.fine_rasterize(*d[:3], **d[3])
                              for d in both_in) + tuple(
                fine_xla.fine_rasterize_xla(*d[:3], **d[3])
                for d in dense_in + both_in[1:]),
            plain=lambda: tuple(fine.fine_rasterize_plain(*d[:3], **d[3])
                                for d in both_in) + tuple(
                fine_xla.fine_rasterize_xla_plain(*d[:3], **d[3])
                for d in dense_in + both_in[1:]),
            time=lambda: (fine_xla.fine_rasterize_xla(*tiger_dense[:3],
                                                      **tiger_dense[3]),),
            time_plain=lambda: (fine_xla.fine_rasterize_xla_plain(
                *tiger_dense[:3], **tiger_dense[3]),),
            library=None,
            bytes=dense_bytes,
            ops=dense_cmds * tile_px * FINE_OPS_PER_PIXEL_CMD),
    }
    for name, k in table.items():
        got = k["run"]()
        torch.cuda.synchronize()
        want = k["plain"]()
        torch.cuda.synchronize()
        n_bad, err = 0, 0.0
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            nb, e = bitwise(g, w)
            n_bad += nb
            err = max(err, e)
        k["max_abs_err"] = err
        print(f"kernel {name}: {n_bad} mismatching words vs plain "
              f"(tolerance 0), max abs err {err}", flush=True)
        assert n_bad == 0, f"kernel {name} disagrees with its plain version"
    streams = [(tuple(r.shape), len(i), i[0].shape[0])
               for r, i in gather_calls]
    print(f"engine calls per frame on the affine tiger: expand 1 "
          f"{tuple(exp_args[0].shape)} -> {exp_args[2]} rows; keyed "
          f"{len(keyed_calls)} x {tuple(keyed_calls[0][0].shape)} -> "
          f"{keyed_calls[0][2]}; gatherm (rows, streams, slots) {streams}",
          flush=True)

    # ---- 4. the static path, bitwise against the numpy oracle ---------
    golds = {}
    for (w, h) in ((1664, 1664), (3840, 2160)):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev)
        kernels.reset_launches()
        img = r.render(scene)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        gold = golds[w, h] = cpu_render_scene(scene, r.config)
        t_gold = time.perf_counter() - t0
        n_bad = int((img != gold).any(-1).sum())
        print(f"render {w}x{h}: {n_bad} pixels differ from the numpy oracle "
              f"(oracle {t_gold:.1f} s); launches {launches}; "
              f"live entries {r.last_stats['live_entries']}", flush=True)
        assert img.shape == (h, w, 4) and img.dtype == np.uint8
        assert n_bad == 0, f"{w}x{h} image differs from the oracle"
        # A static scene stages its segments on the host: no expansion;
        # the entries route runs no dense interpreter.
        assert launches["expand"] == launches["fine_dense"] == 0, launches
        assert all(v > 0 for k, v in launches.items()
                   if k not in ("expand", "fine_dense")), launches

    # ---- 4b. the dense path ----------------------------------------------
    dense_launches = {}
    for (w, h) in ((1664, 1664), (3840, 2160)):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev, fine_impl="dense")
        kernels.reset_launches()
        img = r.render(scene)
        torch.cuda.synchronize()
        launches = dense_launches[w, h] = dict(kernels.LAUNCHES)
        n_bad = int((img != golds[w, h]).any(-1).sum())
        st = r.last_stats
        print(f"render dense {w}x{h}: {n_bad} pixels differ from the numpy "
              f"oracle; launches {launches}; live commands "
              f"{st['live_cmds']}, max per tile {st['max_tile_cmds']} of "
              f"{r.config.cmd_capacity}, overflow {st['overflow_cmds']}, "
              f"bail tiles {st['bail_tiles']}", flush=True)
        assert n_bad == 0, f"dense {w}x{h} image differs from the oracle"
        assert st["overflow_cmds"] == 0, st
        assert launches["fine_dense"] > 0 and launches["fine"] == 0, launches
        assert launches["expand"] == 0, launches
        assert all(v > 0 for k, v in launches.items()
                   if k not in ("expand", "fine")), launches
    for name, gr in group_renderers.items():
        sc = group_scenes[name]
        kernels.reset_launches()
        img = gr.render(sc)
        torch.cuda.synchronize()
        n_bad = int((img != cpu_render_scene(sc, gr.config)).any(-1).sum())
        print(f"render dense {name} 1024x1024: {n_bad} pixels differ from "
              f"the numpy oracle; fine_dense launches "
              f"{kernels.LAUNCHES['fine_dense']}, live commands "
              f"{gr.last_stats['live_cmds']}", flush=True)
        assert n_bad == 0, f"dense {name} image differs from the oracle"
        assert kernels.LAUNCHES["fine_dense"] == 1
    t = T_FRAMES[1]
    aff_dense = affine_tiger(scene, dev, fine_impl="dense")[1]
    kernels.reset_launches()
    img, stats = aff_dense(t)
    got = img.cpu().numpy().view(np.uint8).reshape(aff_cfg.height,
                                                   aff_cfg.width, 4)
    gold = cpu_render_scene(fetch_scene(aff_dense.scene_at(t), aff_ni,
                                        aff_np), aff_cfg)
    n_bad = int((got != gold).any(-1).sum())
    print(f"render dense affine tiger 1664x1664 t={t:.4f}: {n_bad} pixels "
          f"differ from the numpy oracle on the frame's own arrays; "
          f"launches {dict(kernels.LAUNCHES)}; overflow "
          f"{int(stats['overflow_cmds'])}", flush=True)
    assert n_bad == 0 and int(stats["overflow_cmds"]) == 0
    assert all(v > 0 for k, v in kernels.LAUNCHES.items() if k != "fine")
    # The renderer's other entry points on host-built animated frames.
    from piet_tpu_torch.scene.fixtures import make_animated_frame
    frames = [make_animated_frame(t) for t in T_FRAMES]
    ar = Renderer(anim_cfg, dev, fine_impl="dense")
    seq = ar.render_sequence(frames)
    same_seq = all(np.array_equal(seq[i], ar.render(f))
                   for i, f in enumerate(frames))
    same_packed = torch.equal(ar.render_packed_u32(frames[0]),
                              ar.render_u32(frames[0]))
    same_updated = torch.equal(ar.render_updated(frames[1]),
                               ar.render_u32(frames[1]))
    print(f"dense entry points on the animated fixture 1024x1024: "
          f"render_sequence ({len(frames)} frames) equal to render(): "
          f"{same_seq}; render_packed_u32: {same_packed}; render_updated "
          f"(points moved): {same_updated}", flush=True)
    assert same_seq and same_packed and same_updated

    # ---- 4c. the unpacked configuration: the two-key sort ---------------
    unp_gold = cpu_render_scene(cardioid, unp_cfg)
    for impl in ("entries", "dense"):
        r = Renderer(unp_cfg, dev, fine_impl=impl)
        kernels.reset_launches()
        img = r.render(cardioid)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        n_bad = int((img != unp_gold).any(-1).sum())
        print(f"render unpacked cardioid 1024x1024, 16x16 tiles, {impl} "
              f"route: {n_bad} pixels differ from the numpy oracle; "
              f"{unp_cfg.n_tiles} tiles x 2 * ({unp_cfg.max_items} + 1) = "
              f"{unp_cfg.n_tiles * 2 * (unp_cfg.max_items + 1)} >= 2^24; "
              f"launches {launches}", flush=True)
        assert n_bad == 0, f"unpacked {impl} image differs from the oracle"
        assert launches["sort"] == 1, launches

    # ---- 5. the device-animation paths ---------------------------------
    anim_launches = {}
    for tag, c, render_t, ni, npts in (
            ("affine tiger 1664x1664", aff_cfg, aff_render, aff_ni, aff_np),
            ("animated 1024x1024", anim_cfg, anim_render, anim_ni,
             anim_np)):
        kernels.reset_launches()
        frames = []
        for t in T_FRAMES:
            img, stats = render_t(t)
            frames.append((t, img, {k: int(v) for k, v in stats.items()}))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        anim_launches[tag] = launches
        for t, img, stats in frames:
            got = img.cpu().numpy().view(np.uint8).reshape(c.height,
                                                           c.width, 4)
            frame = fetch_scene(render_t.scene_at(t), ni, npts)
            t0 = time.perf_counter()
            gold = cpu_render_scene(frame, c)
            t_gold = time.perf_counter() - t0
            n_bad = int((got != gold).any(-1).sum())
            over = {k: stats[k] for k in ("seg_overflow", "hit_overflow",
                                          "cand_overflow")}
            print(f"render {tag} t={t:.4f}: {n_bad} pixels differ from the "
                  f"numpy oracle on the frame's own arrays (oracle "
                  f"{t_gold:.1f} s); segments {stats['n_segments']} hits "
                  f"{stats['n_hits']} candidates {stats['n_candidates']}; "
                  f"overflow {over}", flush=True)
            assert n_bad == 0, f"{tag} t={t}: image differs from the oracle"
            assert not any(over.values()), over
            assert int((got[..., 3] != 0).sum()) > 0
        print(f"launches {tag} ({len(T_FRAMES)} frames): {launches}",
              flush=True)
        assert launches["fine_dense"] == 0, launches
        assert all(v > 0 for k, v in launches.items()
                   if k != "fine_dense"), launches

    # ---- 6. timing ------------------------------------------------------
    dense_ops = {}
    for impl, (w, h) in itertools.product(("entries", "dense"),
                                          ((1664, 1664), (3840, 2160))):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev, fine_impl=impl)
        d = r.prepare(scene)
        frame = frame_ms(lambda: r.render_device(d), reps=20)
        # The same frames with the host's launch overhead hidden: what the
        # device itself spends per frame.
        frame_dev = time_ms(lambda: r.render_device(d), reps=5,
                            spin=8 * SPIN_CYCLES)
        if impl == "entries":
            rk = coarse_kw(r.config)
            ce = coarse.coarse_rasterize(d, **rk)
            args = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
                    ce.stream)
            fk = dict(tile_h=r.config.tile_height,
                      tile_w=r.config.tile_width, tiles_x=r.config.tiles_x)

            def fine_fn():
                return fine.fine_rasterize_entries(*args, **fk)
        else:
            rk = dict(coarse_kw(r.config), output="dense",
                      cmd_capacity=r.config.cmd_capacity)
            counts, tags, dargs, fk = dense_inputs(d, r.config)

            def fine_fn():
                return fine_xla.fine_rasterize_xla(counts, tags, dargs, **fk)
        t_coarse = frame_ms(lambda: coarse.coarse_rasterize(d, **rk),
                            reps=20)
        t_fine = frame_ms(fine_fn, reps=20)
        wall = wall_ms(lambda: r.render_device(d))
        tag = f"{impl} {w}x{h}"
        print(f"timing {tag} [{card}]: {frame:.3f} ms/frame (median of 20, "
              f"CUDA events per frame); pipelined wall {wall:.3f} ms/frame; "
              f"device {frame_dev:.3f} ms/frame; coarse {t_coarse:.3f} ms, "
              f"fine {t_fine:.3f} ms", flush=True)
        ops = profile_frames(lambda: r.render_device(d), card, tag)
        if impl == "dense":
            dense_ops[w, h] = ops

    for tag, render_t in (("affine tiger 1664x1664", aff_render),
                          ("animated 1024x1024", anim_render)):
        t = T_FRAMES[1]
        frame = frame_ms(lambda: render_t(t), reps=20)
        frame_dev = time_ms(lambda: render_t(t), reps=5,
                            spin=16 * SPIN_CYCLES)
        wall = wall_ms(lambda: render_t(t))
        print(f"timing {tag} [{card}]: {frame:.3f} ms/frame (median of 20, "
              f"CUDA events per frame); pipelined wall {wall:.3f} ms/frame; "
              f"device {frame_dev:.3f} ms/frame", flush=True)
        profile_frames(lambda: render_t(t), card, tag)

    for name, k in table.items():
        k["ms"] = time_ms(k.get("time", k["run"]), reps=20, warm=2)
        # The plain interpreters take seconds a call: few reps.
        plain_reps = {"fine": 3, "fine_dense": 1}.get(name, 20)
        k["plain_ms"] = time_ms(k.get("time_plain", k["plain"]),
                                reps=plain_reps, warm=0 if plain_reps == 1
                                else 1)
        k["library_ms"] = (time_ms(k["library"], reps=20, warm=2)
                           if k["library"] else None)
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k.get("ops", 0.0))
        lib_txt = (f"{k['library_ms']:.4f} ms" if k["library_ms"] is not None
                   else "none")
        print(f"timing kernel {name} [{card}]: {k['ms']:.4f} ms device, "
              f"plain version {k['plain_ms']:.4f} ms, library call "
              f"{lib_txt}, bound {k['bound_ms']:.5f} ms ({k['bound_by']}: "
              f"{k['bytes']} B, {k.get('ops', 0)} f32 ops; mean of "
              f"back-to-back calls, all of one frame's calls)", flush=True)

    # The device-memory route's case against torch.sort on the same keys.
    big_keys, big_val, _ = sort_cases["2^20 pairs"]
    t_big = time_ms(lambda: sort.stable_sort_multi(big_keys, big_val),
                    reps=20, warm=2)
    t_big_lib = time_ms(lambda: torch.sort(big_keys[0], stable=True),
                        reps=20, warm=2)
    print(f"timing kernel sort, 2^20 pairs, 25-bit keys [{card}]: "
          f"{t_big:.4f} ms device (device-memory route), torch.sort "
          f"{t_big_lib:.4f} ms", flush=True)
    # Both instantiations of the dense kernel on the tiger's PTCL (the
    # group one serves the dense frame; fine_rasterize is the TPU kernel's
    # own tag map), beside the device ops of a dense frame (phase 6's
    # profile).
    t_ng = time_ms(lambda: fine.fine_rasterize(*tiger_dense[:3],
                                               **tiger_dense[3]),
                   reps=20, warm=2)
    print(f"timing kernel fine_dense, both instantiations [{card}]: group "
          f"{table['fine_dense']['ms']:.4f} ms, non-group {t_ng:.4f} ms "
          f"device on the static 1664x1664 tiger's PTCL; "
          f"{dense_ops[1664, 1664]:.0f} device ops per dense frame",
          flush=True)

    # Each kernel's launches on a path that runs it: the affine tiger's two
    # frames (entries route) for the seven, one dense static tiger frame
    # for fine_dense.
    paths = {name: ("affine tiger 1664x1664, 2 frames, entries route",
                    anim_launches["affine tiger 1664x1664"][name])
             for name in table}
    paths["fine_dense"] = ("static tiger 1664x1664, 1 frame, dense route",
                           dense_launches[1664, 1664]["fine_dense"])
    print(json.dumps({"kernels": [
        {"name": name, "route": k["route"], "source": k["source"],
         "replaces": k["replaces"], "path": paths[name][0],
         "launches": paths[name][1],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for name, k in table.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _flat(sorted_out):
    keys, vals = sorted_out
    return tuple(keys) + (vals,)


if __name__ == "__main__":
    sys.exit(main())
