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
     bitwise (tolerance 0): candfuse, hitfuse, sort and fine on the
     static 1664^2 tiger's own inputs; expand, keyed and gatherm on the
     affine-animated tiger's (segments derived on the device);
  4. the static path: Renderer.for_scene(tiger, 1664, 1664).render() and
     the same at 3840x2160, with the launch counters reset just before
     and read just after each; the images must equal the numpy oracle
     bitwise, and every kernel of the path (all but expand) must have run;
  5. the device-animation paths, 2 frames each: the tiger under the
     affine spin/zoom at 1664^2 (make_affine_render_fn) and the animated
     fixture at 1024^2 (make_animated_render_fn).  Each frame must equal
     the numpy oracle rendered from that frame's own device-computed
     arrays, bitwise, with no capacity overflow; all seven kernels must
     have run;
  6. timing with CUDA events: ms/frame on every path, device ms with the
     launch overhead hidden, a torch.profiler trace (device-busy share and
     top device ops), and each kernel beside its plain version, its bound
     and, where one PyTorch call computes the same function, that call.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is present.
"""

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
#: float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
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
                   top: int = 8) -> None:
    """Trace ``frames`` frames with torch.profiler; print the device-busy
    share and the ``top`` device ops by time per frame."""
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


def affine_tiger(scene, dev):
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

    render_t = affine.make_affine_render_fn(cfg, scene, mats_fn, device=dev)
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
    from piet_tpu_torch.ops import (candfuse, coarse, expand, fine, gatherm,
                                    hitfuse, keyed, sort)
    from piet_tpu_torch.renderer.renderer import (Renderer,
                                                  _solid_to_present_u32,
                                                  fetch_scene)

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
    sort_key, sort_val = taps["sort"]
    fine_args = (entries.first, entries.n_entries,
                 _solid_to_present_u32(entries.solid), entries.stream)
    fkw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
               tiles_x=cfg.tiles_x)
    exp_args = atap["expand"]
    keyed_calls = atap["keyed"]
    gather_calls = atap["gatherm"]

    # The one PyTorch call computing the same function, where there is
    # one (timed beside the kernel; the port never calls it).
    ex_rows, ex_counts, ex_cap, _ = exp_args
    ex_n = int(ex_counts.sum())
    keyed_lib_keys = [torch.where((a[1] >= 0) & (a[1] < a[2]), a[1],
                                  a[2]).long() for a in keyed_calls]
    gather_lib_idx = [[i.long() for i in idxs] for _, idxs in gather_calls]
    n_ent = sort_key.shape[0]
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
            run=lambda: (hitfuse.hit_records_fused(*hit_args, **bkw),),
            plain=lambda: (hitfuse.hit_records_fused_plain(*hit_args,
                                                           **bkw),),
            library=None,
            bytes=hit_bytes),
        "sort": dict(
            route="cuda", source="piet_tpu_torch/csrc/sort.cu",
            replaces="piet_tpu/ops/sort.py:111",
            run=lambda: _flat(sort.stable_sort_multi((sort_key,), sort_val)),
            plain=lambda: _flat(sort.stable_sort_multi_plain((sort_key,),
                                                             sort_val)),
            library=lambda: torch.sort(sort_key, stable=True),
            bytes=2 * n_ent * 8),
        "fine": dict(
            route="cuda", source="piet_tpu_torch/csrc/fine.cu",
            replaces="piet_tpu/ops/fine.py:245",
            run=lambda: (fine.fine_rasterize_entries(*fine_args, **fkw),),
            plain=lambda: (fine.fine_rasterize_entries_plain(*fine_args,
                                                             **fkw),),
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
    }
    for name, k in table.items():
        got = k["run"]()
        torch.cuda.synchronize()
        want = k["plain"]()
        torch.cuda.synchronize()
        n_bad, err = 0, 0.0
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
    for (w, h) in ((1664, 1664), (3840, 2160)):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev)
        kernels.reset_launches()
        img = r.render(scene)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        gold = cpu_render_scene(scene, r.config)
        t_gold = time.perf_counter() - t0
        n_bad = int((img != gold).any(-1).sum())
        print(f"render {w}x{h}: {n_bad} pixels differ from the numpy oracle "
              f"(oracle {t_gold:.1f} s); launches {launches}; "
              f"live entries {r.last_stats['live_entries']}", flush=True)
        assert img.shape == (h, w, 4) and img.dtype == np.uint8
        assert n_bad == 0, f"{w}x{h} image differs from the oracle"
        # A static scene stages its segments on the host: no expansion.
        assert launches["expand"] == 0, launches
        assert all(v > 0 for k, v in launches.items() if k != "expand"), \
            launches

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
        assert all(v > 0 for v in launches.values()), launches

    # ---- 6. timing ------------------------------------------------------
    for (w, h) in ((1664, 1664), (3840, 2160)):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev)
        d = r.prepare(scene)
        rk = coarse_kw(r.config)
        frame = frame_ms(lambda: r.render_device(d), reps=20)
        # The same frames with the host's launch overhead hidden: what the
        # device itself spends per frame.
        frame_dev = time_ms(lambda: r.render_device(d), reps=5,
                            spin=8 * SPIN_CYCLES)
        ce = coarse.coarse_rasterize(d, **rk)
        args = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
                ce.stream)
        fk = dict(tile_h=r.config.tile_height, tile_w=r.config.tile_width,
                  tiles_x=r.config.tiles_x)
        t_coarse = frame_ms(lambda: coarse.coarse_rasterize(d, **rk),
                            reps=20)
        t_fine = frame_ms(lambda: fine.fine_rasterize_entries(*args, **fk),
                          reps=20)
        wall = wall_ms(lambda: r.render_device(d))
        print(f"timing {w}x{h} [{card}]: {frame:.3f} ms/frame (median of 20, "
              f"CUDA events per frame); pipelined wall {wall:.3f} ms/frame; "
              f"device {frame_dev:.3f} ms/frame; coarse {t_coarse:.3f} ms, "
              f"fine {t_fine:.3f} ms", flush=True)
        profile_frames(lambda: r.render_device(d), card, f"{w}x{h}")

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
        k["ms"] = time_ms(k["run"], reps=20, warm=2)
        k["plain_ms"] = time_ms(k["plain"], reps=3 if name == "fine" else 20)
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

    main_launches = anim_launches["affine tiger 1664x1664"]
    print(json.dumps({"kernels": [
        {"name": name, "route": k["route"], "source": k["source"],
         "replaces": k["replaces"], "launches": main_launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for name, k in table.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _flat(sorted_out):
    (keys,), vals = sorted_out
    return keys, vals


if __name__ == "__main__":
    sys.exit(main())
