#!/usr/bin/env python3
"""Smoke run of the PyTorch port (piet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, one line each; any failure raises
and exits non-zero:

  1. the card's name and power limit (nvidia-smi's line, as it prints
     it), torch and CUDA versions;
  2. build the kernels from csrc/ with nvcc (timed);
  3. kernels A-D on the 1664^2 tiger's own inputs, each against its plain
     PyTorch version on the same inputs -- bitwise (tolerance 0);
  4. the main path: Renderer.for_scene(tiger, 1664, 1664).render(), with
     the launch counters reset just before and read just after; the image
     must equal the numpy oracle bitwise and every kernel must have run;
  5. the same at 3840x2160;
  6. timing with CUDA events: ms/frame at both sizes, the coarse/fine
     split, and each kernel beside its plain version; a torch.profiler
     trace of 10 frames per size gives the device-busy share and the
     device ops that take the most time.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is present.
"""

import json
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


def profile_frames(renderer, staged, card: str, tag: str,
                   frames: int = 10, top: int = 8) -> None:
    """Trace ``frames`` frames with torch.profiler; print the device-busy
    share and the ``top`` device ops by time per frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        renderer.render_device(staged)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            renderer.render_device(staged)
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
    from piet_tpu_torch import kernels
    from piet_tpu_torch.host import cpu_render_scene, make_tiger
    from piet_tpu_torch.ops import candfuse, coarse, fine, hitfuse, sort
    from piet_tpu_torch.renderer.renderer import (Renderer,
                                                  _solid_to_present_u32)

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
    ckw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
               tile_w=cfg.tile_width, tile_h=cfg.tile_height,
               max_segments=cfg.max_segments, max_hits=cfg.max_hits,
               max_candidates=cfg.max_candidates)
    print(f"config 1664x1664: items {cfg.max_items} segments "
          f"{cfg.max_segments} hits {cfg.max_hits} candidates "
          f"{cfg.max_candidates} tiles {cfg.n_tiles}", flush=True)

    # ---- 3. kernels vs their plain versions, on the slice's inputs -----
    taps = {}
    entries = coarse.coarse_rasterize(staged, taps=taps, **ckw)
    torch.cuda.synchronize()
    ci_in, akw = taps["candfuse"]
    hit_args, bkw = taps["hitfuse"]
    sort_key, sort_val = taps["sort"]
    fine_args = (entries.first, entries.n_entries,
                 _solid_to_present_u32(entries.solid), entries.stream)
    fkw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
               tiles_x=cfg.tiles_x)
    table = {
        "candfuse": dict(
            route="cuda", source="piet_tpu_torch/csrc/candfuse.cu",
            replaces="piet_tpu/ops/candfuse.py:47",
            run=lambda: candfuse.cand_records_fused(*ci_in, **akw),
            plain=lambda: candfuse.cand_records_fused_plain(*ci_in, **akw)),
        "hitfuse": dict(
            route="cuda", source="piet_tpu_torch/csrc/hitfuse.cu",
            replaces="piet_tpu/ops/hitfuse.py:73",
            run=lambda: (hitfuse.hit_records_fused(*hit_args, **bkw),),
            plain=lambda: (hitfuse.hit_records_fused_plain(*hit_args,
                                                           **bkw),)),
        "sort": dict(
            route="cuda", source="piet_tpu_torch/csrc/sort.cu",
            replaces="piet_tpu/ops/sort.py:111",
            run=lambda: _flat(sort.stable_sort_multi((sort_key,), sort_val)),
            plain=lambda: _flat(sort.stable_sort_multi_plain((sort_key,),
                                                             sort_val))),
        "fine": dict(
            route="cuda", source="piet_tpu_torch/csrc/fine.cu",
            replaces="piet_tpu/ops/fine.py:245",
            run=lambda: (fine.fine_rasterize_entries(*fine_args, **fkw),),
            plain=lambda: (fine.fine_rasterize_entries_plain(*fine_args,
                                                             **fkw),)),
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

    # ---- 4/5. the main path, bitwise against the numpy oracle ---------
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
        assert all(v > 0 for v in launches.values()), launches
        if (w, h) == (1664, 1664):
            main_launches = launches

    # ---- 6. timing ------------------------------------------------------
    for (w, h) in ((1664, 1664), (3840, 2160)):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev)
        d = r.prepare(scene)
        rk = dict(tiles_x=r.config.tiles_x, tiles_y=r.config.tiles_y,
                  tile_w=r.config.tile_width,
                  tile_h=r.config.tile_height,
                  max_segments=r.config.max_segments,
                  max_hits=r.config.max_hits,
                  max_candidates=r.config.max_candidates)
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            r.render_device(d)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 20
        print(f"timing {w}x{h} [{card}]: {frame:.3f} ms/frame (median of 20, "
              f"CUDA events per frame); pipelined wall {wall:.3f} ms/frame; "
              f"device {frame_dev:.3f} ms/frame; coarse {t_coarse:.3f} ms, "
              f"fine {t_fine:.3f} ms", flush=True)
        profile_frames(r, d, card, f"{w}x{h}")

    for name, k in table.items():
        k["ms"] = time_ms(k["run"], reps=20, warm=2)
        k["plain_ms"] = time_ms(k["plain"], reps=3 if name == "fine" else 20)
        print(f"timing kernel {name} 1664x1664 [{card}]: {k['ms']:.4f} ms "
              f"device, plain version {k['plain_ms']:.4f} ms (mean of "
              f"back-to-back calls)", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": k["route"], "source": k["source"],
         "replaces": k["replaces"], "launches": main_launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"]} for name, k in table.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _flat(sorted_out):
    (keys,), vals = sorted_out
    return keys, vals


if __name__ == "__main__":
    sys.exit(main())
