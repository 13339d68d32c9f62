#!/usr/bin/env python3
"""Smoke run of the PyTorch port (piet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, one line each; any failure raises
and exits non-zero:

  1. the card's name and power limit (nvidia-smi's line, as it prints
     it), torch and CUDA versions;
  2. build the kernels from csrc/ with nvcc, one process per source
     (timed); the registers and stack bytes of kernel D's four
     instantiations and fine_dense's four (cuobjdump's resource usage of
     the built library);
  3. every kernel against its plain PyTorch version on the same inputs,
     bitwise (tolerance 0): candfuse -- the item rows from the scene
     (cand_inputs) on the static 1664^2 tiger, the affine tiger and
     beziers_10k at 1024^2, the coarse pass's call (rows and expansion)
     on the same three, and the expansion alone on the static tiger's
     rows -- and hitfuse on the static tiger's own inputs; sort on the
     tiger's keys, on the two keys of the unpacked configuration
     (below), on the tiger's keys with a val that
     is not increasing, on beziers_10k's keys at 1024^2 (261,504 pairs
     fitted, 368,640 bucketed: the device-memory route), and on random
     keys at 196,609, 261,504, 368,640 and 2^20 pairs, one and two keys
     (and with -0.0 key words); fine
     (kernel D) on the tiger's entries (no group command: the stackless
     path), on the clip, gradient and multi-subpath fixtures' at 1024^2
     (the stack path) and on the tiger's at 16x16 tiles; expand on the
     affine-animated tiger's (segments derived on the device); gatherm's
     endpoint fetch on the affine tiger's, its backdrop on the static
     and the affine tiger's, and the generic gather on the index streams
     of those three calls; keyed on the affine tiger's hit records
     (both of the coarse pass's sums in one call, read in place, and each
     sum through the one-stream keyed_sum); kernel D's paired
     instantiation on the tiger's and beziers_10k's compact and hole
     streams, and both instantiations on the synthetic streams of
     raster/synth_entries.py (two seeds, 128- and 16-pixel tiles), whose
     images must also equal the numpy oracle; pairing's compaction
     (expand.cu's piet_compact_rows) on both compact passes and its edge
     cases (all, none, the last or the first row kept, ragged blocks, one
     row, random keeps at 368,640 rows), rows and total, against the
     scatter and gather; fine_dense on the static
     tiger's dense PTCL in both instantiations (fine_rasterize and
     fine_rasterize_xla), in the group
     one on the three fixtures, in both on the tiger's at 16x16 tiles and
     on the synthetic PTCLs of raster/synth_ptcl.py (tile widths 16, 24,
     128; group commands first at slots 0-128, streaks across the chunk
     boundary, counts above the capacity and zero); hitfuse also on the
     unpacked configuration's inputs (stride 0) and the affine tiger's
     (segments derived on the device);
  4. the static path: Renderer.for_scene(tiger, 1664, 1664).render() and
     the same at 3840x2160, with the launch counters reset just before
     and read just after each; the images must equal the numpy oracle
     bitwise, every kernel of the path (all but fine_dense) must have
     run, keyed, candfuse and expand once each and gatherm twice (render
     stages the scene for one frame, which derives its segments on the
     card: the endpoint fetch, then the backdrop);
  4b. the dense path (fine_impl="dense"): the same two tiger frames
     against the same oracle images, with fine_dense run, entries-fine
     not run and no PTCL overflow; the three group fixtures at 1024^2; one
     affine-tiger frame; and render_sequence, render_packed_u32 and
     render_updated on animated-fixture frames, each equal to render();
  4c. the unpacked configuration -- the cardioid at 1024^2 in 16x16
     tiles with room for 2,048 items, whose packed sort key would reach
     2^24 -- on both routes, bitwise against the oracle (the two-key
     sort);
  4d. the BASELINE scenes circles_rects_1k, beziers_10k and glyph_page_5k
     at 1024^2 (Renderer.for_scene, bucketed) on both routes, bitwise
     against one oracle image each; beziers_10k's sort goes through the
     device-memory route (its launches are the sort's second path);
  4e. entry pairing (ops/pairing.py) on the entries route, off, compact
     and hole, at the tiger 1664^2 and beziers_10k 1024^2: each frame
     bitwise against the oracle, the graphed frame against the eager
     one, kernel D's paired instantiation launched once a frame and the
     compaction ("expand_pairing") once a compact frame, expand once (the
     segment derivation);
     live entries, kernel D (run dispatch on "off", paired on the others,
     three times each), the compaction eager and replayed from a graph,
     both fine_dense instantiations on the scene's dense PTCL and the
     graphed frame timed (``timing pairing kernels`` lines);
  4f. row slabs (parallel/sharding.py): the tiger at 1664^2 over 4
     contiguous slabs and over 2 slabs of 2 interleaved blocks, all on
     this card (each mesh's slabs one CUDA graph), both routes, bitwise
     against the one-slab graphed frame and the oracle; each slab derives
     its segments at its row0 (expand and gatherm launched); ms per frame
     beside the one-slab frame;
  4g. the reference's headline scene, bench.py's make_tiger(scale=19.2)
     at 3840x2160 with for_scene's bucketed capacities, both routes: the
     graphed frame bitwise against the oracle and the eager frame;
     graphed ms per frame, device busy, launches per kernel and the
     phase's seconds;
  5. the device-animation paths, 2 frames each: the tiger under the
     affine spin/zoom at 1664^2 (make_affine_render_fn) and the animated
     fixture at 1024^2 (make_animated_render_fn).  Each frame must equal
     the numpy oracle rendered from that frame's own device-computed
     arrays, bitwise, with no capacity overflow; all seven kernels of the
     entries route must have run, candfuse once a frame and gatherm
     twice (the endpoint fetch and the backdrop);
  5b. the graphs: every entry point replays a captured CUDA graph
     (renderer/graph.py), so phases 4-5 already ran through them; here
     each replayed frame is held against the eager frame (render_device:
     render_slab op by op) and the numpy oracle, 0 pixels off each: the
     static tiger at 1664^2 and 3840x2160 and the three BASELINE scenes
     (two replays in a row each; beziers_10k's sort on the device-memory
     route), both routes; the affine tiger and the animated fixture at
     both t, both routes; a 3-frame render_sequence (one graph) and
     render_updated after moved points, both routes; ResizableRenderer
     at two viewports with n_compiles() == 1; and the device memory of
     the 3840x2160 frame graph and the sequence graph;
  6. timing with CUDA events: ms/frame on every path (both routes of the
     static tiger), device ms with the launch overhead hidden, a
     torch.profiler trace (device-busy share and top device ops, and the
     device ops per frame beside commit 2581747's, before kernel A took
     its item rows and gatherm its indices and masks into their
     launches), and each kernel beside its plain version, its bound and,
     where one PyTorch call computes the same function, that call (and
     kernel A's and gatherm's calls apart); then kernel C's device-memory
     route on beziers_10k's keys (both sizes) and on 2^20 pairs beside
     its plain version, torch.sort and its bound, the three BASELINE
     frames on both routes, and both fine_dense instantiations beside the
     device ops of a dense frame.  Every timed cell (the static tiger
     and BASELINE frames on both routes, both animations on both routes,
     a 3-frame sequence) is also timed graphed beside eager: latency,
     throughput, device ms, host calls (the profiler's enqueueing CUDA
     calls), device ops and busy ms per frame, busy share, and each of
     the port's kernels' ms per frame in both; and kernel A's call and
     both sort routes (programmatic dependent and cluster launches) are
     each replayed alone from a graph beside their eager time;
  7. the command line (``piet_tpu_torch.cli.main``, in this process, the
     launch counters reset before and read after each command): render
     of the tiger at 1664^2 on both routes and of the tiger's SVG file
     at 1024^2 (that render, animate and bench take the default route,
     dense); animate, 3 frames each, of the animated fixture (device
     and host encode) and the affine tiger; goldens --tolerance 0 on both
     routes; bench of the tiger and of the re-encoded animated fixture
     (native builder) with its roofline; profile of the tiger at 1664^2
     and beziers_10k at 1024^2 on both routes (every stage >= 0, the
     dispatch floor and the stages within 10% of coarse_total, every
     pct_of_roofline <= 100); dump and info; a RenderContext scene; the
     C++ golden rasterizer's tiger beside the card's frame; host staging
     (fit_capacities, build_seg_pre, prepare_scene) timed.  Every image
     is held against the numpy oracle bitwise (the oracle images of
     phases 4 and 5 shared);
  8. the tools (piet_tpu_torch/tools/, the JAX package's tools/ that
     reach a Pallas kernel): div_probe, mosaic_numerics_probe,
     half_experiment, arg_delivery_bench and fine_entry_bench run through
     their ``main`` at the JAX tools' sizes, their lines printed after the
     card's nvidia-smi line, the launch counters reset before and read
     after (each of the three probe kernels of csrc/probes.cu must have
     run, and probe_numerics' division for div_probe, counted as
     probe_div); then each probe kernel bitwise against its plain version
     on the tools' inputs (every op and shape, state type and grid,
     delivery variant at one tile with the tool's REPS and at 676 tiles
     with 16, every tile's count of chain updates equal to
     delivery_passes), probe_div and probe_numerics 0 words off the numpy
     mirror (a mismatch fails the run), kernel D against its plain
     version on the bench's four streams, and each probe kernel timed
     beside its plain version and its bound (probe_div and the div and
     sqrt ops beside torch.div and torch.sqrt; every delivery variant at
     both widths);
  9. the rest of the tools: mosaic_probe (every probe of the JAX tool,
     kernel against plain at both fills of its unwritten scratch),
     grad_exact_probe and grad_tile_probe (the gradient demo on kernel
     D), group_stats on tiger_8x, mesh_balance (8 slabs on this card),
     eng_bisect_probe and eng_array_probe (the 224^2 tiger, card against
     CPU by stage and by kernel), engine_probe (the headline scene, card
     against CPU, each kernel alone; one process a setting),
     dispatch_probe and precompile_cache, each through its ``main``,
     lines printed after the card's nvidia-smi line, the launch counters
     reset before and read after (mosaic_probe's run: one probe_mosaic
     launch for its 22 probes x 2 fills, 2 of probe_dma16); then the
     batched launch's 22 x 2 outputs and all 23 probes one launch each
     kernel against plain at both fills, on the card and against the
     CPU (0 words off), engine_probe's leaves and bisect at 0 words off,
     the gradient demo 0 pixels off the oracle, and the two probe
     kernels timed beside their plain versions and their bound by bytes
     (the batch beside the 22 probes one launch each);
  10. the benchmark (``piet_tpu_torch.bench``, the port of the JAX
     package's root bench.py): its ``main`` in process on the default
     route and with ``--fine-impl entries``, the launch counters reset
     before and read after each; its lines printed (the card's, the five
     BASELINE configs, the headline tiger_4k with bench.py's keys, a
     roofline, ``vs_baseline`` null), no error line and exit 0; every
     frame kernel of the route launched, kernel C on its device-memory
     route at beziers_10k and on its cluster at the rest; each config's
     frame at bench's own fit (unbucketed) 0 pixels off the numpy oracle
     (the oracle images of phases 4 and 7 shared by scene_key, after
     checking on animated_clips that the capacities do not change the
     oracle's image); then tools/time_config.py's counterpart on
     tiger_4k.

The line before the last is the kernel table as JSON, each kernel with
the path whose run gave its launch count (and, under "paths", every path
read: sort's second is the beziers_10k frame; phase 10's two benchmark
runs are on every frame kernel that they launch), the sort with its
device-memory route's times, kernel D's paired instantiation
("fine_paired") and pairing's compaction ("expand_pairing") with the
launches of phase 4e's paired frames, the three probe kernels and
probe_div with phase 8's and the two access-pattern probe kernels with
phase 9's; the last line is
{"ok": true,
"device": {...}}.  Exits non-zero without a result when no CUDA device is
present.
"""

import itertools
import json
import math
import os
import re
import statistics
import sys
import time


#: GPU spin before a timed batch (~25 ms at H100 clocks), so the host
#: enqueues the whole batch while the device is busy and the events then
#: time back-to-back device work, not the host's launch overhead.
SPIN_CYCLES = 50_000_000

#: Float32 operations per pixel per command in the fine interpreter -- a
#: lower bound (a fill's trapezoid area or a line's distance field takes
#: more), so the fine bound is a least time.
FINE_OPS_PER_PIXEL_CMD = 10

#: Affine animation: the `animate --affine` defaults of the JAX package's
#: CLI (period, zoom, dt, frames), about the viewport centre.
PERIOD, ZOOM, DT, FRAMES = 4.0, 0.15, 1.0 / 60.0, 24
#: The two frames each animation path renders and checks.
T_FRAMES = (0.0, 23.0 / 60.0)

#: Device ops per frame at commit 2581747 (torch.profiler, NVIDIA H100
#: 80GB HBM3, 700.00 W), printed beside this run's: before kernel A built
#: its item rows and gatherm its index streams and masks in their own
#: launches.
OPS_BEFORE_COMMIT = "2581747"
OPS_BEFORE = {
    "entries 1664x1664": 429, "entries 3840x2160": 429,
    "dense 1664x1664": 446, "dense 3840x2160": 446,
    "circles_rects_1k 1024x1024 entries": 429,
    "circles_rects_1k 1024x1024 dense": 446,
    "beziers_10k 1024x1024 entries": 434, "beziers_10k 1024x1024 dense": 451,
    "glyph_page_5k 1024x1024 entries": 429,
    "glyph_page_5k 1024x1024 dense": 446,
    "affine tiger 1664x1664": 1366, "animated 1024x1024": 1269,
}


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


def frame_counts(launches) -> dict:
    """The launch counts of the frame's kernels: ``launches`` without the
    tools' probe kernels, which no frame runs."""
    from piet_tpu_torch.ops import probes
    return {k: v for k, v in launches.items() if k not in probes.KERNELS}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def row_bytes(n_rows: int, *tensors) -> int:
    """Bytes of ``n_rows`` rows of each tensor (rows along dim 0): what a
    kernel reads of inputs it reaches only at those rows."""
    return n_rows * sum(t[0].numel() * t.element_size() for t in tensors)


#: CUDA API calls (``cuda*`` and ``cu*``) that enqueue work on a stream:
#: what the host pays per frame ("host calls per frame").
HOST_CALL = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                       r"GraphLaunch|Memcpy|Memset)")

#: The port's kernels (csrc/*.cu) by function name, and the memsets of
#: keyed and the sort, as a profiler trace names them.
OUR_KERNELS = ("cand_count", "cand_prep", "cand_expand", "hitfuse_kernel",
               "sort_cluster", "sort_upsweep", "sort_pass",
               "fine_entries_kernel", "tile_order", "fine_dense_kernel",
               "expand_kernel", "compact_count", "compact_rows",
               "keyed_kernel", "gather_endpoints", "gather_rows",
               "backdrop", "Memset")


def kernel_name(name: str) -> str:
    """A trace's kernel name without namespace, return type and
    arguments: "fine_entries_kernel<8>"."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].strip()


def replay_of(fn):
    """``fn`` (device work only) captured in a CUDA graph after one warm-up
    call on a side stream; returns the graph's replay.  The launches of
    the warm-up and the capture are kept out of kernels.LAUNCHES."""
    import torch
    from piet_tpu_torch import kernels
    from piet_tpu_torch.renderer.graph import collector_paused
    with kernels.launches_apart():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with collector_paused(), torch.cuda.graph(graph):
            fn()
    return graph.replay


def trace_frames(render_one, frames: int = 10) -> dict:
    """torch.profiler over ``frames`` warm calls of ``render_one``: per
    frame, the device ops, the host's enqueueing CUDA calls, the device
    busy ms (summed kernel, copy and fill time), the wall ms (profiler on)
    and each device op name's (launches, ms)."""
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
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    calls = sum(1 for e in events if e.device_type == DeviceType.CPU
                and HOST_CALL.match(e.name))
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by_name = {}
    for e in kern:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return dict(ops=len(kern) / frames, host_calls=calls / frames,
                busy_ms=busy_us / frames / 1e3,
                wall_ms=wall_us / frames / 1e3, share=busy_us / wall_us,
                by_name={k: (n / frames, us / frames / 1e3)
                         for k, (n, us) in by_name.items()})


def profile_frames(render_one, card: str, tag: str, frames: int = 10,
                   top: int = 8) -> dict:
    """Trace ``frames`` frames with torch.profiler; print the device-busy
    share and the ``top`` device ops by time per frame; return the
    trace's numbers (:func:`trace_frames`)."""
    tr = trace_frames(render_one, frames)
    before = OPS_BEFORE.get(tag, "not measured")
    print(f"profile {tag} [{card}]: {tr['ops']:.0f} device ops "
          f"per frame ({OPS_BEFORE_COMMIT}: {before}), {tr['host_calls']:.0f}"
          f" host calls per frame, device busy {tr['busy_ms']:.3f} ms of "
          f"{tr['wall_ms']:.3f} ms/frame wall (busy share "
          f"{tr['share']:.3f}, profiler on)", flush=True)
    for name, (n, ms) in sorted(tr["by_name"].items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print(f"  {ms:.4f} ms/frame in {n:.0f} launches: {name[:90]}",
              flush=True)
    return tr


def graph_cell(card: str, tag: str, eager, graphed,
               frames_per_call: int = 1) -> dict:
    """One timed cell, the graphed frame beside the eager one: latency
    (median of 20 calls, CUDA events per call, host launch included),
    throughput (host clock around 20 back-to-back calls), device ms (5
    calls behind a GPU spin), host calls, device ops and busy ms per frame
    and the busy share (torch.profiler, 10 calls); then the port's
    kernels' ms per frame in each.  A call of
    ``eager``/``graphed`` renders ``frames_per_call`` frames."""
    k = frames_per_call
    res = {}
    for mode, fn in (("graphed", graphed), ("eager", eager)):
        tr = trace_frames(fn)
        res[mode] = dict(latency=frame_ms(fn, reps=20) / k,
                         wall=wall_ms(fn) / k,
                         device=time_ms(fn, reps=5, spin=8 * SPIN_CYCLES) / k,
                         host_calls=tr["host_calls"] / k,
                         ops=tr["ops"] / k, busy=tr["busy_ms"] / k,
                         share=tr["share"], by_name=tr["by_name"])
    g, e = res["graphed"], res["eager"]
    print(f"cell {tag} [{card}], graphed / eager: latency {g['latency']:.3f}"
          f" / {e['latency']:.3f} ms/frame; throughput {g['wall']:.3f} / "
          f"{e['wall']:.3f} ms/frame ({1e3 / g['wall']:.1f} / "
          f"{1e3 / e['wall']:.1f} frames/s); host calls per frame "
          f"{g['host_calls']:.1f} / {e['host_calls']:.1f}; device ops per "
          f"frame {g['ops']:.0f} / {e['ops']:.0f}; device busy "
          f"{g['busy']:.3f} / {e['busy']:.3f} ms/frame; device ms behind a "
          f"spin {g['device']:.3f} / {e['device']:.3f}; busy share "
          f"{g['share']:.3f} / {e['share']:.3f} (profiler on)", flush=True)
    ours = sorted({n for m in res.values() for n in m["by_name"]
                   if kernel_name(n).split("<")[0] in OUR_KERNELS})
    parts = []
    for n in ours:
        ms = [res[m]["by_name"].get(n, (0, 0.0))[1] / k
              for m in ("graphed", "eager")]
        parts.append(f"{kernel_name(n)} {ms[0]:.4f} / {ms[1]:.4f}")
    print(f"  kernels in cell {tag} [{card}], ms/frame graphed / eager: "
          + "; ".join(parts), flush=True)
    return res


def rgba(img) -> "np.ndarray":
    """(..., H, W) int32 RGBA8 bits on any device -> uint8 (..., H, W, 4)."""
    import numpy as np
    a = np.ascontiguousarray(img.cpu().numpy())
    return a.view(np.uint8).reshape(*a.shape, 4)


def graph_check(tag: str, graphed, eager, gold) -> None:
    """A graphed frame (uint8 RGBA) against the eager frame and the numpy
    oracle's: pixels that differ, tolerance 0."""
    n_eager = int((graphed != eager).any(-1).sum())
    n_gold = int((graphed != gold).any(-1).sum())
    print(f"graph {tag}: {n_eager} pixels differ from the eager frame, "
          f"{n_gold} from the numpy oracle", flush=True)
    assert graphed.shape == eager.shape == gold.shape, tag
    assert n_eager == 0 and n_gold == 0, f"graph {tag} differs"


def pool_line(card: str, tag: str, build) -> None:
    """Print the device memory that ``build`` (a first call, which captures
    a graph) peaks at and the memory its graph keeps reserved."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated()
    res0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    build()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - alloc0
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - res0
    print(f"memory {tag} [{card}]: peak {peak / 2**20:.1f} MiB allocated "
          f"above the {alloc0 / 2**20:.1f} MiB before (warm-up, capture, "
          f"replay); {held / 2**20:.1f} MiB reserved after, held by the "
          f"graph's private pool (torch.cuda.max_memory_allocated, "
          f"memory_reserved)", flush=True)


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


def animated_fixture(dev, fine_impl="entries"):
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
    render_t, tmpl = animate.make_animated_render_fn(cfg, device=dev,
                                                    fine_impl=fine_impl)
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
    # nvidia-smi's name and power limit of the card.
    from piet_tpu_torch.cli import card_line
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    sys.stdout.flush()

    import numpy as np
    import torch.nn.functional as F
    from piet_tpu_torch import kernels
    from piet_tpu_torch.host import cpu_render_scene, make_tiger
    from piet_tpu_torch.ops import (candfuse, coarse, dense_tail, expand,
                                    fine, fine_xla, gatherm, hitfuse, keyed,
                                    pairing, sort)
    from piet_tpu_torch.raster.synth_entries import synth_entry_streams
    from piet_tpu_torch.raster.synth_ptcl import synth_dense_ptcl
    from piet_tpu_torch.renderer.renderer import (Renderer,
                                                  _solid_to_present_u32,
                                                  fetch_scene)
    # The H100's peaks and the least-time bound (roofline.py).
    from piet_tpu_torch.roofline import bound
    from piet_tpu_torch.scene import fixtures
    from piet_tpu_torch.tools.pairing_ab import fine_resources

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(kernels.BUILD_DIR.parent.parent)}", flush=True)
    # Registers and stack (local memory) bytes of kernel D's four
    # instantiations (paired or not, 8 or 4 pixels a thread) and
    # fine_dense's four (groups or not, 8 or 4), from the built library.
    fine_res = fine_resources(kernels.resource_usage(lib))
    for name, r in fine_res.items():
        print(f"resources {name}: registers {r['REG']}, stack "
              f"{r['STACK']} B, local {r.get('LOCAL', 0)} B, shared "
              f"{r['SHARED']} B", flush=True)
    assert len(fine_res) == 8, sorted(fine_res)

    dev = torch.device("cuda")
    scene = make_tiger()
    renderer = Renderer.for_scene(scene, 1664, 1664, tile_height=32,
                                  tile_width=128, device=dev,
                                  fine_impl="entries")
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
    # Kernel A's item rows and the coarse pass's call of both launches:
    # the static tiger's, the affine tiger's and (below) beziers_10k's.
    cand_scenes = [taps["cand_inputs"], atap["cand_inputs"]]
    cand_caps = [cfg.max_candidates, aff_cfg.max_candidates]
    hit_args, bkw = taps["hitfuse"]
    fine_args = (entries.first, entries.n_entries,
                 _solid_to_present_u32(entries.solid), entries.stream)
    fkw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
               tiles_x=cfg.tiles_x)
    exp_args = atap["expand"]
    keyed_args = atap["keyed"]
    # gatherm: the affine tiger's endpoint fetch and backdrop (a frame's
    # calls), the static tiger's backdrop; and the generic gather on the
    # index streams the plain versions of those calls make.
    gather_calls = atap["gatherm"]
    assert [n for n, _ in gather_calls] == ["endpoints", "backdrop"]
    assert [n for n, _ in taps["gatherm"]] == ["backdrop"]
    gather_cases = gather_calls + taps["gatherm"]
    gather_streams = [gatherm.SITES[n][2](*a) for n, a in gather_cases]
    # The same two sums as one-stream keyed_sum calls (and the library's
    # index_add_): each sum's value column, and its keys with the dropped
    # ones (out of range; past the live count for the deltas) at n_out.
    k_rec, k_live, k_out = keyed_args
    k_dval = k_rec[:, hitfuse.K_DVAL]
    keyed_streams = keyed.record_streams(*keyed_args)
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
    # The dense tail on the sorted records of the static tiger's and the
    # group fixtures' dense passes.
    tail_cases = []
    for st, c in [(staged, cfg)] + [
            (gr.prepare(group_scenes[n]), gr.config)
            for n, gr in group_renderers.items()]:
        t = {}
        coarse.coarse_rasterize(st, output="dense",
                                cmd_capacity=c.cmd_capacity, taps=t,
                                **coarse_kw(c))
        tail_cases.append(t["dense_tail"])
    tail_in, tail_live, tail_kw = tail_cases[0]
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
    # beziers_10k at 1024^2: its coarse pass sorts E = 261,504 records
    # with the fitted capacities and 368,640 with for_scene's buckets.
    bez = fixtures.get_scene("beziers_10k")
    bez_taps = {}
    for bucket in (False, True):
        br = Renderer.for_scene(bez, 1024, 1024, device=dev, bucket=bucket)
        t = {}
        coarse.coarse_rasterize(br.prepare(bez), taps=t,
                                **coarse_kw(br.config))
        bez_taps[bucket] = t["sort"]
        if bucket:
            cand_scenes.append(t["cand_inputs"])
            cand_caps.append(br.config.max_candidates)
    # Kernel D's paired instantiation and expand as pairing's compaction:
    # the tiger's and beziers_10k's (bucketed) streams in both modes, and
    # the compaction's bundle and keep counts of each compact pass.
    bez_r = Renderer.for_scene(bez, 1024, 1024, device=dev,
                               fine_impl="entries")
    pair_cases, pair_bundles = [], []
    for tag, st, c in (("tiger 1664x1664", staged, cfg),
                       ("beziers_10k 1024x1024", bez_r.prepare(bez),
                        bez_r.config)):
        for mode in ("compact", "hole"):
            pt = {}
            ce = coarse.coarse_rasterize(st, pair=mode, taps=pt,
                                         **coarse_kw(c))
            pair_cases.append((f"{tag} {mode}", (
                ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
                ce.stream), dict(tile_h=c.tile_height, tile_w=c.tile_width,
                                 tiles_x=c.tiles_x, paired=True)))
            if mode == "compact":
                bundle, keep = pt["pairing"]
                pair_bundles.append((bundle, keep))
    # The synthetic streams of raster/synth_entries.py (streaks across the
    # chunk boundary, holes, the state copy at a begin clip): the paired
    # ones for the paired instantiation, the unpaired one for run
    # dispatch; each image also against the numpy oracle (below).
    synth_cases = []
    for seed, stw in ((0, 128), (1, 16)):
        syn = synth_entry_streams(seed, tile_w=stw)
        for mode, st in syn.streams.items():
            case = (f"synthetic seed {seed} {stw}x{syn.tile_h} {mode}",
                    tuple(torch.from_numpy(x).to(dev) for x in (
                        st.first, st.n_entries, np.zeros_like(st.first),
                        st.stream)),
                    dict(tile_h=syn.tile_h, tile_w=stw, tiles_x=syn.tiles_x,
                         paired=mode != "off"))
            synth_cases.append(case + (syn.oracle,))
            (fine_cases if mode == "off" else pair_cases).append(case)
    # The compaction's edge cases: all, none, only the last or the first
    # row kept, E past a multiple of its 512-row block, one row, and
    # random keeps at beziers_10k's E.
    cgen = torch.Generator(device=dev).manual_seed(15)
    for case, n in (("all", 1100), ("none", 1100), ("last", 1100),
                    ("first", 513), ("random", 1), ("random", 1537),
                    ("random", 368_640)):
        b = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, pairing.ROW_WORDS),
                          generator=cgen, device=dev, dtype=torch.int32)
        i = torch.arange(n, device=dev)
        k = {"all": i >= 0, "none": i < 0, "last": i == n - 1,
             "first": i == 0}.get(
            case, torch.rand(n, generator=cgen, device=dev) < 0.35)
        pair_bundles.append((b, k))
    gen = torch.Generator(device=dev).manual_seed(4)

    def random_case(n, n_keys):
        keys = []
        for _ in range(n_keys):
            k = torch.randint(0, 2 ** 24, (n,), generator=gen,
                              device=dev).to(torch.float32)
            k[torch.rand(n, generator=gen, device=dev) < 0.2] = math.inf
            keys.append(k)
        val = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        return tuple(keys), val, None

    sort_cases = {
        "tiger": (sort_keys, sort_val, sort_bounds),
        "unpacked, two keys": utaps["sort"],
        "tiger, val reversed": (sort_keys, torch.flip(sort_val, [0]),
                                sort_bounds),
        "beziers_10k fitted": bez_taps[False],
        "beziers_10k bucketed": bez_taps[True]}
    for n, n_keys in itertools.product((196_609, 261_504, 368_640, 1 << 20),
                                       (1, 2)):
        sort_cases[f"random {n} pairs, {n_keys} key(s)"] = random_case(
            n, n_keys)
    # -0.0 key words: the device-memory route gathers the outputs by index
    # instead of moving val with the key.
    (k,), v, _ = random_case(261_504, 1)
    k[::7] = -0.0
    sort_cases["random 261504 pairs, -0.0 keys"] = ((k,), v, None)
    for name, (k, v, b) in sort_cases.items():
        plan = sort.sort_plan(v.shape[0], b or (sort.KEY_LIMIT,) * len(k))
        route = (f"one launch, cluster of {plan.cluster} blocks of "
                 f"{plan.chunk} pairs" if plan.cluster else
                 f"device-memory route, {1 + len(plan.passes)} launches "
                 f"in tiles of {plan.chunk} pairs")
        print(f"sort case {name}: {v.shape[0]} pairs, {len(k)} key(s), "
              f"bounds {b}, {len(plan.passes)} digit passes {plan.passes}; "
              f"{route}", flush=True)

    # The one PyTorch call computing the same function, where there is
    # one (timed beside the kernel; the port never calls it).
    ex_rows, ex_counts, ex_cap, _ = exp_args
    ex_n = int(ex_counts.sum())
    keyed_lib_keys = [torch.where((a[1] >= 0) & (a[1] < a[2]), a[1],
                                  a[2]).long() for a in keyed_streams]
    gather_lib_idx = [[i.long() for i in idxs]
                      for _, idxs in gather_streams[:len(gather_calls)]]
    n_ent = sort_val.shape[0]
    fine_cmds = int(entries.counts.sum())
    tile_px = cfg.tile_width * cfg.tile_height
    img_bytes = cfg.tiles_x * cfg.tiles_y * tile_px * 4

    # Least bytes of each kernel on this run's data: each input row that
    # the outputs depend on read once, each output written once.  Rows of
    # a ragged source with a zero count, entries past a tile's live range,
    # values of dropped keys and gather rows no index reaches are not
    # counted.
    # Kernel A as the coarse pass calls it on the static tiger: the scene
    # fields read once (seven of the eight gradient words), the item rows,
    # counts, offsets and total written, then the candidate rows, tile and
    # ty written (the expansion's reads of the item rows are its own
    # output's).
    cand_scene, cand_kw = cand_scenes[0]
    cand_ni = cand_scene.tags.shape[0]
    cand_bytes = (cand_ni * (25 + 32 + 2) * 4 + 4 + 4
                  + akw["cap"] * (32 + 2) * 4)
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
    # keyed: each value word a sum must look at (every record's n_cmds,
    # the live records' d_val), the key word of each nonzero value, the
    # live count, and both outputs.
    k_n_live = min(int(k_live.reshape(-1)[0]), k_rec.shape[0])
    keyed_bytes = 4 * (k_rec.shape[0]
                       + int((k_rec[:, hitfuse.K_NCMDS] != 0).sum())
                       + k_n_live + int((k_dval[:k_n_live] != 0).sum())
                       + 1 + 2 * k_out)
    gather_bytes = gather_call_bytes(gather_calls)
    # Kernel D's paired instantiation on the tiger's compact stream: the
    # same image and command count as the unpaired stream, fewer entries.
    pf_args, pf_kw = pair_cases[0][1], pair_cases[0][2]
    pair_fine_bytes = (nbytes(*pf_args[:3])
                       + row_bytes(int(pf_args[1].sum()), pf_args[3])
                       + img_bytes)
    # The dense tail on the static tiger: every slot written once (a tag
    # and 12 operand words) with the per-tile words, each live record and
    # its source index read once.
    tail_bytes = (tail_kw["n_tiles"] * (tail_kw["cmd_capacity"] * 52 + 12)
                  + int(tail_live.sum()) * (64 + 4))
    # The compaction on the tiger's compact pass: the keep mask read (a
    # byte a row), each kept row read once, every output row and the total
    # written.
    pb, pk = pair_bundles[0]
    pk_i = pk.to(torch.int32)
    pk_n = int(pk.sum())
    pair_exp_bytes = (nbytes(pk) + pk_n * pb.shape[1] * 4
                      + pb.shape[0] * pb.shape[1] * 4 + 4)

    table = {
        "candfuse": dict(
            route="cuda", source="piet_tpu_torch/csrc/candfuse.cu",
            replaces="piet_tpu/ops/candfuse.py:47",
            run=lambda: sum((
                tuple(coarse.cand_inputs(sc, **kw))
                + _flat_stage(coarse.cand_stage(sc, cap=c, **kw))
                for (sc, kw), c in zip(cand_scenes, cand_caps)), ())
            + candfuse.cand_records_fused(*ci_in, **akw),
            plain=lambda: sum((
                tuple(coarse.cand_inputs_plain(sc, **kw))
                + _flat_stage(plain_cand_stage(sc, c, kw))
                for (sc, kw), c in zip(cand_scenes, cand_caps)), ())
            + candfuse.cand_records_fused_plain(*ci_in, **akw),
            time=lambda: coarse.cand_stage(cand_scene, cap=akw["cap"],
                                           **cand_kw),
            time_plain=lambda: plain_cand_stage(cand_scene, akw["cap"],
                                                cand_kw),
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
        # Compared on every case; timed on the tiger's keys.
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
        # The paired instantiation on the four paired streams and the
        # synthetic ones; timed on the tiger's compact stream (the "fine"
        # row's is its unpaired stream, on the run dispatch).
        "fine_paired": dict(
            route="cuda", source="piet_tpu_torch/csrc/fine.cu",
            replaces="piet_tpu/ops/fine.py:245",
            run=lambda: tuple(fine.fine_rasterize_entries(*a, **k)
                              for _, a, k in pair_cases),
            plain=lambda: tuple(fine.fine_rasterize_entries_plain(*a, **k)
                                for _, a, k in pair_cases),
            time=lambda: (fine.fine_rasterize_entries(*pf_args, **pf_kw),),
            time_plain=lambda: (fine.fine_rasterize_entries_plain(
                *pf_args, **pf_kw),),
            library=None,
            bytes=pair_fine_bytes,
            ops=fine_cmds * tile_px * FINE_OPS_PER_PIXEL_CMD),
        # Pairing's compaction (piet_compact_rows, its own two launches),
        # against the pairing's plain version (the scatter and gather), on
        # both compact passes' bundles and the edge cases; rows and total.
        "expand_pairing": dict(
            route="cuda", source="piet_tpu_torch/csrc/expand.cu",
            replaces="piet_tpu/ops/expand.py:81",
            run=lambda: sum((pairing.compact_rows(b, k)
                             for b, k in pair_bundles), ()),
            plain=lambda: sum((pairing.compact_rows_plain(b, k)
                               for b, k in pair_bundles), ()),
            time=lambda: (pairing.compact_rows(pb, pk),),
            time_plain=lambda: (pairing.compact_rows_plain(pb, pk),),
            library=lambda: F.pad(torch.repeat_interleave(
                pb, pk_i, dim=0, output_size=pk_n),
                (0, 0, 0, pb.shape[0] - pk_n)),
            bytes=pair_exp_bytes),
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
            run=lambda: keyed.record_keyed_sums(*keyed_args) + tuple(
                keyed.keyed_sum(*a) for a in keyed_streams),
            plain=lambda: keyed.record_keyed_sums_plain(*keyed_args)
            + tuple(keyed.keyed_sum_plain(*a) for a in keyed_streams),
            time=lambda: keyed.record_keyed_sums(*keyed_args),
            time_plain=lambda: keyed.record_keyed_sums_plain(*keyed_args),
            library=lambda: tuple(
                torch.zeros((a[2] + 1, a[0].shape[1]), device=dev)
                .index_add_(0, k, a[0])
                for a, k in zip(keyed_streams, keyed_lib_keys)),
            bytes=keyed_bytes),
        "gatherm": dict(
            route="cuda", source="piet_tpu_torch/csrc/gatherm.cu",
            replaces="piet_tpu/ops/gatherm.py:52",
            run=lambda: sum((_tuple(gatherm.SITES[n][0](*a))
                             for n, a in gather_cases), ())
            + sum((gatherm.gather_monotone(r, i)
                   for r, i in gather_streams), ()),
            plain=lambda: sum((_tuple(gatherm.SITES[n][1](*a))
                               for n, a in gather_cases), ())
            + sum((gatherm.gather_monotone_plain(r, i)
                   for r, i in gather_streams), ()),
            time=lambda: [gatherm.SITES[n][0](*a) for n, a in gather_calls],
            time_plain=lambda: [gatherm.SITES[n][1](*a)
                                for n, a in gather_calls],
            library=lambda: tuple(r.index_select(0, i)
                                  for (r, _), ii in zip(gather_streams,
                                                        gather_lib_idx)
                                  for i in ii),
            bytes=gather_bytes),
        # Compared on the tiger's and the group fixtures' records; timed
        # on the tiger's.  No TPU kernel: the JAX pass's dense tail is XLA.
        "dense_tail": dict(
            route="cuda", source="piet_tpu_torch/csrc/dense_tail.cu",
            replaces="none (XLA ops of piet_tpu/ops/coarse.py)",
            run=lambda: sum((dense_tail.dense_tail(*a, **k)
                             for a, _, k in tail_cases), ()),
            plain=lambda: sum((coarse._dense_ptcl(*a, live, **k)
                               for a, live, k in tail_cases), ()),
            time=lambda: dense_tail.dense_tail(*tail_in, **tail_kw),
            time_plain=lambda: coarse._dense_ptcl(*tail_in, tail_live,
                                                  **tail_kw),
            library=None,
            bytes=tail_bytes),
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
    # Kernel D on the synthetic streams against the numpy oracle of their
    # command lists (against its plain version in the table above).
    for name, a, k, oracle in synth_cases:
        img = fine.fine_rasterize_entries(*a, **k)
        got = img.cpu().numpy().view(np.uint8).reshape(oracle.shape)
        n_bad = int((got != oracle).any(-1).sum())
        print(f"kernel {'fine_paired' if k['paired'] else 'fine'} {name}: "
              f"{n_bad} pixels differ from the numpy oracle; entries "
              f"{a[1].tolist()}", flush=True)
        assert n_bad == 0, name
    streams = [(n, tuple(r.shape), len(i), i[0].shape[0])
               for (n, _), (r, i) in zip(gather_calls, gather_streams)]
    print(f"engine calls per frame on the affine tiger: expand 1 "
          f"{tuple(exp_args[0].shape)} -> {exp_args[2]} rows; keyed 1, two "
          f"sums of {tuple(k_rec.shape)} records ({k_n_live} live) -> 2 x "
          f"{k_out}; gatherm (site, generic rows, streams, slots) "
          f"{streams}", flush=True)

    # ---- 4. the static path, bitwise against the numpy oracle ---------
    golds = {}
    for (w, h) in ((1664, 1664), (3840, 2160)):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev, fine_impl="entries")
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
        # render() stages the scene for one frame: the frame derives its
        # segments on the card (one expansion); the entries route runs no
        # dense interpreter.
        assert launches["expand"] == 1, launches
        assert launches["fine_dense"] == 0, launches
        assert all(v > 0 for k, v in frame_counts(launches).items()
                   if k not in ("fine_dense", "dense_tail", "fine_paired",
                                "expand_pairing")), launches
        assert launches["keyed"] == 1, launches
        # Kernel A one call (rows and expansion), gatherm two (endpoints,
        # backdrop).
        assert launches["candfuse"] == 1, launches
        assert launches["gatherm"] == 2, launches

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
        assert launches["expand"] == 1, launches
        assert all(v > 0 for k, v in frame_counts(launches).items()
                   if k not in ("fine", "fine_paired",
                                "expand_pairing")), launches
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
    assert all(v > 0 for k, v in frame_counts(kernels.LAUNCHES).items()
               if k not in ("fine", "fine_paired", "expand_pairing"))
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

    # ---- 4d. the BASELINE scenes at 1024^2 -----------------------------
    baseline, baseline_gold = {}, {}
    for name, fixture in (("circles_rects_1k", "circles_rects"),
                          ("beziers_10k", "beziers_10k"),
                          ("glyph_page_5k", "glyph_page")):
        sc = bez if fixture == "beziers_10k" else fixtures.get_scene(fixture)
        renderers = {impl: Renderer.for_scene(sc, 1024, 1024, device=dev,
                                              fine_impl=impl)
                     for impl in ("entries", "dense")}
        c = renderers["entries"].config
        t0 = time.perf_counter()
        gold = cpu_render_scene(sc, c)
        t_gold = time.perf_counter() - t0
        for impl, r in renderers.items():
            kernels.reset_launches()
            img = r.render(sc)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            n_bad = int((img != gold).any(-1).sum())
            n_pairs = c.max_hits + c.max_candidates
            print(f"render {name} 1024x1024, {impl} route: {n_bad} pixels "
                  f"differ from the numpy oracle (oracle {t_gold:.1f} s); "
                  f"items {sc.n_items} points {sc.n_points}; sort of "
                  f"{n_pairs} pairs; launches {launches}", flush=True)
            assert n_bad == 0, f"{name} {impl} image differs from the oracle"
            assert launches["sort"] == 1 and launches[
                "fine" if impl == "entries" else "fine_dense"] == 1, launches
            baseline[name, impl] = (r, sc, launches)
        baseline_gold[name] = gold
        if name == "beziers_10k":
            k, v, b = bez_taps[True]
            assert v.shape[0] == n_pairs
            plan = sort.sort_plan(n_pairs, b)
            assert plan.cluster == 0, plan

    # ---- 4e. entry pairing on the entries route ------------------------
    t_phase = time.perf_counter()
    pair_launches = {}
    for tag, sc, c, gold in (
            ("tiger 1664x1664", scene, cfg, golds[1664, 1664]),
            ("beziers_10k 1024x1024", bez, bez_r.config,
             baseline_gold["beziers_10k"])):
        # The pairing path's kernels beside run dispatch and the dense
        # route's interpreter on the same scene (printed after the modes).
        pt_ms = {}
        for mode in ("off", "compact", "hole"):
            # The mode is read from PIET_PAIR when the renderer is built.
            os.environ["PIET_PAIR"] = mode
            r = Renderer(c, dev, fine_impl="entries")
            del os.environ["PIET_PAIR"]
            kernels.reset_launches()
            img = r.render(sc)
            torch.cuda.synchronize()
            launches = pair_launches[tag, mode] = dict(kernels.LAUNCHES)
            n_bad = int((img != gold).any(-1).sum())
            live = r.last_stats["live_entries"]
            print(f"render pairing {mode} {tag}: {n_bad} pixels differ from "
                  f"the numpy oracle; live entries {live}; launches "
                  f"{launches}", flush=True)
            assert n_bad == 0, f"pairing {mode} {tag} differs"
            # Kernel D's paired instantiation counts as "fine_paired", the
            # compaction as "expand_pairing" apart from the segment
            # derivation's one expansion ("expand").
            assert launches["fine"] == (mode == "off"), launches
            assert launches["fine_paired"] == (mode != "off"), launches
            assert launches["expand_pairing"] == (mode == "compact"), \
                launches
            assert launches["expand"] == 1, launches
            graph_check(f"pairing {mode} {tag}", rgba(r.render_u32(sc)),
                        rgba(r.render_device(r.prepare(sc))[0]), gold)
            pt = {}
            ce = coarse.coarse_rasterize(r.prepare(sc), pair=mode, taps=pt,
                                         **coarse_kw(c))
            fa = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
                  ce.stream)
            fk = dict(tile_h=c.tile_height, tile_w=c.tile_width,
                      tiles_x=c.tiles_x, paired=mode != "off")
            if mode == "off":
                # Kernel D's least time on this frame: its commands' f32
                # operations, as phase 6 bounds it on the tiger.
                b, by = bound(
                    nbytes(*fa[:3]) + row_bytes(int(ce.n_entries.sum()),
                                                ce.stream)
                    + c.tiles_x * c.tiles_y * c.tile_width * c.tile_height
                    * 4, int(ce.counts.sum()) * c.tile_width
                    * c.tile_height * FINE_OPS_PER_PIXEL_CMD)
                pt_ms[f"kernel D bound ({by})"] = b
            # Three runs, for the spread of kernel D's time.
            pt_ms[f"kernel D {mode}"] = [
                time_ms(lambda: fine.fine_rasterize_entries(*fa, **fk),
                        reps=20, warm=2) for _ in range(3)]
            t_fine = statistics.fmean(pt_ms[f"kernel D {mode}"])
            if mode == "compact":
                cb, ck = pt["pairing"]

                def compaction():
                    return pairing.compact_rows(cb, ck)
                pt_ms["compaction eager"] = time_ms(compaction, reps=20,
                                                    warm=2)
                pt_ms["compaction in a graph"] = time_ms(
                    replay_of(compaction), reps=20, warm=2)
                # Its least bytes: the keep mask, each kept row read once,
                # every output row and the total written.
                pt_ms["compaction bound (bytes)"] = bound(
                    nbytes(ck) + int(ck.sum()) * cb.shape[1] * 4
                    + nbytes(cb) + 4)[0]
            # Timed as a stage-once caller replays it: the host stage.
            staged_in = r._render.stage(r.prepare(sc))
            t_lat = frame_ms(lambda: r._render.flat(staged_in), reps=20)
            pt_ms[f"graphed frame {mode}"] = t_lat
            t_dev = time_ms(lambda: r._render.flat(staged_in), reps=10,
                            warm=2, spin=8 * SPIN_CYCLES)
            how = ("paired instantiation" if mode != "off"
                   else "run dispatch")
            print(f"timing pairing {mode} {tag} [{card}]: live entries "
                  f"{live}; kernel D {t_fine:.4f} ms device ({how}"
                  f"); graphed frame {t_lat:.3f} ms latency (median of 20), "
                  f"{t_dev:.3f} ms device behind a spin", flush=True)
            if tag.startswith("tiger") and mode != "off":
                d_e = r.prepare(sc)
                graph_cell(card, f"pairing {mode} {tag}",
                           lambda: r.render_device(d_e),
                           lambda: r._render.flat(staged_in))
        d = dense_inputs(r.prepare(sc), c)
        pt_ms["fine_dense non-group"] = time_ms(
            lambda: fine.fine_rasterize(*d[:3], **d[3]), reps=20, warm=2)
        pt_ms["fine_dense group"] = time_ms(
            lambda: fine_xla.fine_rasterize_xla(*d[:3], **d[3]), reps=20,
            warm=2)
        print(f"timing pairing kernels {tag} [{card}]: " + "; ".join(
            f"{k} " + (" / ".join(f"{x:.4f}" for x in v)
                       if isinstance(v, list) else
                       f"{v:.{5 if 'bound' in k else 4}f}") + " ms"
            for k, v in pt_ms.items()) + " (kernels: mean of 20 "
            "back-to-back calls behind a spin, kernel D three times; "
            "frames: median of 20 graphed frames)", flush=True)
    print(f"phase 4e (pairing): {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- 4f. row slabs on this card -------------------------------------
    from piet_tpu_torch.parallel import ShardedRenderer
    from piet_tpu_torch.renderer.renderer import prepare_scene
    t_phase = time.perf_counter()
    d_slab = prepare_scene(scene, cfg, "cpu", seg_pre=False)
    for impl in ("dense", "entries"):
        r1 = Renderer(cfg, dev, fine_impl=impl)
        one = rgba(r1.render_u32(scene))
        # The one-slab frame staged once with the host segment stage, then
        # with its segments derived on the card, as every slab derives
        # them (render_u32's signature).
        one_in = r1._render.stage(prepare_scene(scene, cfg, "cpu"))
        t_one = frame_ms(lambda: r1._render.flat(one_in), reps=20)
        one_dv = r1._render.stage(d_slab)
        t_one_dv = frame_ms(lambda: r1._render.flat(one_dv), reps=20)
        for n, il in ((4, 1), (2, 2)):
            sr = ShardedRenderer(cfg, ["cuda:0"] * n, fine_impl=impl,
                                 interleave=il)
            kernels.reset_launches()
            img = sr.render(scene)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            n_one = int((img != one).any(-1).sum())
            n_gold = int((img != golds[1664, 1664]).any(-1).sum())
            slabs = n * il
            print(f"render slabs tiger 1664x1664 {impl}, {n} slabs"
                  f"{f' of {il} interleaved blocks' if il > 1 else ''} on "
                  f"cuda:0: {n_one} pixels differ from the one-slab graphed "
                  f"frame, {n_gold} from the numpy oracle; launches "
                  f"{launches}; max_tile_cmds per slab "
                  f"{sr.last_stats['max_tile_cmds'].tolist()}", flush=True)
            assert n_one == 0 and n_gold == 0, f"slabs {impl} {n} {il}"
            assert launches["expand"] == slabs, launches
            assert launches["gatherm"] == 2 * slabs, launches
            assert launches["fine" if impl == "entries"
                            else "fine_dense"] == slabs, launches
            assert sr._render.n_graphs() == 1
            sd = sr._render.stage(d_slab)
            t_sh = frame_ms(lambda: sr._render(sd), reps=20)
            tr = trace_frames(lambda: sr._render(sd))
            print(f"timing slabs tiger 1664x1664 {impl}, {n} x {il} "
                  f"[{card}]: {t_sh:.3f} ms/frame graphed (one replay, "
                  f"{slabs} slabs, reassembly included; median of 20; "
                  f"device busy {tr['busy_ms']:.3f} ms/frame, "
                  f"{tr['ops']:.0f} device ops, profiler on) against "
                  f"{t_one:.3f} ms/frame one slab ({t_one_dv:.3f} with its "
                  f"segments derived on the card)", flush=True)
    print(f"phase 4f (row slabs): {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- 4g. the headline scene: the 19.2x tiger at 3840x2160 -----------
    t_phase = time.perf_counter()
    head = make_tiger(scale=19.2)
    head_gold = None
    for impl in ("dense", "entries"):
        r = Renderer.for_scene(head, 3840, 2160, tile_height=32,
                               tile_width=128, device=dev, fine_impl=impl)
        c = r.config
        if head_gold is None:
            n_pairs = c.max_hits + c.max_candidates
            plan = sort.sort_plan(n_pairs, coarse.sort_key_bounds(
                c.n_tiles, c.max_items))
            t0 = time.perf_counter()
            head_gold = cpu_render_scene(head, c)
            head_key = scene_key(head, c)
            print(f"config headline tiger 19.2x 3840x2160: items "
                  f"{head.n_items} points {head.n_points}; E = {n_pairs} "
                  f"({'cluster' if plan.cluster else 'device-memory'} sort "
                  f"route); cmd_capacity {c.cmd_capacity}; tiles "
                  f"{c.n_tiles}; oracle {time.perf_counter() - t0:.1f} s",
                  flush=True)
        kernels.reset_launches()
        img = rgba(r.render_u32(head))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        graph_check(f"headline tiger 19.2x 3840x2160 {impl}", img,
                    rgba(r.render_device(r.prepare(head))[0]), head_gold)
        st = r.last_stats
        # Timed as a stage-once caller replays it: the host stage.
        head_in = r._render.stage(r.prepare(head))
        t_lat = frame_ms(lambda: r._render.flat(head_in), reps=20)
        tr = trace_frames(lambda: r._render.flat(head_in))
        print(f"headline tiger 19.2x 3840x2160 {impl} [{card}]: graphed "
              f"{t_lat:.3f} ms/frame (median of 20, CUDA events); device "
              f"busy {tr['busy_ms']:.3f} ms/frame, busy share "
              f"{tr['share']:.3f}, {tr['ops']:.0f} device ops (profiler "
              f"on); launches {launches}; bail tiles {st['bail_tiles']}, "
              f"max per tile {st['max_tile_cmds']}", flush=True)
        assert all(launches[k] > 0 for k in (
            ENTRIES_KERNELS if impl == "entries" else DENSE_KERNELS))
    print(f"phase 4g (headline): {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- 5. the device-animation paths ---------------------------------
    anim_launches, anim_golds = {}, {}
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
            gold = anim_golds[tag, t] = cpu_render_scene(frame, c)
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
        assert all(v > 0 for k, v in frame_counts(launches).items()
                   if k not in ("fine_dense", "dense_tail", "fine_paired",
                                "expand_pairing")), launches
        # Per frame: kernel A one call, gatherm two (endpoints, backdrop).
        assert launches["candfuse"] == len(T_FRAMES), launches
        assert launches["gatherm"] == 2 * len(T_FRAMES), launches

    # ---- 5b. the graphs: every entry point's replayed frame against the
    # eager frame (render_device / render_slab, op by op) and the oracle --
    import dataclasses

    from piet_tpu_torch.renderer.renderer import (make_render_fn,
                                                  make_render_sequence_fn,
                                                  stack_scenes)
    from piet_tpu_torch.renderer.resize import ResizableRenderer
    for impl, (w, h) in itertools.product(("entries", "dense"),
                                          ((1664, 1664), (3840, 2160))):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev, fine_impl=impl)
        if (w, h) == (3840, 2160):
            pool_line(card, f"frame graph {impl} {w}x{h}",
                      lambda: r.render_u32(scene))
        graph_check(f"static tiger {w}x{h} {impl}", rgba(r.render_u32(scene)),
                    rgba(r.render_device(r.prepare(scene))[0]), golds[w, h])
    for (name, impl), (r, sc, _) in baseline.items():
        eager = rgba(r.render_device(r.prepare(sc))[0])
        # Two replays in a row (beziers_10k: the sort's counter memset and
        # keyed's, each replay's own).
        for k in (1, 2):
            graph_check(f"{name} 1024x1024 {impl}, replay {k}",
                        rgba(r.render_u32(sc)), eager, baseline_gold[name])
    anim_dense = animated_fixture(dev, fine_impl="dense")[1]
    for tag, c, fns in (
            ("affine tiger 1664x1664", aff_cfg,
             {"entries": aff_render, "dense": aff_dense}),
            ("animated 1024x1024", anim_cfg,
             {"entries": anim_render, "dense": anim_dense})):
        for (impl, render_t), t in itertools.product(fns.items(), T_FRAMES):
            eager = Renderer(c, dev, fine_impl=impl).render_device(
                render_t.scene_at(t))[0]
            graph_check(f"{tag} t={t:.4f} {impl}", rgba(render_t(t)[0]),
                        rgba(eager), anim_golds[tag, t])
    seq_frames = [make_animated_frame(k * 4 * DT) for k in range(3)]
    seq_golds = [cpu_render_scene(f, anim_cfg) for f in seq_frames]
    moved = dataclasses.replace(seq_frames[0],
                                points=seq_frames[0].points + 2.0,
                                bboxes=seq_frames[0].bboxes + 2)
    moved_gold = cpu_render_scene(moved, anim_cfg)
    for impl in ("entries", "dense"):
        ar = Renderer(anim_cfg, dev, fine_impl=impl)
        if impl == "entries":
            pool_line(card, "sequence graph entries animated 1024x1024, 3 "
                      "frames", lambda: ar.render_sequence(seq_frames))
        seq = ar.render_sequence(seq_frames)
        for i, f in enumerate(seq_frames):
            graph_check(f"render_sequence frame {i} of 3, animated fixture "
                        f"1024x1024 {impl}", seq[i],
                        rgba(ar.render_device(ar.prepare(f))[0]),
                        seq_golds[i])
        ar.render_u32(seq_frames[0])
        graph_check(f"render_updated (points moved), animated fixture "
                    f"1024x1024 {impl}", rgba(ar.render_updated(moved)),
                    rgba(ar.render_device(ar.prepare(moved))[0]), moved_gold)
        assert ar._render.n_graphs() == 1
    rr = ResizableRenderer.for_scene(scene, 1664, 1664, device=dev,
                                     tile_height=32, tile_width=128)
    for w, h in ((1664, 1664), (1280, 960)):
        vr = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                                device=dev)
        gold = (golds[w, h] if (w, h) in golds
                else cpu_render_scene(scene, vr.config))
        graph_check(f"ResizableRenderer tiger {w}x{h} of 1664x1664",
                    rr.render(scene, w, h),
                    rgba(vr.render_device(vr.prepare(scene))[0]), gold)
    print(f"ResizableRenderer: n_compiles() = {rr.n_compiles()} after 2 "
          f"viewports", flush=True)
    assert rr.n_compiles() == 1

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
        ops = profile_frames(lambda: r.render_device(d), card, tag)["ops"]
        if impl == "dense":
            dense_ops[w, h] = ops
        step = make_render_fn(r.config, dev, impl)
        ds = step.stage(d)
        graph_cell(card, f"static tiger {tag}", lambda: r.render_device(d),
                   lambda: step(ds))

    for (name, impl), (r, sc, _) in baseline.items():
        d = r.prepare(sc)
        frame = frame_ms(lambda: r.render_device(d), reps=20)
        frame_dev = time_ms(lambda: r.render_device(d), reps=5,
                            spin=8 * SPIN_CYCLES)
        wall = wall_ms(lambda: r.render_device(d))
        tag = f"{name} 1024x1024 {impl}"
        print(f"timing {tag} [{card}]: {frame:.3f} ms/frame (median of 20, "
              f"CUDA events per frame); pipelined wall {wall:.3f} ms/frame; "
              f"device {frame_dev:.3f} ms/frame; {sc.n_items} items",
              flush=True)
        profile_frames(lambda: r.render_device(d), card, tag)
        step = make_render_fn(r.config, dev, impl)
        ds = step.stage(d)
        graph_cell(card, tag, lambda: r.render_device(d), lambda: step(ds))

    for tag, c, render_t in (
            ("affine tiger 1664x1664", aff_cfg, aff_render),
            ("animated 1024x1024", anim_cfg, anim_render),
            ("affine tiger 1664x1664 dense", aff_cfg, aff_dense),
            ("animated 1024x1024 dense", anim_cfg, anim_dense)):
        t = T_FRAMES[1]
        er = Renderer(c, dev, fine_impl="dense" if "dense" in tag
                      else "entries")

        def eager_t():
            return er.render_device(render_t.scene_at(t))

        if "dense" not in tag:
            # The eager frame op by op (render_t itself replays a graph).
            frame = frame_ms(eager_t, reps=20)
            frame_dev = time_ms(eager_t, reps=5, spin=16 * SPIN_CYCLES)
            wall = wall_ms(eager_t)
            print(f"timing {tag} [{card}]: {frame:.3f} ms/frame (median of "
                  f"20, CUDA events per frame); pipelined wall {wall:.3f} "
                  f"ms/frame; device {frame_dev:.3f} ms/frame", flush=True)
            profile_frames(eager_t, card, tag)
        graph_cell(card, tag, eager_t, lambda: render_t(t))

    # A 3-frame sequence: one replay of the sequence graph against three
    # eager frames.
    for impl in ("entries", "dense"):
        seq_fn = make_render_sequence_fn(anim_cfg, dev, impl)
        staged = seq_fn.stage(stack_scenes(seq_frames, anim_cfg, dev))
        er = Renderer(anim_cfg, dev, fine_impl=impl)
        singles = [er.prepare(f) for f in seq_frames]
        graph_cell(card, f"render_sequence 3 frames animated 1024x1024 "
                   f"{impl}", lambda: [er.render_device(x) for x in singles],
                   lambda: seq_fn(staged), frames_per_call=3)

    for name, k in table.items():
        k["ms"] = time_ms(k.get("time", k["run"]), reps=20, warm=2)
        # The plain interpreters take seconds a call: few reps.
        plain_reps = {"fine": 3, "fine_paired": 3,
                      "fine_dense": 1}.get(name, 20)
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

    # Kernel A's two launches apart, and on beziers_10k's 10,000 items;
    # gatherm's calls apart and the generic gather on their streams.
    bez_scene, bez_kw = cand_scenes[2]
    parts = {
        "candfuse item rows (cand_inputs), static tiger": lambda:
            coarse.cand_inputs(cand_scene, **cand_kw),
        "candfuse expansion alone (cand_records_fused, tx written), static "
        "tiger": lambda: candfuse.cand_records_fused(*ci_in, **akw),
        "candfuse coarse pass's call, beziers_10k": lambda:
            coarse.cand_stage(bez_scene, cap=cand_caps[2], **bez_kw),
        "candfuse plain, beziers_10k": lambda:
            plain_cand_stage(bez_scene, cand_caps[2], bez_kw),
        "gatherm endpoint fetch, affine tiger": lambda:
            gatherm.gather_endpoints(*gather_calls[0][1]),
        "gatherm backdrop, affine tiger": lambda:
            gatherm.backdrop_from_csum(*gather_calls[1][1]),
        "gatherm generic gather on the affine frame's 3 streams": lambda: [
            gatherm.gather_monotone(r, i)
            for r, i in gather_streams[:len(gather_calls)]],
    }
    for what, fn in parts.items():
        print(f"timing kernel part {what} [{card}]: "
              f"{time_ms(fn, reps=20, warm=2):.4f} ms device", flush=True)
    # The programmatic dependent launches (kernel A's call: cand_prep
    # behind cand_count above 512 item slots, cand_expand behind
    # cand_prep; the sort's digit passes behind the upsweep) and the
    # cluster launch, each call alone replayed from a graph beside eager.
    bez_sort = sort_cases["beziers_10k bucketed"]
    for what, fn in (
            ("candfuse coarse pass's call, static tiger", lambda:
             coarse.cand_stage(cand_scene, cap=akw["cap"], **cand_kw)),
            ("candfuse coarse pass's call, beziers_10k", lambda:
             coarse.cand_stage(bez_scene, cap=cand_caps[2], **bez_kw)),
            ("sort device-memory route, beziers_10k bucketed", lambda:
             sort.stable_sort_multi(*bez_sort)),
            ("sort cluster route, static tiger", lambda:
             sort.stable_sort_multi(sort_keys, sort_val, sort_bounds))):
        t_graph = time_ms(replay_of(fn), reps=20, warm=2)
        t_eager = time_ms(fn, reps=20, warm=2)
        print(f"timing kernel in a graph, {what} [{card}]: {t_graph:.4f} ms "
              f"replayed, {t_eager:.4f} ms eager (mean of back-to-back "
              f"calls behind a spin)", flush=True)

    # The device-memory route on beziers_10k's keys and on 2^20 pairs,
    # beside its plain version, torch.sort on the first key and its bound
    # (each key and val word read once and written once).
    route2 = []
    for name in ("beziers_10k fitted", "beziers_10k bucketed",
                 "random 1048576 pairs, 1 key(s)"):
        k, v, b = sort_cases[name]
        n = v.shape[0]
        plan = sort.sort_plan(n, b or (sort.KEY_LIMIT,) * len(k))
        assert plan.cluster == 0, plan
        t_r2 = time_ms(lambda: sort.stable_sort_multi(k, v, b), reps=20,
                       warm=2)
        t_plain = time_ms(lambda: sort.stable_sort_multi_plain(k, v),
                          reps=20, warm=1)
        t_lib = time_ms(lambda: torch.sort(k[0], stable=True), reps=20,
                        warm=2)
        t_bound, by = bound(2 * n * 4 * (len(k) + 1))
        route2.append(dict(case=name, pairs=n, passes=len(plan.passes),
                           launches=1 + len(plan.passes), ms=t_r2,
                           plain_ms=t_plain, library_ms=t_lib,
                           bound_ms=t_bound, bound_by=by))
        print(f"timing kernel sort, device-memory route, {name}: {n} "
              f"pairs, {len(plan.passes)} passes, {1 + len(plan.passes)} "
              f"launches [{card}]: {t_r2:.4f} ms device, plain version "
              f"{t_plain:.4f} ms, torch.sort {t_lib:.4f} ms, bound "
              f"{t_bound:.5f} ms ({by})", flush=True)
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

    # ---- 7. the command line on the card --------------------------------
    # Oracle images by scene_key, shared by phases 7 and 10: phase 4's
    # tiger, phase 4d's BASELINE scenes and phase 4g's headline; phase 7
    # adds its own.
    oracle_images = {scene_key(scene, cfg): golds[1664, 1664],
                     head_key: head_gold}
    oracle_images.update({scene_key(sc, r.config): baseline_gold[name]
                          for (name, _), (r, sc, _) in baseline.items()})
    cli_paths = phase_cli(card, dev, scene, cfg, golds[1664, 1664],
                          aff_render, aff_ni, aff_np, anim_render, anim_ni,
                          anim_np, anim_golds, oracle_images)

    # ---- 8. the tools ----------------------------------------------------
    tool_table = phase_tools(card, dev)

    # ---- 9. the rest of the tools ----------------------------------------
    tool_table.update(phase_diag_tools(card, dev))

    # ---- 10. the benchmark -----------------------------------------------
    bench_paths = phase_bench(card, oracle_images)

    # Each kernel's launches on a path that runs it: the affine tiger's two
    # frames (entries route) for the seven, one dense static tiger frame
    # for fine_dense.
    # The sort's second path: the beziers_10k frame, whose sort takes the
    # device-memory route.
    paths = {name: [("affine tiger 1664x1664, 2 frames, entries route",
                     anim_launches["affine tiger 1664x1664"][name])]
             for name in table if name in kernels.LAUNCHES}
    # The paired instantiation and the compaction: phase 4e's paired
    # frames.
    paths["fine_paired"] = [
        (f"{tag}, 1 frame, entries route, pairing {mode}",
         pair_launches[tag, mode]["fine_paired"])
        for tag in ("tiger 1664x1664", "beziers_10k 1024x1024")
        for mode in ("compact", "hole")]
    paths["expand_pairing"] = [
        (f"{tag}, 1 frame, entries route, pairing compact",
         pair_launches[tag, "compact"]["expand_pairing"])
        for tag in ("tiger 1664x1664", "beziers_10k 1024x1024")]
    paths["fine_dense"] = [("static tiger 1664x1664, 1 frame, dense route",
                            dense_launches[1664, 1664]["fine_dense"])]
    paths["dense_tail"] = [("static tiger 1664x1664, 1 frame, dense route",
                            dense_launches[1664, 1664]["dense_tail"])]
    paths["sort"].append((
        "beziers_10k 1024x1024, 1 frame, entries route (device-memory "
        "route)", baseline["beziers_10k", "entries"][2]["sort"]))
    table["sort"]["device_memory_route"] = route2
    for name, runs in cli_paths.items():
        paths[name] += runs
    for name, k in tool_table.items():
        paths[name] = [(k["path"], k["launches"])]
    for name, runs in bench_paths.items():
        paths[name] += runs
    table.update(tool_table)
    print(json.dumps({"kernels": [
        {"name": name, "route": k["route"], "source": k["source"],
         "replaces": k["replaces"], "path": paths[name][0][0],
         "launches": paths[name][0][1],
         "paths": [{"path": p, "launches": n} for p, n in paths[name]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         **({"device_memory_route": k["device_memory_route"]}
            if "device_memory_route" in k else {})}
        for name, k in table.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


#: Kernels of the entries route and the dense route of a frame.
ENTRIES_KERNELS = ("candfuse", "hitfuse", "sort", "fine", "keyed", "gatherm")
DENSE_KERNELS = ("candfuse", "hitfuse", "sort", "dense_tail", "fine_dense",
                 "keyed", "gatherm")
#: Where phase 7's command lines write their PNGs (gitignored).
CLI_OUT = "build/chip_smoke_cli"


def run_cli(argv, expect=(), absent=(), paths=None):
    """``python -m piet_tpu_torch <argv>`` in this process, the launch
    counters set to 0 just before and read just after: (exit code, its
    stdout lines).  Prints one line; fails unless it exits 0, every kernel
    of ``expect`` ran and none of ``absent``.  Adds each kernel's launches
    to ``paths`` (kernel -> [(command, launches)])."""
    import contextlib
    import io

    import torch
    from piet_tpu_torch import cli, kernels
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cmd = "python -m piet_tpu_torch " + " ".join(argv)
    print(f"cli {cmd}: exit {rc}, {secs:.1f} s; launches {launches}",
          flush=True)
    assert rc == 0, cmd
    assert all(launches[k] > 0 for k in expect), (cmd, launches)
    assert all(launches[k] == 0 for k in absent), (cmd, launches)
    if paths is not None:
        for k, n in launches.items():
            if n:
                paths.setdefault(k, []).append((cmd, n))
    return buf.getvalue().splitlines()


def scene_key(sc, cfg) -> tuple:
    """A scene's arrays and the tile geometry: what an oracle image
    depends on (with a command capacity that drops nothing)."""
    import numpy as np
    return (cfg.width, cfg.height, cfg.tile_width, cfg.tile_height) + tuple(
        np.ascontiguousarray(getattr(sc, f)).tobytes()
        for f in ("tags", "colors", "widths", "bboxes", "pt_offset",
                  "n_pts", "points", "flags", "clips", "grads"))


def phase_cli(card, dev, scene, cfg, tiger_gold, aff_render, aff_ni,
              aff_np, anim_render, anim_ni, anim_np, anim_golds,
              golds) -> dict:
    """Phase 7: every command of the command line, in process, each image
    held against the numpy oracle bitwise (oracle images of phases 4 and
    5 shared by key: ``golds``, scene_key -> image, which this phase
    adds its own to); the profiler's and the roofline's checks; host
    staging timed.  Returns kernel -> [(command, launches)]."""
    import argparse
    import shutil
    from pathlib import Path

    import torch
    from piet_tpu_torch import cli, native
    from piet_tpu_torch.api import RenderContext
    from piet_tpu_torch.geometry import Affine
    from piet_tpu_torch.geometry.shapes import CirclePath, Line, Rect
    from piet_tpu_torch.geometry.shapes import RoundedRect
    from piet_tpu_torch.host import (RenderConfig, build_seg_pre,
                                     cpu_render_scene, fit_capacities)
    from piet_tpu_torch.profiling import PROFILED
    from piet_tpu_torch.renderer.renderer import (Renderer, fetch_scene,
                                                  prepare_scene)
    from piet_tpu_torch.roofline import frame_roofline
    from piet_tpu_torch.scene.fixtures import get_scene, make_animated_frame
    from piet_tpu_torch.scene.scene import RadialGradient
    from piet_tpu_torch.scene.svg import TIGER_PATH
    from piet_tpu_torch.scene.svg_full import load_svg_file
    from piet_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    out = Path(CLI_OUT)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths: dict = {}
    for (tag, t), g in anim_golds.items():
        render_t, ni, npts = ((aff_render, aff_ni, aff_np) if "affine" in tag
                              else (anim_render, anim_ni, anim_np))
        fc = cfg if "affine" in tag else RenderConfig(width=1024,
                                                      height=1024)
        golds[scene_key(fetch_scene(render_t.scene_at(t), ni, npts),
                        fc)] = g

    def oracle(sc, w, h):
        """The oracle image of ``sc`` at w x h in 32x128 tiles, with a
        command capacity fitted to it; phases 4-5's where they exist."""
        c = fit_capacities(sc, RenderConfig(width=w, height=h), bucket=True)
        key = scene_key(sc, c)
        if key not in golds:
            golds[key] = cpu_render_scene(sc, c)
        return golds[key]

    def check(tag, got, gold):
        n_bad = int((got != gold).any(-1).sum())
        print(f"cli image {tag}: {n_bad} pixels differ from the numpy "
              f"oracle", flush=True)
        assert got.shape == gold.shape and n_bad == 0, tag

    def ns(w, h):
        return argparse.Namespace(width=w, height=h)

    # The command line's configuration is phase 4's: one oracle image.
    assert cli._config_for(ns(1664, 1664), scene) == cfg
    tiger_png = {}
    for impl in ("entries", "dense"):
        png = out / f"tiger_{impl}.png"
        run_cli(["render", "--scene", "tiger", "--width", "1664",
                 "--height", "1664", "--fine-impl", impl, "--out", str(png)],
                ENTRIES_KERNELS if impl == "entries" else DENSE_KERNELS,
                ("fine_dense",) if impl == "entries" else ("fine",), paths)
        tiger_png[impl] = read_png(str(png))
        check(f"render tiger 1664x1664 {impl}", tiger_png[impl], tiger_gold)
    svg = Path(TIGER_PATH)
    png = out / "tiger_svg.png"
    run_cli(["render", "--svg", str(svg), "--width", "1024", "--height",
             "1024", "--out", str(png)], DENSE_KERNELS, ("fine",), paths)
    svg_scene = load_svg_file(str(svg), scale=None, target_width=1024)
    check("render --svg tiger 1024x1024 (the default route, dense)",
          read_png(str(png)),
          cpu_render_scene(svg_scene, cli._config_for(ns(1024, 1024),
                                                      svg_scene)))

    # Three frames each, t = 0, 23/120, 23/60 (two of them phase 5's).
    dt = 23.0 / 120.0
    ts = [i * dt for i in range(3)]
    anim = ["animate", "--frames", "3", "--dt", repr(dt)]
    for tag, argv, frames, size in (
            ("animated fixture, device", ["--scene", "animated", "--width",
                                          "1024", "--height", "1024"],
             [fetch_scene(anim_render.scene_at(t), anim_ni, anim_np)
              for t in ts], 1024),
            ("animated fixture, host encode",
             ["--scene", "animated", "--width", "1024", "--height", "1024",
              "--host-encode"], [make_animated_frame(t) for t in ts], 1024),
            ("affine tiger", ["--scene", "tiger", "--affine", "--width",
                              "1664", "--height", "1664"],
             [fetch_scene(aff_render.scene_at(t), aff_ni, aff_np)
              for t in ts], 1664)):
        d = out / tag.replace(" ", "_").replace(",", "")
        lines = run_cli(anim + argv + ["--outdir", str(d)], DENSE_KERNELS
                        + (() if "host" in tag else ("expand",)),
                        ("fine",), paths)
        print(f"cli animate {tag}: {lines[-2]} {lines[-1]}", flush=True)
        for i, fr in enumerate(frames):
            check(f"animate {tag} frame {i} (t={ts[i]:.4f})",
                  read_png(str(d / f"frame_{i:04d}.png")),
                  oracle(fr, size, size))

    for impl in ("entries", "dense"):
        lines = run_cli(["goldens", "--tolerance", "0", "--fine-impl", impl,
                         "--outdir", str(out / f"goldens_{impl}")],
                        ENTRIES_KERNELS if impl == "entries"
                        else DENSE_KERNELS, (), paths)
        print(f"cli goldens {impl}: " + "; ".join(lines), flush=True)

    assert native.available(), "the native cc/ library did not build"
    roofs = []
    for argv in (["bench", "--scene", "tiger", "--width", "1664", "--height",
                  "1664"],
                 ["bench", "--scene", "animated", "--reencode"]):
        lines = run_cli(argv, DENSE_KERNELS, ("fine",), paths)
        print("\n".join(f"cli bench: {ln}" for ln in lines[-3:]), flush=True)
        roofs.append(json.loads(lines[-3])["roofline"])

    profiles = {}
    for name, w, sc in (("tiger", 1664, scene),
                        ("beziers_10k", 1024, get_scene("beziers_10k"))):
        pcfg = cli._config_for(ns(w, w), sc)
        for impl in ("entries", "dense"):
            lines = run_cli(["profile", "--scene", name, "--width", str(w),
                             "--height", str(w), "--fine-impl", impl],
                            (), (), None)
            res = json.loads(lines[-1])
            stages = sum(res[n] for n in PROFILED)
            total = res["dispatch_floor"] + stages
            r = Renderer(pcfg, dev, fine_impl=impl)
            r.render(sc)
            roof = frame_roofline(r.last_stats, pcfg, res["coarse_total"],
                                  res["fine"], res["end_to_end"])
            roofs.append(roof)
            profiles[f"{name} {w}x{w} {impl}"] = dict(profile=res,
                                                      roofline=roof)
            print(f"cli profile {name} {w}x{w} {impl} [{card}]:\n"
                  + "\n".join(lines[:-2]), flush=True)
            print(f"cli profile {name} {w}x{w} {impl} [{card}]: "
                  f"dispatch_floor + stages {total:.4f} ms against "
                  f"coarse_total {res['coarse_total']:.4f} ms "
                  f"({100 * (total / res['coarse_total'] - 1):+.1f}%); "
                  f"roofline {json.dumps(roof)}", flush=True)
            assert all(v >= 0 for v in res.values()), res
            assert abs(total - res["coarse_total"]) <= (
                0.1 * res["coarse_total"]), res
    for roof in roofs:
        for stage, d in roof.items():
            assert d.get("pct_of_roofline", 0) <= 100, (stage, d)
    print(f"cli profiles [{card}]: {json.dumps(profiles)}", flush=True)

    lines = run_cli(["dump", "--scene", "tiger"], (), (), None)
    print(f"cli dump tiger: {len(lines)} lines, last {lines[-1]!r}",
          flush=True)
    lines = run_cli(["info"], (), (), None)
    print("cli info: " + "; ".join(lines), flush=True)

    # A RenderContext scene (tests/test_api.py's mixed one) on both routes.
    ctx = RenderContext()
    ctx.transform(Affine.rotate(math.radians(10.0))
                  * Affine.translate(10.0, -10.0))
    with ctx.clipped(CirclePath((64.0, 64.0), 56.0)):
        ctx.fill(Rect(-50.0, -50.0, 250.0, 250.0),
                 RadialGradient((64.0, 64.0), 70.0, 0xFFE000FF, 0x0030A0FF))
        ctx.stroke(Line((0.0, 20.0), (128.0, 100.0)), 0x000000FF, 3.0)
    ctx.fill(RoundedRect(70.5, 70.5, 120.5, 120.5, 8.0), 0x20C040FF)
    api_scene = ctx.finish()
    api_cfg = RenderConfig(width=128, height=128, tile_height=16,
                           tile_width=128, cmd_capacity=128)
    for impl in ("entries", "dense"):
        check(f"RenderContext scene 128x128 {impl}",
              Renderer(api_cfg, dev, fine_impl=impl).render(api_scene),
              cpu_render_scene(api_scene, api_cfg))

    # The C++ golden rasterizer on the tiger's wire bytes, beside the card.
    t0 = time.perf_counter()
    wire = native.init_scene_from_svg(Path(TIGER_PATH).read_text(), 8.0)
    golden, overflow = native.render_golden(
        wire, cfg.width, cfg.height, tile_w=cfg.tile_width,
        tile_h=cfg.tile_height, cmd_capacity=cfg.cmd_capacity)
    n_bad = int((golden != tiger_png["entries"]).any(-1).sum())
    print(f"native golden tiger 1664x1664 ({len(wire)} wire bytes, "
          f"{time.perf_counter() - t0:.2f} s, overflow {overflow}): "
          f"{n_bad} pixels differ from the card's frame", flush=True)
    assert overflow == 0 and n_bad == 0

    # Host staging: fit_capacities, build_seg_pre and prepare_scene (which
    # runs build_seg_pre and uploads), host clock, median of 3.
    for name, w, sc in (("tiger", 1664, scene),
                        ("beziers_10k", 1024, get_scene("beziers_10k"))):
        base = RenderConfig(width=w, height=w)
        c = fit_capacities(sc, base, bucket=True)

        def host_ms(fn):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        fit = host_ms(lambda: fit_capacities(sc, base, bucket=True))
        seg = host_ms(lambda: build_seg_pre(sc, c))
        prep = host_ms(lambda: prepare_scene(sc, c, dev))
        print(f"host staging {name} {w}x{w} [{card}]: fit_capacities "
              f"{fit:.3f} ms, build_seg_pre {seg:.3f} ms, prepare_scene "
              f"{prep:.3f} ms (build_seg_pre, padding and upload; "
              f"{sc.n_items} items, {sc.n_points} points; host clock, "
              f"median of 3)", flush=True)
    print(f"phase 7 (the command line): {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)
    return paths


#: The tools' kernels (csrc/probes.cu; probe_div is probe_numerics'
#: division op, counted apart), each with the JAX tool function whose
#: Pallas kernel it replaces.
TOOL_KERNELS = {
    "probe_div": "tools/div_probe.py:27",
    "probe_numerics": "tools/mosaic_numerics_probe.py:35",
    "probe_halfmix": "tools/half_experiment.py:49",
    "probe_delivery": "tools/arg_delivery_bench.py:278",
}


def phase_tools(card, dev) -> dict:
    """Phase 8: the five tools of piet_tpu_torch/tools/ as a user runs
    them (``main``), at the JAX tools' sizes, the launch counters reset
    before and read after (each of the four counters must have moved);
    then each probe kernel bitwise against its plain version on the
    tools' own inputs (probe_delivery on every tile at 1 and 676 tiles,
    with its pass counts), probe_div and probe_numerics 0 words off the
    numpy mirror (else the run fails), kernel D against its plain version
    on the bench's streams; and each probe kernel timed beside its plain
    version and its bound.  Returns the kernel table's rows."""
    import contextlib
    import io

    import numpy as np
    import torch
    from piet_tpu_torch import kernels
    from piet_tpu_torch.ops import fine, probes
    from piet_tpu_torch.roofline import bound
    from piet_tpu_torch.tools import (arg_delivery_bench, div_probe,
                                      fine_entry_bench, half_experiment,
                                      mosaic_numerics_probe)
    from piet_tpu_torch.tools.probes_ab import l2_cold

    t_phase = time.perf_counter()
    print(card, flush=True)
    tools = ((div_probe, ()), (mosaic_numerics_probe, ([],)),
             (half_experiment, ()), (arg_delivery_bench, ([],)),
             (fine_entry_bench, ([],)))
    kernels.reset_launches()
    for tool, args in tools:
        name = tool.__name__.rsplit(".", 1)[-1]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(*args)
        torch.cuda.synchronize()
        assert rc == 0, name
        for line in buf.getvalue().splitlines():
            print(f"tool {name}: {line}", flush=True)
        print(f"tool {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {k: kernels.LAUNCHES[k] for k in TOOL_KERNELS}
    print(f"launches phase 8 (tools): {launches}, fine "
          f"{kernels.LAUNCHES['fine']}", flush=True)
    assert all(n > 0 for n in launches.values()), launches
    assert kernels.LAUNCHES["fine"] > 0

    # probe_div (probe_numerics' division) on the tool's 2^20 operands:
    # against the plain division (torch's) and numpy's IEEE quotient.
    a, b = div_probe.operands()
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    div_out = probes.probe_div(at, bt)
    checks = {"probe_div": [bitwise(div_out, probes.probe_div_plain(at, bt))]}
    off = div_probe.words_off(div_out.cpu().numpy(), a / b)
    print(f"tool probe_div: {off} words off numpy of {a.size} (the "
          f"probe_numerics kernel's division op)", flush=True)
    assert off == 0, "probe_div differs from numpy's quotient"

    # probe_numerics: every op at both shapes, the 16 batches in one
    # launch, against its plain version and the strict numpy mirror.
    num_in = mosaic_numerics_probe.inputs()
    checks["probe_numerics"] = []
    num_calls = []
    for (name, shape), batches in num_in.items():
        ins = [torch.from_numpy(np.stack(c)).to(dev) for c in zip(*batches)]
        got = probes.probe_numerics(name, *ins)
        checks["probe_numerics"].append(
            bitwise(got, probes.probe_numerics_plain(name, *ins)))
        bad, tot, worst = mosaic_numerics_probe.compare(
            name, batches, got.cpu().numpy())
        print(f"tool probe_numerics {name} {shape}: {bad}/{tot} words off "
              f"the numpy mirror, worst ulp {worst}", flush=True)
        assert bad == 0, f"probe_numerics {name} {shape} differs from numpy"
        num_calls.append((name, ins))

    # probe_halfmix at the tool's shapes and N_ITER, both grids, all three
    # state types.
    checks["probe_halfmix"] = []
    for tiles in half_experiment.TILES:
        for shape in half_experiment.SHAPES:
            init = probes.halfmix_init(shape[0], dev)
            for kind in probes.HALFMIX_KINDS:
                n_it = half_experiment.N_ITER
                checks["probe_halfmix"].append(bitwise(
                    probes.probe_halfmix(init, kind, tiles, n_it),
                    probes.probe_halfmix_plain(init, kind, tiles, n_it)))

    # probe_delivery: every variant on the tool's stream, at one tile with
    # its REPS and at 676 tiles with 16, every tile's state bitwise the
    # plain version's and its count of chain updates delivery_passes'.
    # The dispatch variant's state ends at +inf everywhere there (178
    # multiplies past its last tag-3 entry), so it is held also on the
    # stream's first 87 entries, whose last is its first tag-3 entry and
    # whose state ends finite.  Each call is timed beside its bound.
    data = arg_delivery_bench.data(device=dev)
    widths = ((1, arg_delivery_bench.REPS),
              (arg_delivery_bench.WIDE_TILES, arg_delivery_bench.WIDE_REPS))
    checks["probe_delivery"] = []
    for v in probes.DELIVERY_VARIANTS:
        cases = [data] + ([data[:87].clone()] if v == "disp16" else [])
        for x in cases:
            for tiles, reps in widths:
                got, passes = probes.probe_delivery(x, v, reps, tiles)
                want, want_passes = probes.probe_delivery_plain(
                    x, v, reps, tiles)
                checks["probe_delivery"].append(bitwise(got, want))
                n_pass = probes.delivery_passes(x, v, reps)
                assert passes.tolist() == want_passes.tolist() == (
                    [n_pass] * tiles), (v, tiles, passes.unique())
                if v != "disp16" or x is not data:
                    assert torch.isfinite(got).all(), f"probe_delivery {v}"
        for tiles, reps in widths:
            ms = time_ms(lambda: probes.probe_delivery(data, v, reps, tiles),
                         reps=2, warm=0)
            b_ms, b_by = bound(data.numel() * 4 + tiles * (
                probes.DELIVERY_VARIANTS[v][0] * 128 + 1) * 4,
                probes.delivery_ops(data, v, reps, tiles))
            print(f"timing probe_delivery {v} [{card}]: {tiles} tiles x "
                  f"{reps} reps, {ms:.4f} ms, "
                  f"{ms * 1e6 / (data.shape[0] * reps * tiles):.3f} ns per "
                  f"entry and tile, bound {b_ms:.5f} ms ({b_by}), "
                  f"{100 * b_ms / ms:.2f}% of it; "
                  f"{probes.delivery_passes(data, v, reps)} chain updates "
                  f"a tile", flush=True)

    # Kernel D on the bench's streams (n = 34 a tile, each mix).
    fe_bad = 0
    for mix in fine_entry_bench.MIXES:
        args = fine_entry_bench.inputs(mix, 34, dev)
        fk = dict(tile_h=fine_entry_bench.TILE_H,
                  tile_w=fine_entry_bench.TILE_W,
                  tiles_x=fine_entry_bench.TILES_X)
        fe_bad += bitwise(fine_entry_bench.render(args),
                          fine.fine_rasterize_entries_plain(*args, **fk))[0]
    print(f"tool fine_entry_bench: kernel D {fe_bad} words off its plain "
          f"version on the 4 mixes at n=34", flush=True)
    assert fe_bad == 0

    rows = {}
    for name, res in checks.items():
        n_bad = sum(r[0] for r in res)
        err = max(r[1] for r in res)
        print(f"kernel {name}: {n_bad} mismatching words vs plain "
              f"(tolerance 0) over {len(res)} calls, max abs err {err}",
              flush=True)
        assert n_bad == 0, f"kernel {name} disagrees with its plain version"
        rows[name] = dict(route="cuda", source="piet_tpu_torch/csrc/probes.cu",
                          replaces=TOOL_KERNELS[name], max_abs_err=err,
                          path="phase 8 (tools): the five tools' main, "
                          "sizes as the JAX tools'",
                          launches=launches[name], library=None)

    # Timed calls: the tool's full call of each kernel.  Bytes: each input
    # read once and each output written once; operations: the f32 work of
    # the chain on this run's data (ops/probes.py).
    hm_shape, hm_tiles = half_experiment.SHAPES[0], half_experiment.TILES[1]
    hm_init = probes.halfmix_init(hm_shape[0], dev)
    n_it = half_experiment.N_ITER
    # probe_div's operands and output (12.6 MB a call) would stay in the
    # 50 MB L2 between back-to-back calls: each call takes the next of
    # sets (operands and output) that together are 4x the L2, so it reads
    # and writes device memory, as its bound counts.
    rows["probe_div"].update(
        time=l2_cold(probes.probe_div, at, bt),
        time_plain=l2_cold(probes.probe_div_plain, at, bt),
        library=l2_cold(torch.div, at, bt), bytes=3 * at.numel() * 4,
        timed="the tool's 2^20 operands, probe_numerics' division; "
        "operand and output sets 4x the L2 taken in turn")
    rows["probe_numerics"].update(
        time=lambda: [probes.probe_numerics(n, *i) for n, i in num_calls],
        time_plain=lambda: [probes.probe_numerics_plain(n, *i)
                            for n, i in num_calls],
        bytes=sum((len(i) + 1) * i[0].numel() * 4 for _, i in num_calls),
        timed="the 8 ops at both shapes, 16 batches a launch")
    rows["probe_halfmix"].update(
        time=lambda: probes.probe_halfmix(hm_init, "float32", hm_tiles,
                                          n_it),
        time_plain=lambda: probes.probe_halfmix_plain(
            hm_init, "float32", hm_tiles, n_it),
        bytes=hm_init.numel() * 4 + hm_tiles * hm_init[0].numel() * 4,
        ops=(hm_tiles * hm_init[0].numel() * n_it
             * probes.HALFMIX_OPS_PER_STEP),
        timed=f"f32, {hm_shape}, {hm_tiles} tiles, {n_it} steps")
    w_tiles, w_reps = widths[1]
    rows["probe_delivery"].update(
        time=lambda: probes.probe_delivery(data, "smem", w_reps, w_tiles),
        time_plain=lambda: probes.probe_delivery_plain(data, "smem", w_reps,
                                                       w_tiles),
        bytes=data.numel() * 4 + w_tiles * (8 * 128 + 1) * 4,
        ops=probes.delivery_ops(data, "smem", w_reps, w_tiles),
        timed=f"smem, {data.shape[0]} entries x {w_reps}, {w_tiles} tiles")
    # The tool's div and sqrt ops are single PyTorch calls: each op's
    # launch (both shapes, 16 batches) beside torch.div and torch.sqrt.
    for name, ins in num_calls:
        lib = {"div": torch.div, "sqrt": torch.sqrt}.get(name)
        if lib is None:
            continue
        k_ms = time_ms(lambda: probes.probe_numerics(name, *ins), reps=20)
        l_ms = time_ms(lambda: lib(*ins), reps=20, warm=2)
        print(f"timing probe_numerics {name} {tuple(ins[0].shape)} "
              f"[{card}]: {k_ms:.4f} ms, torch.{name} {l_ms:.4f} ms, bound "
              f"{bound(nbytes(*ins) + nbytes(ins[0]))[0]:.5f} ms (bytes)",
              flush=True)
    for name, k in rows.items():
        slow = name == "probe_halfmix"
        k["ms"] = time_ms(k["time"], reps=3 if slow else 20, warm=1)
        k["plain_ms"] = time_ms(k["time_plain"], reps=1 if slow else 20,
                                warm=0 if slow else 1)
        k["library_ms"] = (time_ms(k["library"], reps=20, warm=2)
                           if k["library"] else None)
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k.get("ops", 0.0))
        lib_txt = (f"{k['library_ms']:.4f} ms" if k["library_ms"] is not None
                   else "none")
        print(f"timing kernel {name} [{card}]: {k['ms']:.4f} ms device, "
              f"plain version {k['plain_ms']:.4f} ms, library call "
              f"{lib_txt}, bound {k['bound_ms']:.5f} ms ({k['bound_by']}: "
              f"{k['bytes']} B, {k.get('ops', 0)} f32 ops; {k['timed']})",
              flush=True)
    print(f"phase 8 (tools): {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows


#: The access-pattern probes' kernels (csrc/mosaic_probe.cu), each with
#: the JAX tool function whose Pallas kernel it replaces.
MOSAIC_KERNELS = {
    "probe_mosaic": "tools/mosaic_probe.py:33",
    "probe_dma16": "tools/mosaic_probe.py:152",
}
#: The tools of phase 9 and the arguments their ``main`` gets.
DIAG_TOOLS = (("mosaic_probe", []), ("grad_exact_probe", []),
              ("grad_tile_probe", []), ("group_stats", ["tiger_8x"]),
              ("mesh_balance", []), ("eng_bisect_probe", []),
              ("eng_array_probe", []), ("engine_probe", []),
              ("dispatch_probe", []), ("precompile_cache", []))


def phase_diag_tools(card, dev) -> dict:
    """Phase 9: the rest of the tools as a user runs them (``main``), the
    launch counters reset before and read after (mosaic_probe's default
    run: one probe_mosaic launch for its 22 probes at both fills, and
    probe_dma16 once a fill); then the batch of all 22 probes at both
    fills and all 23 probes one launch each, kernel against plain (0
    words off, on the card and against the plain version on the CPU),
    engine_probe's leaves and every kernel of its bisect at 0 words off,
    the gradient demo at 0 pixels off the oracle; and both probe kernels
    timed beside the plain versions and the bound by bytes (the batch
    beside the 22 probes in turn, one launch each).  Returns the kernel
    table's rows."""
    import contextlib
    import importlib
    import io

    import torch
    from piet_tpu_torch import kernels
    from piet_tpu_torch.ops import probes
    from piet_tpu_torch.roofline import bound
    from piet_tpu_torch.tools import mosaic_probe

    t_phase = time.perf_counter()
    print(card, flush=True)
    kernels.reset_launches()
    out = {}
    for name, args in DIAG_TOOLS:
        tool = importlib.import_module(f"piet_tpu_torch.tools.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(list(args))
        torch.cuda.synchronize()
        out[name] = buf.getvalue().splitlines()
        for line in out[name]:
            print(f"tool {name}: {line}", flush=True)
        print(f"tool {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        assert rc == 0, name
    launches = {k: kernels.LAUNCHES[k] for k in MOSAIC_KERNELS}
    print(f"launches phase 9 (the rest of the tools): {launches}",
          flush=True)
    assert launches == {"probe_mosaic": 1,
                        "probe_dma16": len(probes.FILLS)}, launches
    assert out["mosaic_probe"] == [f"{n}: OK" for n in mosaic_probe.PROBES]
    verdict = json.loads(out["engine_probe"][-1])
    assert verdict["engines_bit_identical"] is True, verdict
    assert verdict["bisect"] and all(v is True for v in
                                     verdict["bisect"].values()), verdict
    assert "[full demo] mismatched px: 0" in out["grad_exact_probe"]

    # Kernel against plain at both fills, on the card and against the
    # plain version on the CPU (the NaN words included): the batch of all
    # 22 probes, then every probe one launch each.
    names = list(probes.MOSAIC_PROBES)
    xs = {n: torch.from_numpy(mosaic_probe.probe_input(n)).to(dev)
          for n in mosaic_probe.PROBES}
    x = xs[names[0]]
    checks = {k: [] for k in MOSAIC_KERNELS}
    got = probes.probe_mosaic_batch(names, x)
    torch.cuda.synchronize()
    want = probes.probe_mosaic_batch_plain(names, x)
    want_cpu = probes.probe_mosaic_batch_plain(names, x.cpu())
    for f, fill in enumerate(probes.FILLS):
        for j, n in enumerate(names):
            res = [bitwise(got[f, j], want[f, j]),
                   bitwise(got[f, j].cpu(), want_cpu[f, j])]
            checks["probe_mosaic"] += res
            print(f"probe {n} fill {fill:#010x}, batched: {res[0][0]} "
                  f"words off the plain version on the card, {res[1][0]} "
                  f"on the CPU", flush=True)
    for n, xn in xs.items():
        k = "probe_dma16" if n == "dma_16lane" else "probe_mosaic"
        for fill in probes.FILLS:
            got = mosaic_probe.run(n, xn, fill)
            torch.cuda.synchronize()
            res = [bitwise(got, mosaic_probe.run_plain(n, xn, fill)),
                   bitwise(got.cpu(), mosaic_probe.run_plain(n, xn.cpu(),
                                                             fill))]
            checks[k] += res
            print(f"probe {n} fill {fill:#010x}: {res[0][0]} words off the "
                  f"plain version on the card, {res[1][0]} on the CPU",
                  flush=True)
    rows = {}
    for name, res in checks.items():
        n_bad = sum(r[0] for r in res)
        err = max(r[1] for r in res)
        print(f"kernel {name}: {n_bad} mismatching words vs plain "
              f"(tolerance 0) over {len(res)} comparisons, max abs err "
              f"{err}", flush=True)
        assert n_bad == 0, f"kernel {name} disagrees with its plain version"
        rows[name] = dict(route="cuda",
                          source="piet_tpu_torch/csrc/mosaic_probe.cu",
                          replaces=MOSAIC_KERNELS[name], max_abs_err=err,
                          path="phase 9 (the rest of the tools): "
                          "mosaic_probe's main, every probe at both fills",
                          launches=launches[name], library_ms=None)

    # Timed: the batch as the tool launches it (22 probes x 2 fills) and
    # at one fill, beside the 22 probes in turn, one launch each; and the
    # DMA probe.  Bytes: the input read once and every output written
    # once; the DMA probe reads the 896 rows its four copies reach.
    nan = probes.FILL_NAN
    per = {n: time_ms(lambda n=n: probes.probe_mosaic(n, x, nan), reps=50,
                      warm=2) for n in names}
    print("timing probe_mosaic per probe [" + card + "]: " + ", ".join(
        f"{n} {ms:.4f}" for n, ms in per.items()) + " ms", flush=True)
    one_fill = time_ms(lambda: probes.probe_mosaic_batch(names, x, (nan,)),
                       reps=50, warm=2)
    # 5 reps: the host enqueues the 110 launches within the spin.
    in_turn = time_ms(lambda: [probes.probe_mosaic(n, x, nan)
                               for n in names], reps=5, warm=2)
    print(f"timing probe_mosaic [{card}]: the {len(names)} probes at one "
          f"fill in one launch {one_fill:.4f} ms, in turn, one launch "
          f"each, {in_turn:.4f} ms", flush=True)
    n_runs = len(names) * len(probes.FILLS)
    xd = xs["dma_16lane"]
    rows["probe_mosaic"].update(
        time=lambda: probes.probe_mosaic_batch(names, x),
        time_plain=lambda: probes.probe_mosaic_batch_plain(names, x),
        bytes=(16 * 128 + n_runs * 8 * 128) * 4,
        timed=f"the {len(names)} probes x {len(probes.FILLS)} fills in one "
              "launch, as mosaic_probe runs them")
    rows["probe_dma16"].update(
        time=lambda: probes.probe_dma16(xd, nan),
        time_plain=lambda: probes.probe_dma16_plain(xd, nan),
        bytes=(probes.DMA16_MIN_ROWS * 16 + 8 * 128) * 4,
        timed="(1024, 16) input, four 32 KiB copies")
    for name, k in rows.items():
        k["ms"] = time_ms(k["time"], reps=20, warm=2)
        k["plain_ms"] = time_ms(k["time_plain"], reps=5, warm=1)
        k["bound_ms"], k["bound_by"] = bound(k["bytes"])
        print(f"timing kernel {name} [{card}]: {k['ms']:.4f} ms device, "
              f"plain version {k['plain_ms']:.4f} ms, library call none, "
              f"bound {k['bound_ms']:.6f} ms ({k['bound_by']}: "
              f"{k['bytes']} B; {k['timed']})", flush=True)
    print(f"phase 9 (the rest of the tools): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


#: Phase 10's runs of the benchmark: its arguments, the route's frame
#: kernels (each must launch) and the kernels it must not launch (static
#: scenes stage their segments: no expand).
BENCH_RUNS = (([], DENSE_KERNELS, ("fine", "expand", "fine_paired",
                                   "expand_pairing")),
              (["--fine-impl", "entries"], ENTRIES_KERNELS,
               ("fine_dense", "dense_tail", "expand", "fine_paired",
                "expand_pairing")))


def jax_bench_keys() -> set:
    """The keys of the JAX package's root bench.py headline line (its
    ``out`` dict literal, read with ast; the script is not imported)."""
    import ast
    tree = ast.parse(open("bench.py").read())
    return next({ast.literal_eval(k) for k in node.value.keys}
                for node in ast.walk(tree)
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "out"
                and isinstance(node.value, ast.Dict))


def phase_bench(card, golds) -> dict:
    """Phase 10: the benchmark as a user runs it, ``python -m
    piet_tpu_torch.bench`` (``bench.main``, in process) on the default
    route and with ``--fine-impl entries``, the launch counters reset
    before and read after each: its lines (the card's, five configs, the
    headline with the JAX script's keys and a roofline), no error line,
    exit 0; every frame kernel of the route launched, and kernel C's
    device-memory route at beziers_10k; every config's frame at bench's
    fit 0 pixels off the numpy oracle (``golds``, scene_key -> image,
    shared with phases 4 and 7: the oracle image does not depend on the
    capacities where none drops a command, which is checked first on
    animated_clips); then tools/time_config.py's main on tiger_4k.
    Returns kernel -> [(run, launches)]."""
    import contextlib
    import io

    import numpy as np
    import torch
    from piet_tpu_torch import bench, kernels
    from piet_tpu_torch.host import (RenderConfig, cpu_render_scene,
                                     fit_capacities)
    from piet_tpu_torch.ops import coarse, sort
    from piet_tpu_torch.tools import time_config

    t_phase = time.perf_counter()
    keys = jax_bench_keys() | {"roofline"}
    names = [n for n, _, _, _ in bench.CONFIGS]
    paths: dict = {}

    def run(fn, argv, record=None):
        buf = io.StringIO()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = (fn(argv) if record is None else fn(argv, record=record))
        torch.cuda.synchronize()
        lines = buf.getvalue().splitlines()
        print("\n".join(lines), flush=True)
        return rc, lines, dict(kernels.LAUNCHES), time.perf_counter() - t0

    claim_checked = False
    for argv, must, absent in BENCH_RUNS:
        cmd = " ".join(["python -m piet_tpu_torch.bench"] + argv)
        rec = {}
        rc, lines, launches, secs = run(bench.main, argv, rec)
        print(f"bench {cmd}: exit {rc}, {secs:.1f} s; launches {launches}",
              flush=True)
        assert rc == 0 and lines[0] == card, (cmd, rc, lines[:1])
        rows = [json.loads(ln) for ln in lines[1:]]
        assert not any("error" in r for r in rows), (cmd, rows)
        head = rows[-1]
        assert [r["config"] for r in rows[:-1]] == names, rows
        assert set(head) == keys, sorted(set(head) ^ keys)
        assert head["backend"] == "cuda" and head["vs_baseline"] is None
        assert head["metric"] == "tiger_4k_ms_per_frame", head
        assert "error" not in head["roofline"], head["roofline"]
        for stage, d in head["roofline"].items():
            assert d["measured_ms"] > 0 and d["pct_of_roofline"] <= 100, (
                stage, d)
        assert all(launches[k] > 0 for k in must), (cmd, launches)
        assert all(launches[k] == 0 for k in absent), (cmd, launches)
        for k, n in launches.items():
            if n:
                paths.setdefault(k, []).append(
                    (f"phase 10 (the benchmark): {cmd}, 6 configs", n))

        if not claim_checked:
            # The claim behind shared oracle images, on the cheapest
            # config: its oracle at bench's fit equals the one stored
            # under its scene_key (phase 7's, bucketed capacities).
            r = rec["animated_clips"]
            c = r["config"]
            key = scene_key(r["scene"], c)
            if key not in golds:  # phase 7 not run: for_scene's buckets
                golds[key] = cpu_render_scene(r["scene"], fit_capacities(
                    r["scene"], RenderConfig(width=c.width, height=c.height),
                    bucket=True))
            same = np.array_equal(golds[key],
                                  cpu_render_scene(r["scene"], c))
            print(f"bench oracle claim: animated_clips' oracle at bench's "
                  f"fit (cmd_capacity {c.cmd_capacity}) equal to the image "
                  f"stored under its scene_key (bucketed capacities): "
                  f"{same}", flush=True)
            assert same
            claim_checked = True
        for name, r in rec.items():
            c = r["config"]
            key = scene_key(r["scene"], c)
            reused = key in golds
            if not reused:
                golds[key] = cpu_render_scene(r["scene"], c)
            n_bad = int((r["image"] != golds[key]).any(-1).sum())
            n_pairs = c.max_hits + c.max_candidates
            plan = sort.sort_plan(n_pairs, coarse.sort_key_bounds(
                c.n_tiles, c.max_items))
            print(f"bench {cmd} {name} {c.width}x{c.height}: {n_bad} pixels "
                  f"differ from the numpy oracle ("
                  f"{'shared' if reused else 'rendered here'}); E = "
                  f"{n_pairs} ({'cluster' if plan.cluster else 'device-memory'}"
                  f" sort route), cmd_capacity {c.cmd_capacity}; launches "
                  f"{ {k: n for k, n in r['launches'].items() if n} }",
                  flush=True)
            assert n_bad == 0, f"bench {cmd} {name} differs from the oracle"
            assert r["launches"]["sort"] > 0, (name, r["launches"])
            # beziers_10k alone sorts on the device-memory route.
            assert (plan.cluster == 0) == (name == "beziers_10k"), (name,
                                                                    plan)

    rc, lines, launches, secs = run(time_config.main, ["tiger_4k"])
    out = json.loads(lines[-1])
    print(f"tool time_config tiger_4k: exit {rc}, {secs:.1f} s; launches "
          f"{launches}", flush=True)
    assert rc == 0 and lines[0] == card
    assert set(out) == {"config", "ms_per_frame", "viewport", "env"}, out
    assert out["ms_per_frame"] > 0 and out["viewport"] == "3840x2160"
    assert all(launches[k] > 0 for k in DENSE_KERNELS), launches
    print(f"phase 10 (the benchmark): {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def plain_cand_stage(scene, cap, kw):
    """The plain versions of kernel A as the coarse pass calls it: the
    item rows, then their expansion without cand_tx."""
    from piet_tpu_torch.ops import candfuse, coarse
    ci = coarse.cand_inputs_plain(scene, **kw)
    return (ci,) + candfuse.cand_records_fused_plain(
        *ci, kw["row0"], cap, tiles_x=kw["tiles_x"])[:3]


def _flat_stage(stage):
    """(CandInputs, ca, cand_tile, cand_ty) -> one flat tuple."""
    return tuple(stage[0]) + tuple(stage[1:4])


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def gather_call_bytes(calls) -> int:
    """Least bytes of gatherm's calls on this run's data: each word a call
    must read once (the endpoint fetch: four words of each live segment
    row, the carried point of a wrap-around, each distinct point row
    reached, n_segs; the backdrop: csum, three words of each candidate
    row and its tile row), each output written once."""
    import torch
    from piet_tpu_torch.ops import gatherm
    from piet_tpu_torch.scene.scene import TAG_CLIP, TAG_FILL
    total = 0
    for name, args in calls:
        if name == "endpoints":
            sitem, points, n_segs = args
            n = int(n_segs.reshape(-1)[0])
            _, (i0, j1) = gatherm.endpoint_streams(*args)
            local = (torch.arange(n, device=sitem.device)
                     - sitem[:n, gatherm.S_SEXCL])
            tag = sitem[:n, gatherm.S_TAG]
            wrap = (((tag == TAG_FILL) | (tag == TAG_CLIP))
                    & (local + 1 == sitem[:n, gatherm.S_NPTS]))
            reached = torch.unique(torch.cat([i0[:n], j1[:n][~wrap]]))
            total += (n * 4 + int(wrap.sum()) * 2 + reached.numel() * 2
                      + 1 + sitem.shape[0] * 4) * 4
        else:
            csum = args[0]
            total += csum.shape[0] * (1 + 3 + 1 + 1) * 4
    return total


def _flat(sorted_out):
    keys, vals = sorted_out
    return tuple(keys) + (vals,)


if __name__ == "__main__":
    sys.exit(main())
