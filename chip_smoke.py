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
     sum through the one-stream keyed_sum); fine_dense on the static
     tiger's dense PTCL in both instantiations (fine_rasterize and fine_rasterize_xla), in the group
     one on the three fixtures, in both on the tiger's at 16x16 tiles and
     on the synthetic PTCLs of raster/synth_ptcl.py (tile widths 16, 24,
     128; group commands first at slots 0-128, streaks across the chunk
     boundary, counts above the capacity and zero); hitfuse also on the
     unpacked configuration's inputs (stride 0) and the affine tiger's
     (segments derived on the device);
  4. the static path: Renderer.for_scene(tiger, 1664, 1664).render() and
     the same at 3840x2160, with the launch counters reset just before
     and read just after each; the images must equal the numpy oracle
     bitwise, every kernel of the path (all but expand and fine_dense)
     must have run, and keyed, candfuse and gatherm once each;
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
     each replayed alone from a graph beside their eager time.

The line before the last is the kernel table as JSON, each kernel with
the path whose run gave its launch count (and, under "paths", every path
read: sort's second is the beziers_10k frame), the sort with its
device-memory route's times; the last line is {"ok": true,
"device": {...}}.  Exits non-zero without a result when no CUDA device is
present.
"""

import itertools
import json
import math
import re
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


#: CUDA API calls (``cuda*`` and ``cu*``) that enqueue work on a stream:
#: what the host pays per frame ("host calls per frame").
HOST_CALL = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                       r"GraphLaunch|Memcpy|Memset)")

#: The port's kernels (csrc/*.cu) by function name, and the memsets of
#: keyed and the sort, as a profiler trace names them.
OUR_KERNELS = ("cand_count", "cand_prep", "cand_expand", "hitfuse_kernel",
               "sort_cluster", "sort_upsweep", "sort_pass",
               "fine_entries_kernel", "tile_order", "fine_dense_kernel",
               "expand_kernel", "keyed_kernel", "gather_endpoints",
               "gather_rows", "backdrop", "Memset")


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
    with kernels.launches_apart():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
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
        assert launches["keyed"] == 1, launches
        # Kernel A one call (rows and expansion), gatherm one (backdrop).
        assert launches["candfuse"] == launches["gatherm"] == 1, launches

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
        assert all(v > 0 for k, v in launches.items()
                   if k != "fine_dense"), launches
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

    # Each kernel's launches on a path that runs it: the affine tiger's two
    # frames (entries route) for the seven, one dense static tiger frame
    # for fine_dense.
    # The sort's second path: the beziers_10k frame, whose sort takes the
    # device-memory route.
    paths = {name: [("affine tiger 1664x1664, 2 frames, entries route",
                     anim_launches["affine tiger 1664x1664"][name])]
             for name in table}
    paths["fine_dense"] = [("static tiger 1664x1664, 1 frame, dense route",
                            dense_launches[1664, 1664]["fine_dense"])]
    paths["sort"].append((
        "beziers_10k 1024x1024, 1 frame, entries route (device-memory "
        "route)", baseline["beziers_10k", "entries"][2]["sort"]))
    table["sort"]["device_memory_route"] = route2
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
