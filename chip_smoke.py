#!/usr/bin/env python3
"""Exactness run of the PyTorch port (piet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  It times nothing: a frame's kernels are
timed by the benchmark's stage map (``python3 -m frame_bench.run
--trace 1``) and by ``python -m piet_tpu_torch profile``.  Phases, one
line a check; any failure raises and exits non-zero:

  1. the card's name and power limit (nvidia-smi's line, as it prints
     it), torch and CUDA versions;
  2. build the kernels from csrc/ with nvcc, one process per source; the
     registers and stack bytes of kernel D's four instantiations and
     fine_dense's four (cuobjdump's resource usage of the built library);
  3. every kernel against its plain PyTorch version on the same inputs,
     bitwise (tolerance 0): candfuse -- the item rows from the scene
     (cand_prep) on the static 1664^2 tiger, the affine tiger and
     beziers_10k at 1024^2, the coarse pass's call (rows and expansion,
     cand_prep_expand) on the same three, and the expansion alone on the
     static tiger's rows; hitfuse on the static tiger's inputs, the
     unpacked configuration's (stride 0) and the affine tiger's
     (segments derived on the device); sort on the tiger's keys, on the
     two keys of the unpacked configuration (below), on the tiger's keys
     with a val that is not increasing, on beziers_10k's keys at 1024^2
     (261,504 pairs fitted, 368,640 bucketed: the device-memory route),
     and on random keys at 196,609, 261,504, 368,640 and 2^20 pairs, one
     and two keys (and with -0.0 key words); fine (kernel D) on the
     tiger's entries (no group command: the stackless path), on the
     clip, gradient and multi-subpath fixtures' at 1024^2 (the stack
     path) and on the tiger's at 16x16 tiles; kernel D's paired
     instantiation on the tiger's and beziers_10k's compact and hole
     streams; both instantiations on the synthetic streams of
     raster/synth_entries.py (two seeds, 128- and 16-pixel tiles), whose
     images must also equal the numpy oracle; pairing's compaction
     (expand.cu's piet_compact_rows) on both compact passes and its edge
     cases (all, none, the last or the first row kept, ragged blocks, one
     row, random keeps at 368,640 rows), rows and total; expand on the
     affine-animated tiger's item rows; keyed on the affine tiger's hit
     records (both of the coarse pass's sums in one call, and each sum
     through the one-stream keyed_sum); gatherm's endpoint fetch on the
     affine tiger's, its backdrop on the static and the affine tiger's,
     and the generic gather on the index streams of those three calls;
     the dense tail on the sorted records of the static tiger's and the
     three group fixtures' dense passes; the entries tail (run words,
     per-tile ranges, bail) on the static tiger's, the affine tiger's and
     the unpacked configuration's entries passes and on the four paired
     passes of phase 4e's scenes; cand_rows on the static and the
     affine tiger's coarse passes (entry rows and sort keys); seg_rows on the segment
     derivation of the 19.2x tiger at 3840x2160 spun on the card (rows,
     hit counts, offsets and total; one launch); fine_dense on the static tiger's
     dense PTCL in both instantiations (fine_rasterize and
     fine_rasterize_xla), in the group one on the three fixtures, in both
     on the tiger's at 16x16 tiles and on the synthetic PTCLs of
     raster/synth_ptcl.py (tile widths 16, 24, 128; group commands first
     at slots 0-128, streaks across the chunk boundary, counts above the
     capacity and zero);
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
     device-memory route;
  4e. entry pairing (ops/pairing.py) on the entries route, off, compact
     and hole, at the tiger 1664^2 and beziers_10k 1024^2: each frame
     bitwise against the oracle, the graphed frame against the eager
     one, kernel D's paired instantiation launched once a frame and the
     compaction ("expand_pairing") once a compact frame, expand once (the
     segment derivation);
  4f. row slabs (parallel/sharding.py): the tiger at 1664^2 over 4
     contiguous slabs and over 2 slabs of 2 interleaved blocks, all on
     this card (each mesh's slabs one CUDA graph), both routes, bitwise
     against the one-slab graphed frame and the oracle; each slab derives
     its segments at its row0 (expand and gatherm launched);
  4g. the reference's headline scene, bench.py's make_tiger(scale=19.2)
     at 3840x2160 with for_scene's bucketed capacities, both routes: the
     graphed frame bitwise against the oracle and the eager frame, every
     kernel of the route launched;
  5. the device-animation paths, 2 frames each: the tiger under the
     affine spin/zoom at 1664^2 (make_affine_render_fn) and the animated
     fixture at 1024^2 (make_animated_render_fn).  Each frame must equal
     the numpy oracle rendered from that frame's own device-computed
     arrays, bitwise, with no capacity overflow; every kernel of the
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
     at two viewports with n_compiles() == 1;
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
     C++ golden rasterizer's tiger beside the card's frame.  Every image
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
     mirror, and kernel D against its plain version on the bench's four
     streams;
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
     and the gradient demo 0 pixels off the oracle;
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

The last line is {"ok": true, "device": {...}}.  Exits non-zero without
a result when no CUDA device is present.
"""

import itertools
import json
import math
import os
import re
import sys


#: Affine animation: the `animate --affine` defaults of the JAX package's
#: CLI (period, zoom, dt, frames), about the viewport centre.
PERIOD, ZOOM, DT, FRAMES = 4.0, 0.15, 1.0 / 60.0, 24
#: The two frames each animation path renders and checks.
T_FRAMES = (0.0, 23.0 / 60.0)
#: Kernel D's and fine_dense's instantiations in a mangled name: (kernel,
#: flag, pixels a thread); the flag is kPaired for kernel D, kGroups for
#: fine_dense.
FINE_NAME = re.compile(r"(fine_entries_kernel|fine_dense_kernel)"
                       r"ILb([01])ELi(\d+)EE")


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


def tiger_4k_seg_rows(dev):
    """The segment rows' call of the 19.2x tiger at 3840x2160 spun to the
    affine demo's second frame (its capacities bucketed, as the anim
    cell's): ((the call's arguments, keywords), the derivation's
    seg_rows launches)."""
    import torch
    from piet_tpu_torch import tracing
    from piet_tpu_torch.host import RenderConfig, fit_capacities, make_tiger
    from piet_tpu_torch.ops import candfuse, coarse
    from piet_tpu_torch.scene import affine

    scene = make_tiger(scale=19.2)
    cfg = fit_capacities(scene, RenderConfig(width=3840, height=2160,
                                             tile_height=32, tile_width=128),
                         bucket=True)

    def mats_fn(t):
        a = t * (2.0 * math.pi / PERIOD)
        return affine.rotation_about(1920.0, 1080.0, a,
                                     1.0 + ZOOM * torch.sin(a))

    render_t = affine.make_affine_render_fn(cfg, scene, mats_fn, device=dev)
    st = render_t.scene_at(T_FRAMES[1])
    ci = candfuse.cand_prep(st, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                            tile_w=cfg.tile_width, tile_h=cfg.tile_height)
    taps = {}
    with tracing.launches_apart() as launches:
        coarse.derive_seg_stage(st, ci.cand_pack[:, 15:24],
                                tile_w=cfg.tile_width,
                                tile_h=cfg.tile_height,
                                max_segments=cfg.max_segments, taps=taps)
    return taps["seg_rows"], launches["seg_rows"]


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
    from piet_tpu_torch import kernels, tracing
    from piet_tpu_torch.host import (RenderConfig, cpu_render_scene,
                                     fit_capacities, make_tiger)
    from piet_tpu_torch.ops import (cand_rows, candfuse, coarse, dense_tail,
                                    entries_tail, expand, fine, fine_xla,
                                    gatherm, hitfuse, keyed, pairing,
                                    seg_rows, sort)
    from piet_tpu_torch.raster.synth_entries import synth_entry_streams
    from piet_tpu_torch.raster.synth_ptcl import synth_dense_ptcl
    from piet_tpu_torch.renderer.renderer import (Renderer,
                                                  _solid_to_present_u32,
                                                  fetch_scene)
    from piet_tpu_torch.scene import fixtures

    # ---- 2. build ------------------------------------------------------
    lib = kernels.build()
    kernels.library()
    print(f"build: {lib.relative_to(kernels.BUILD_DIR.parent.parent)}",
          flush=True)
    # Registers and stack (local memory) bytes of kernel D's four
    # instantiations (paired or not, 8 or 4 pixels a thread) and
    # fine_dense's four (groups or not, 8 or 4), from the built library.
    fine_res = {}
    for name, r in kernels.resource_usage(lib).items():
        m = FINE_NAME.search(name)
        if m:
            kernel, flag, px = m.groups()
            what = "paired" if kernel == "fine_entries_kernel" else "groups"
            fine_res[f"{kernel}<{what}={flag}, R={px}>"] = r
    for name, r in sorted(fine_res.items()):
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
    fine_args = (entries.first, entries.n_entries,
                 _solid_to_present_u32(entries.solid), entries.stream)
    fkw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
               tiles_x=cfg.tiles_x)
    exp_args = atap["expand"]
    rows_cases = [taps["cand_rows"], atap["cand_rows"]]
    # The entries tail on the same passes' taps (the unpacked and the
    # paired passes' below), and on the pass of tiger_4k_entries.replay:
    # the 19.2x tiger at 3840x2160 in 32x128 tiles, its capacities fitted.
    etail_cases = [("tiger 1664x1664", taps["entries_tail"]),
                   ("affine tiger 1664x1664", atap["entries_tail"])]
    tiger_4k = make_tiger(scale=19.2)
    cfg_4k = fit_capacities(tiger_4k, RenderConfig(
        width=3840, height=2160, tile_height=32, tile_width=128))
    taps_4k = {}
    coarse.coarse_rasterize(Renderer(cfg_4k, dev).prepare(tiger_4k),
                            taps=taps_4k, **coarse_kw(cfg_4k))
    etail_cases.append(("tiger 3840x2160", taps_4k["entries_tail"]))
    # The segment rows of the 4K tiger spun on the card: one launch.
    (seg_args, seg_kw), seg_launches = tiger_4k_seg_rows(dev)
    print(f"kernel seg_rows: affine tiger 3840x2160 {seg_args[0].shape[0]} "
          f"slots, {int(seg_args[3][0])} live; launches of the derivation "
          f"{seg_launches}", flush=True)
    assert seg_launches == 1
    keyed_args = atap["keyed"]
    # gatherm: the affine tiger's endpoint fetch and backdrop (a frame's
    # calls), the static tiger's backdrop; and the generic gather on the
    # index streams the plain versions of those calls make.
    gather_calls = atap["gatherm"]
    assert [n for n, _ in gather_calls] == ["endpoints", "backdrop"]
    assert [n for n, _ in taps["gatherm"]] == ["backdrop"]
    gather_cases = gather_calls + taps["gatherm"]
    gather_streams = [gatherm.SITES[n][2](*a) for n, a in gather_cases]
    # The same two sums as one-stream keyed_sum calls: each sum's value
    # column, and its keys with the dropped ones (out of range; past the
    # live count for the deltas) at n_out.
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
    etail_cases.append(("unpacked cardioid 1024x1024",
                        utaps["entries_tail"]))
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
            etail_cases.append((f"{tag} {mode}", pt["entries_tail"]))
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

    # Every kernel on its cases above: (kernel's outputs, plain outputs).
    table = {
        "candfuse": (
            lambda: sum((
                tuple(candfuse.cand_prep(sc, **kw))
                + _flat_stage(candfuse.cand_prep_expand(sc, cap=c, **kw))
                for (sc, kw), c in zip(cand_scenes, cand_caps)), ())
            + candfuse.cand_records_fused(*ci_in, **akw),
            lambda: sum((
                tuple(candfuse.cand_inputs_plain(sc, **kw))
                + _flat_stage(candfuse.cand_prep_expand_plain(sc, cap=c,
                                                              **kw))
                for (sc, kw), c in zip(cand_scenes, cand_caps)), ())
            + candfuse.cand_records_fused_plain(*ci_in, **akw)),
        "hitfuse": (
            lambda: tuple(hitfuse.hit_records_fused(*a, **k)
                          for a, k in hit_cases),
            lambda: tuple(hitfuse.hit_records_fused_plain(*a, **k)
                          for a, k in hit_cases)),
        "sort": (
            lambda: sum((_flat(sort.stable_sort_multi(*c))
                         for c in sort_cases.values()), ()),
            lambda: sum((_flat(sort.stable_sort_multi_plain(*c[:2]))
                         for c in sort_cases.values()), ())),
        "fine": (
            lambda: tuple(fine.fine_rasterize_entries(*a, **k)
                          for _, a, k in fine_cases),
            lambda: tuple(fine.fine_rasterize_entries_plain(*a, **k)
                          for _, a, k in fine_cases)),
        # The paired instantiation on the four paired streams and the
        # synthetic ones.
        "fine_paired": (
            lambda: tuple(fine.fine_rasterize_entries(*a, **k)
                          for _, a, k in pair_cases),
            lambda: tuple(fine.fine_rasterize_entries_plain(*a, **k)
                          for _, a, k in pair_cases)),
        # Pairing's compaction (piet_compact_rows, its own two launches),
        # against the pairing's plain version (the scatter and gather), on
        # both compact passes' bundles and the edge cases; rows and total.
        "expand_pairing": (
            lambda: sum((pairing.compact_rows(b, k)
                         for b, k in pair_bundles), ()),
            lambda: sum((pairing.compact_rows_plain(b, k)
                         for b, k in pair_bundles), ())),
        "expand": (lambda: (expand.expand_rows(*exp_args),),
                   lambda: (expand.expand_rows_plain(*exp_args),)),
        "keyed": (
            lambda: keyed.record_keyed_sums(*keyed_args) + tuple(
                keyed.keyed_sum(*a) for a in keyed_streams),
            lambda: keyed.record_keyed_sums_plain(*keyed_args) + tuple(
                keyed.keyed_sum_plain(*a) for a in keyed_streams)),
        "gatherm": (
            lambda: sum((_tuple(gatherm.SITES[n][0](*a))
                         for n, a in gather_cases), ())
            + sum((gatherm.gather_monotone(r, i)
                   for r, i in gather_streams), ()),
            lambda: sum((_tuple(gatherm.SITES[n][1](*a))
                         for n, a in gather_cases), ())
            + sum((gatherm.gather_monotone_plain(r, i)
                   for r, i in gather_streams), ())),
        # The tiger's and the group fixtures' records.
        "dense_tail": (
            lambda: sum((dense_tail.dense_tail(*a, **k)
                         for a, _, k in tail_cases), ()),
            lambda: sum((dense_tail.dense_tail_plain(*a, live, **k)
                         for a, live, k in tail_cases), ())),
        # The entries tail of the static, affine, 4K and unpacked passes
        # and of the paired ones: run words (unpaired), ranges, counts,
        # bail.
        "entries_tail": (
            lambda: sum((entries_tail.entries_tail(*a, **k)
                         for _, (a, k) in etail_cases), ()),
            lambda: sum((entries_tail.entries_tail_plain(*a, **k)
                         for _, (a, k) in etail_cases), ())),
        # The static and the affine tiger's entry rows and sort keys.
        "cand_rows": (
            lambda: sum(((r,) + k for r, k in (
                cand_rows.cand_rows(*a, **kw) for a, kw in rows_cases)), ()),
            lambda: sum(((r,) + k for r, k in (
                cand_rows.cand_rows_plain(*a, **kw) for a, kw in rows_cases)),
                ())),
        # The 4K affine tiger's rows, hit counts, offsets and total.
        "seg_rows": (lambda: seg_rows.seg_rows(*seg_args, **seg_kw),
                     lambda: seg_rows.seg_rows_plain(*seg_args, **seg_kw)),
        # Both instantiations: the group one on the tiger's and the
        # fixtures' PTCLs, both on the tiger's, the 16x16 tiger's and the
        # synthetic ones.
        "fine_dense": (
            lambda: tuple(fine.fine_rasterize(*d[:3], **d[3])
                          for d in both_in) + tuple(
                fine_xla.fine_rasterize_xla(*d[:3], **d[3])
                for d in dense_in + both_in[1:]),
            lambda: tuple(fine.fine_rasterize_plain(*d[:3], **d[3])
                          for d in both_in) + tuple(
                fine_xla.fine_rasterize_xla_plain(*d[:3], **d[3])
                for d in dense_in + both_in[1:])),
    }
    for name, (run, plain) in table.items():
        got = run()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        n_bad, err = 0, 0.0
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            nb, e = bitwise(g, w)
            n_bad += nb
            err = max(err, e)
        print(f"kernel {name}: {n_bad} mismatching words vs plain "
              f"(tolerance 0), max abs err {err}", flush=True)
        assert n_bad == 0, f"kernel {name} disagrees with its plain version"
    # The entries tail case by case: each pass's rows and tiles.
    for tag, ((stream, e_tile), k) in etail_cases:
        got = entries_tail.entries_tail(stream, e_tile, **k)
        want = entries_tail.entries_tail_plain(stream, e_tile, **k)
        torch.cuda.synchronize()
        n_bad = sum(bitwise(g, w)[0] for g, w in zip(got, want))
        print(f"kernel entries_tail {tag}: {n_bad} mismatching words vs "
              f"plain; {stream.shape[0]} rows, {k['n_tiles']} tiles, "
              f"run words {k['run_words']}", flush=True)
        assert n_bad == 0, f"entries_tail {tag}"
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

    # ---- 4. the static path, bitwise against the numpy oracle ---------
    golds = {}
    for (w, h) in ((1664, 1664), (3840, 2160)):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev, fine_impl="entries")
        tracing.reset_launches()
        img = r.render(scene)
        torch.cuda.synchronize()
        launches = dict(tracing.LAUNCHES)
        gold = golds[w, h] = cpu_render_scene(scene, r.config)
        n_bad = int((img != gold).any(-1).sum())
        print(f"render {w}x{h}: {n_bad} pixels differ from the numpy oracle; "
              f"launches {launches}; live entries "
              f"{r.last_stats['live_entries']}", flush=True)
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
    for (w, h) in ((1664, 1664), (3840, 2160)):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev, fine_impl="dense")
        tracing.reset_launches()
        img = r.render(scene)
        torch.cuda.synchronize()
        launches = dict(tracing.LAUNCHES)
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
                   if k not in ("fine", "fine_paired", "expand_pairing",
                                "entries_tail")), launches
    for name, gr in group_renderers.items():
        sc = group_scenes[name]
        tracing.reset_launches()
        img = gr.render(sc)
        torch.cuda.synchronize()
        n_bad = int((img != cpu_render_scene(sc, gr.config)).any(-1).sum())
        print(f"render dense {name} 1024x1024: {n_bad} pixels differ from "
              f"the numpy oracle; fine_dense launches "
              f"{tracing.LAUNCHES['fine_dense']}, live commands "
              f"{gr.last_stats['live_cmds']}", flush=True)
        assert n_bad == 0, f"dense {name} image differs from the oracle"
        assert tracing.LAUNCHES["fine_dense"] == 1
    t = T_FRAMES[1]
    aff_dense = affine_tiger(scene, dev, fine_impl="dense")[1]
    tracing.reset_launches()
    img, stats = aff_dense(t)
    got = img.cpu().numpy().view(np.uint8).reshape(aff_cfg.height,
                                                   aff_cfg.width, 4)
    gold = cpu_render_scene(fetch_scene(aff_dense.scene_at(t), aff_ni,
                                        aff_np), aff_cfg)
    n_bad = int((got != gold).any(-1).sum())
    print(f"render dense affine tiger 1664x1664 t={t:.4f}: {n_bad} pixels "
          f"differ from the numpy oracle on the frame's own arrays; "
          f"launches {dict(tracing.LAUNCHES)}; overflow "
          f"{int(stats['overflow_cmds'])}", flush=True)
    assert n_bad == 0 and int(stats["overflow_cmds"]) == 0
    assert all(v > 0 for k, v in frame_counts(tracing.LAUNCHES).items()
               if k not in ("fine", "fine_paired", "expand_pairing",
                            "entries_tail"))
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
        tracing.reset_launches()
        img = r.render(cardioid)
        torch.cuda.synchronize()
        launches = dict(tracing.LAUNCHES)
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
        gold = cpu_render_scene(sc, c)
        for impl, r in renderers.items():
            tracing.reset_launches()
            img = r.render(sc)
            torch.cuda.synchronize()
            launches = dict(tracing.LAUNCHES)
            n_bad = int((img != gold).any(-1).sum())
            n_pairs = c.max_hits + c.max_candidates
            print(f"render {name} 1024x1024, {impl} route: {n_bad} pixels "
                  f"differ from the numpy oracle; "
                  f"items {sc.n_items} points {sc.n_points}; sort of "
                  f"{n_pairs} pairs; launches {launches}", flush=True)
            assert n_bad == 0, f"{name} {impl} image differs from the oracle"
            assert launches["sort"] == 1 and launches[
                "fine" if impl == "entries" else "fine_dense"] == 1, launches
            baseline[name, impl] = (r, sc)
        baseline_gold[name] = gold
        if name == "beziers_10k":
            k, v, b = bez_taps[True]
            assert v.shape[0] == n_pairs
            plan = sort.sort_plan(n_pairs, b)
            assert plan.cluster == 0, plan

    # ---- 4e. entry pairing on the entries route ------------------------
    pair_launches = {}
    for tag, sc, c, gold in (
            ("tiger 1664x1664", scene, cfg, golds[1664, 1664]),
            ("beziers_10k 1024x1024", bez, bez_r.config,
             baseline_gold["beziers_10k"])):
        for mode in ("off", "compact", "hole"):
            # The mode is read from PIET_PAIR when the renderer is built.
            os.environ["PIET_PAIR"] = mode
            r = Renderer(c, dev, fine_impl="entries")
            del os.environ["PIET_PAIR"]
            tracing.reset_launches()
            img = r.render(sc)
            torch.cuda.synchronize()
            launches = pair_launches[tag, mode] = dict(tracing.LAUNCHES)
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

    # ---- 4f. row slabs on this card -------------------------------------
    from piet_tpu_torch.parallel import ShardedRenderer
    for impl in ("dense", "entries"):
        one = rgba(Renderer(cfg, dev, fine_impl=impl).render_u32(scene))
        for n, il in ((4, 1), (2, 2)):
            sr = ShardedRenderer(cfg, ["cuda:0"] * n, fine_impl=impl,
                                 interleave=il)
            tracing.reset_launches()
            img = sr.render(scene)
            torch.cuda.synchronize()
            launches = dict(tracing.LAUNCHES)
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

    # ---- 4g. the headline scene: the 19.2x tiger at 3840x2160 -----------
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
            head_gold = cpu_render_scene(head, c)
            head_key = scene_key(head, c)
            print(f"config headline tiger 19.2x 3840x2160: items "
                  f"{head.n_items} points {head.n_points}; E = {n_pairs} "
                  f"({'cluster' if plan.cluster else 'device-memory'} sort "
                  f"route); cmd_capacity {c.cmd_capacity}; tiles "
                  f"{c.n_tiles}", flush=True)
        tracing.reset_launches()
        img = rgba(r.render_u32(head))
        torch.cuda.synchronize()
        launches = dict(tracing.LAUNCHES)
        graph_check(f"headline tiger 19.2x 3840x2160 {impl}", img,
                    rgba(r.render_device(r.prepare(head))[0]), head_gold)
        st = r.last_stats
        print(f"headline tiger 19.2x 3840x2160 {impl}: launches {launches}; "
              f"bail tiles {st['bail_tiles']}, max per tile "
              f"{st['max_tile_cmds']}", flush=True)
        assert all(launches[k] > 0 for k in (
            ENTRIES_KERNELS if impl == "entries" else DENSE_KERNELS))

    # ---- 5. the device-animation paths ---------------------------------
    anim_golds = {}
    for tag, c, render_t, ni, npts in (
            ("affine tiger 1664x1664", aff_cfg, aff_render, aff_ni, aff_np),
            ("animated 1024x1024", anim_cfg, anim_render, anim_ni,
             anim_np)):
        tracing.reset_launches()
        frames = []
        for t in T_FRAMES:
            img, stats = render_t(t)
            frames.append((t, img, {k: int(v) for k, v in stats.items()}))
        torch.cuda.synchronize()
        launches = dict(tracing.LAUNCHES)
        for t, img, stats in frames:
            got = img.cpu().numpy().view(np.uint8).reshape(c.height,
                                                           c.width, 4)
            frame = fetch_scene(render_t.scene_at(t), ni, npts)
            gold = anim_golds[tag, t] = cpu_render_scene(frame, c)
            n_bad = int((got != gold).any(-1).sum())
            over = {k: stats[k] for k in ("seg_overflow", "hit_overflow",
                                          "cand_overflow")}
            print(f"render {tag} t={t:.4f}: {n_bad} pixels differ from the "
                  f"numpy oracle on the frame's own arrays; segments "
                  f"{stats['n_segments']} hits "
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

    from piet_tpu_torch.renderer.resize import ResizableRenderer
    for impl, (w, h) in itertools.product(("entries", "dense"),
                                          ((1664, 1664), (3840, 2160))):
        r = Renderer.for_scene(scene, w, h, tile_height=32, tile_width=128,
                               device=dev, fine_impl=impl)
        graph_check(f"static tiger {w}x{h} {impl}", rgba(r.render_u32(scene)),
                    rgba(r.render_device(r.prepare(scene))[0]), golds[w, h])
    for (name, impl), (r, sc) in baseline.items():
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

    # ---- 7. the command line on the card --------------------------------
    # Oracle images by scene_key, shared by phases 7 and 10: phase 4's
    # tiger, phase 4d's BASELINE scenes and phase 4g's headline; phase 7
    # adds its own.
    oracle_images = {scene_key(scene, cfg): golds[1664, 1664],
                     head_key: head_gold}
    oracle_images.update({scene_key(sc, r.config): baseline_gold[name]
                          for (name, _), (r, sc) in baseline.items()})
    phase_cli(card, dev, scene, cfg, golds[1664, 1664], aff_render, aff_ni,
              aff_np, anim_render, anim_ni, anim_np, anim_golds,
              oracle_images)

    # ---- 8. the tools ----------------------------------------------------
    phase_tools(card, dev)

    # ---- 9. the rest of the tools ----------------------------------------
    phase_diag_tools(card, dev)

    # ---- 10. the benchmark -----------------------------------------------
    phase_bench(card, oracle_images)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


#: Kernels of the entries route and the dense route of a frame.
ENTRIES_KERNELS = ("candfuse", "hitfuse", "sort", "fine", "keyed", "gatherm",
                   "cand_rows", "entries_tail")
DENSE_KERNELS = ("candfuse", "hitfuse", "sort", "dense_tail", "fine_dense",
                 "keyed", "gatherm", "cand_rows")
#: Where phase 7's command lines write their PNGs (gitignored).
CLI_OUT = "build/chip_smoke_cli"


def run_cli(argv, expect=(), absent=()):
    """``python -m piet_tpu_torch <argv>`` in this process, the launch
    counters set to 0 just before and read just after: its stdout lines.
    Prints one line; fails unless it exits 0, every kernel of ``expect``
    ran and none of ``absent``."""
    import contextlib
    import io

    import torch
    from piet_tpu_torch import cli, tracing
    buf = io.StringIO()
    tracing.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(tracing.LAUNCHES)
    cmd = "python -m piet_tpu_torch " + " ".join(argv)
    print(f"cli {cmd}: exit {rc}; launches {launches}", flush=True)
    assert rc == 0, cmd
    assert all(launches[k] > 0 for k in expect), (cmd, launches)
    assert all(launches[k] == 0 for k in absent), (cmd, launches)
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
              golds) -> None:
    """Phase 7: every command of the command line, in process, each image
    held against the numpy oracle bitwise (oracle images of phases 4 and
    5 shared by key: ``golds``, scene_key -> image, which this phase
    adds its own to); the profiler's and the roofline's checks."""
    import argparse
    import shutil
    from pathlib import Path

    from piet_tpu_torch import cli, native
    from piet_tpu_torch.api import RenderContext
    from piet_tpu_torch.geometry import Affine
    from piet_tpu_torch.geometry.shapes import CirclePath, Line, Rect
    from piet_tpu_torch.geometry.shapes import RoundedRect
    from piet_tpu_torch.host import (RenderConfig, cpu_render_scene,
                                     fit_capacities)
    from piet_tpu_torch.profiling import PROFILED
    from piet_tpu_torch.renderer.renderer import Renderer, fetch_scene
    from piet_tpu_torch.roofline import frame_roofline
    from piet_tpu_torch.scene.fixtures import get_scene, make_animated_frame
    from piet_tpu_torch.scene.scene import RadialGradient
    from piet_tpu_torch.scene.svg import TIGER_PATH
    from piet_tpu_torch.scene.svg_full import load_svg_file
    from piet_tpu_torch.utils.png import read_png

    out = Path(CLI_OUT)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
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
                ("fine_dense",) if impl == "entries"
                else ("fine", "entries_tail"))
        tiger_png[impl] = read_png(str(png))
        check(f"render tiger 1664x1664 {impl}", tiger_png[impl], tiger_gold)
    svg = Path(TIGER_PATH)
    png = out / "tiger_svg.png"
    run_cli(["render", "--svg", str(svg), "--width", "1024", "--height",
             "1024", "--out", str(png)], DENSE_KERNELS,
            ("fine", "entries_tail"))
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
                        ("fine", "entries_tail"))
        print(f"cli animate {tag}: {lines[-2]} {lines[-1]}", flush=True)
        for i, fr in enumerate(frames):
            check(f"animate {tag} frame {i} (t={ts[i]:.4f})",
                  read_png(str(d / f"frame_{i:04d}.png")),
                  oracle(fr, size, size))

    for impl in ("entries", "dense"):
        lines = run_cli(["goldens", "--tolerance", "0", "--fine-impl", impl,
                         "--outdir", str(out / f"goldens_{impl}")],
                        ENTRIES_KERNELS if impl == "entries"
                        else DENSE_KERNELS)
        print(f"cli goldens {impl}: " + "; ".join(lines), flush=True)

    assert native.available(), "the native cc/ library did not build"
    roofs = []
    for argv in (["bench", "--scene", "tiger", "--width", "1664", "--height",
                  "1664"],
                 ["bench", "--scene", "animated", "--reencode"]):
        lines = run_cli(argv, DENSE_KERNELS, ("fine", "entries_tail"))
        print("\n".join(f"cli bench: {ln}" for ln in lines[-3:]), flush=True)
        roofs.append(json.loads(lines[-3])["roofline"])

    profiles = {}
    for name, w, sc in (("tiger", 1664, scene),
                        ("beziers_10k", 1024, get_scene("beziers_10k"))):
        pcfg = cli._config_for(ns(w, w), sc)
        for impl in ("entries", "dense"):
            lines = run_cli(["profile", "--scene", name, "--width", str(w),
                             "--height", str(w), "--fine-impl", impl])
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

    lines = run_cli(["dump", "--scene", "tiger"])
    print(f"cli dump tiger: {len(lines)} lines, last {lines[-1]!r}",
          flush=True)
    lines = run_cli(["info"])
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
    wire = native.init_scene_from_svg(Path(TIGER_PATH).read_text(), 8.0)
    golden, overflow = native.render_golden(
        wire, cfg.width, cfg.height, tile_w=cfg.tile_width,
        tile_h=cfg.tile_height, cmd_capacity=cfg.cmd_capacity)
    n_bad = int((golden != tiger_png["entries"]).any(-1).sum())
    print(f"native golden tiger 1664x1664 ({len(wire)} wire bytes, "
          f"overflow {overflow}): {n_bad} pixels differ from the card's "
          f"frame", flush=True)
    assert overflow == 0 and n_bad == 0


#: The tools' kernels (csrc/probes.cu; probe_div is probe_numerics'
#: division op, counted apart).
TOOL_KERNELS = ("probe_div", "probe_numerics", "probe_halfmix",
                "probe_delivery")


def phase_tools(card, dev) -> None:
    """Phase 8: the five tools of piet_tpu_torch/tools/ as a user runs
    them (``main``), at the JAX tools' sizes, the launch counters reset
    before and read after (each of the four counters must have moved);
    then each probe kernel bitwise against its plain version on the
    tools' own inputs (probe_delivery on every tile at 1 and 676 tiles,
    with its pass counts), probe_div and probe_numerics 0 words off the
    numpy mirror (else the run fails), and kernel D against its plain
    version on the bench's streams."""
    import contextlib
    import io

    import numpy as np
    import torch
    from piet_tpu_torch import tracing
    from piet_tpu_torch.ops import fine, probes
    from piet_tpu_torch.tools import (arg_delivery_bench, div_probe,
                                      fine_entry_bench, half_experiment,
                                      mosaic_numerics_probe)

    print(card, flush=True)
    tools = ((div_probe, ()), (mosaic_numerics_probe, ([],)),
             (half_experiment, ()), (arg_delivery_bench, ([],)),
             (fine_entry_bench, ([],)))
    tracing.reset_launches()
    for tool, args in tools:
        name = tool.__name__.rsplit(".", 1)[-1]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(*args)
        torch.cuda.synchronize()
        assert rc == 0, name
        for line in buf.getvalue().splitlines():
            print(f"tool {name}: {line}", flush=True)
    launches = {k: tracing.LAUNCHES[k] for k in TOOL_KERNELS}
    print(f"launches phase 8 (tools): {launches}, fine "
          f"{tracing.LAUNCHES['fine']}", flush=True)
    assert all(n > 0 for n in launches.values()), launches
    assert tracing.LAUNCHES["fine"] > 0

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
    # whose state ends finite.
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

    for name, res in checks.items():
        n_bad = sum(r[0] for r in res)
        err = max(r[1] for r in res)
        print(f"kernel {name}: {n_bad} mismatching words vs plain "
              f"(tolerance 0) over {len(res)} calls, max abs err {err}",
              flush=True)
        assert n_bad == 0, f"kernel {name} disagrees with its plain version"


#: The access-pattern probes' kernels (csrc/mosaic_probe.cu).
MOSAIC_KERNELS = ("probe_mosaic", "probe_dma16")
#: The tools of phase 9 and the arguments their ``main`` gets.
DIAG_TOOLS = (("mosaic_probe", []), ("grad_exact_probe", []),
              ("grad_tile_probe", []), ("group_stats", ["tiger_8x"]),
              ("mesh_balance", []), ("eng_bisect_probe", []),
              ("eng_array_probe", []), ("engine_probe", []),
              ("dispatch_probe", []), ("precompile_cache", []))


def phase_diag_tools(card, dev) -> None:
    """Phase 9: the rest of the tools as a user runs them (``main``), the
    launch counters reset before and read after (mosaic_probe's default
    run: one probe_mosaic launch for its 22 probes at both fills, and
    probe_dma16 once a fill); then the batch of all 22 probes at both
    fills and all 23 probes one launch each, kernel against plain (0
    words off, on the card and against the plain version on the CPU),
    engine_probe's leaves and every kernel of its bisect at 0 words off,
    and the gradient demo at 0 pixels off the oracle."""
    import contextlib
    import importlib
    import io

    import torch
    from piet_tpu_torch import tracing
    from piet_tpu_torch.ops import probes
    from piet_tpu_torch.tools import mosaic_probe

    print(card, flush=True)
    tracing.reset_launches()
    out = {}
    for name, args in DIAG_TOOLS:
        tool = importlib.import_module(f"piet_tpu_torch.tools.{name}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(list(args))
        torch.cuda.synchronize()
        out[name] = buf.getvalue().splitlines()
        for line in out[name]:
            print(f"tool {name}: {line}", flush=True)
        assert rc == 0, name
    launches = {k: tracing.LAUNCHES[k] for k in MOSAIC_KERNELS}
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
    for name, res in checks.items():
        n_bad = sum(r[0] for r in res)
        err = max(r[1] for r in res)
        print(f"kernel {name}: {n_bad} mismatching words vs plain "
              f"(tolerance 0) over {len(res)} comparisons, max abs err "
              f"{err}", flush=True)
        assert n_bad == 0, f"kernel {name} disagrees with its plain version"


#: Phase 10's runs of the benchmark: its arguments, the route's frame
#: kernels (each must launch) and the kernels it must not launch (static
#: scenes stage their segments: no expand).
BENCH_RUNS = (([], DENSE_KERNELS, ("fine", "expand", "fine_paired",
                                   "expand_pairing", "entries_tail")),
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


def phase_bench(card, golds) -> None:
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
    animated_clips); then tools/time_config.py's main on tiger_4k."""
    import contextlib
    import io

    import numpy as np
    import torch
    from piet_tpu_torch import bench, tracing
    from piet_tpu_torch.host import (RenderConfig, cpu_render_scene,
                                     fit_capacities)
    from piet_tpu_torch.ops import coarse, sort
    from piet_tpu_torch.tools import time_config

    keys = jax_bench_keys() | {"roofline"}
    names = [n for n, _, _, _ in bench.CONFIGS]

    def run(fn, argv, record=None):
        buf = io.StringIO()
        tracing.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = (fn(argv) if record is None else fn(argv, record=record))
        torch.cuda.synchronize()
        lines = buf.getvalue().splitlines()
        print("\n".join(lines), flush=True)
        return rc, lines, dict(tracing.LAUNCHES)

    claim_checked = False
    for argv, must, absent in BENCH_RUNS:
        cmd = " ".join(["python -m piet_tpu_torch.bench"] + argv)
        rec = {}
        rc, lines, launches = run(bench.main, argv, rec)
        print(f"bench {cmd}: exit {rc}; launches {launches}", flush=True)
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

    rc, lines, launches = run(time_config.main, ["tiger_4k"])
    out = json.loads(lines[-1])
    print(f"tool time_config tiger_4k: exit {rc}; launches {launches}",
          flush=True)
    assert rc == 0 and lines[0] == card
    assert set(out) == {"config", "ms_per_frame", "viewport", "env"}, out
    assert out["ms_per_frame"] > 0 and out["viewport"] == "3840x2160"
    assert all(launches[k] > 0 for k in DENSE_KERNELS), launches


def _flat_stage(stage):
    """(CandInputs, ca, cand_tile, cand_ty) -> one flat tuple."""
    return tuple(stage[0]) + tuple(stage[1:4])


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _flat(sorted_out):
    keys, vals = sorted_out
    return tuple(keys) + (vals,)


if __name__ == "__main__":
    sys.exit(main())
