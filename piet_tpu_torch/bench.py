"""Benchmark of the port: every BASELINE.md config, ms/frame on one card.

The counterpart of the JAX package's root ``bench.py``, with its configs,
its capacity fit and the keys of its JSON lines:

    python -m piet_tpu_torch.bench                      # the default route
    python -m piet_tpu_torch.bench --fine-impl entries  # kernel D's route
    python -m piet_tpu_torch.bench --cpu                # the off-card config

Prints the card's name and power limit (nvidia-smi's line), one JSON line
per secondary config, then the HEADLINE line last:
  {"metric": "tiger_4k_ms_per_frame", "value": <ms>, "unit": "ms/frame",
   "vs_baseline": null, "backend": "cuda", ..., "configs": {<name>: <ms>},
   "roofline": {...}}

``vs_baseline`` is null: the JAX script divides a target that was set for
another device, and no target is carried over.  A config that raises
prints ``{"config": <name>, "error": ...}`` and the headline still runs,
but the run then exits 1.  Without a card and without ``--cpu`` the run
raises (``renderer.check_device``).

Methodology: capacities are fitted as the JAX script fits them (exact
counts, no buckets, 32x128 tiles, ``cmd_capacity`` 1024 refitted); the
scene is staged once into the frame step's static inputs, and the timed
region is the frame users get: one replay of the frame's CUDA graph
(``renderer/graph.py::CapturedStep``: coarse pass, fine interpreter and
present composite, and the output's copy).  ``FRAMES`` replays are
enqueued back to back and closed by a one-element device-to-host copy
(the stream runs in order, so every replay has ended); an idle-queue
copy is timed right after each sample and subtracted.  The value is the
median of ``SAMPLES`` such samples, by the host clock.  Under ``--cpu``
the same frames run eagerly on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

from . import tracing
from .cli import FINE_IMPL_NAMES, card_line
from .config import RenderConfig
from .renderer.capacity import fit_capacities
from .renderer.renderer import Renderer, check_device, prepare_scene
from .scene import fixtures
from .scene.svg import make_tiger

FRAMES = 20
SAMPLES = 3

#: The five BASELINE.md configs and the headline, as the JAX script runs
#: them on its device: (name, scene maker, width, height).
CONFIGS = [
    ("tiger_8x", lambda: make_tiger(scale=8.0), 1664, 1664),
    ("circles_rects_1k",
     lambda: fixtures.get_scene("circles_rects"), 1024, 1024),
    ("beziers_10k",
     lambda: fixtures.get_scene("beziers_10k"), 1024, 1024),
    ("glyph_page_5k",
     lambda: fixtures.get_scene("glyph_page"), 1024, 1024),
    ("animated_clips",
     lambda: fixtures.get_scene("animated"), 1024, 1024),
]
HEADLINE = ("tiger_4k", lambda: make_tiger(scale=19.2), 3840, 2160)

#: The JAX script's configuration off its device, run here under --cpu.
CPU_CONFIGS: list = []
CPU_HEADLINE = ("tiger_512_cpu_fallback",
                lambda: make_tiger(scale=2.56), 512, 512)

#: The headline's metric where it is not ``<name>_ms_per_frame``.
METRIC_NAMES = {
    "tiger_512_cpu_fallback": "tiger_512_ms_per_frame_cpu_fallback"}


def _fetch(flat) -> None:
    """One element of a frame's output to the host: waits for the
    frame (and every frame enqueued before it)."""
    flat[:1].cpu()


def time_renderer(renderer: Renderer, staged) -> float:
    """Median ms/frame over SAMPLES samples of FRAMES back-to-back
    replays of ``renderer``'s frame step on its static inputs
    ``staged``, each sample closed by a one-element fetch, an idle-queue
    fetch's time subtracted."""
    step = renderer._render
    _fetch(step.flat(staged))  # warm (captured already by the caller)
    samples = []
    for _ in range(SAMPLES):
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            flat = step.flat(staged)
        _fetch(flat)
        t1 = time.perf_counter()
        _fetch(flat)  # idle-queue fetch: the sync's own cost
        t2 = time.perf_counter()
        samples.append(((t1 - t0) - (t2 - t1)) * 1e3 / FRAMES)
    return float(np.median(samples))


def bench_config(name, scene, width, height, *, device, fine_impl="auto",
                 record=None):
    """Fit, capture and time one config: ``(ms, cfg, stats)``.

    ``record``, a dict, receives the frame (``"image"``, (H, W, 4)
    uint8, from the capturing call), ``"config"``, ``"scene"`` and the
    kernels' ``"launches"`` during the call."""
    before = dict(tracing.LAUNCHES)
    cfg = fit_capacities(scene, RenderConfig(
        width=width, height=height, tile_height=32, tile_width=128,
        cmd_capacity=1024))
    renderer = Renderer(cfg, device, fine_impl=fine_impl)
    # Staged once, with the host segment stage, as a caller that replays
    # one scene stages it; the first frame captures and checks capacities.
    staged = renderer._render.stage(prepare_scene(scene, cfg, device))
    img = renderer._finish(renderer._render, staged)
    ms = time_renderer(renderer, staged)
    stats = renderer.last_stats or {}
    if record is not None:
        record.update(image=renderer._rgba8(img), config=cfg, scene=scene,
                      launches={k: n - before[k]
                                for k, n in tracing.LAUNCHES.items()})
    return ms, cfg, stats


def roofline_split(scene, cfg, stats, total_ms, *, device, fine_impl):
    """Measured coarse/fine split and the H100 floors for the headline.

    Times the route that was benched, ``fine_impl``: the coarse pass
    alone and that route's fine kernel alone -- ``fine_dense`` on the
    dense route ("auto"), kernel D on the entries route -- each as a
    graphed step replayed on the pass's outputs
    (``profiling.py::profile_render``), and feeds them with the frame's
    record counts to ``roofline.py::frame_roofline``."""
    from .profiling import profile_render
    from .roofline import frame_roofline

    prof = profile_render(scene, cfg, fine_impl=fine_impl, reps=FRAMES,
                          device=device)
    return frame_roofline(stats, cfg, prof["coarse_total"], prof["fine"],
                          total_ms)


def main(argv=None, record=None) -> int:
    """Run every config, then the headline; 1 if any of them failed.
    ``record``, a dict, receives each config's :func:`bench_config`
    record under its name."""
    ap = argparse.ArgumentParser(prog="python -m piet_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the off-card configuration on the CPU")
    ap.add_argument("--fine-impl", default="auto",
                    choices=list(FINE_IMPL_NAMES),
                    help="frame route: dense (auto, xla) or entries "
                         "(pallas)")
    args = ap.parse_args(argv)
    dev = check_device("cpu" if args.cpu else "cuda")
    impl = FINE_IMPL_NAMES[args.fine_impl]
    on_card = dev.type == "cuda"
    configs, headline = ((CONFIGS, HEADLINE) if on_card
                         else (CPU_CONFIGS, CPU_HEADLINE))
    print(card_line(dev), flush=True)

    def run(name, scene, w, h):
        rec = None if record is None else record.setdefault(name, {})
        return bench_config(name, scene, w, h, device=dev, fine_impl=impl,
                            record=rec)

    failed = False
    results = {}
    for name, make, w, h in configs:
        try:
            ms, _, _ = run(name, make(), w, h)
            results[name] = round(ms, 3)
            print(json.dumps({"config": name, "ms_per_frame": round(ms, 3),
                              "viewport": f"{w}x{h}"}), flush=True)
        except Exception as e:  # keep the headline alive no matter what
            traceback.print_exc()
            failed = True
            results[name] = None
            print(json.dumps({"config": name,
                              "error": f"{type(e).__name__}: {e}"[:200]}),
                  flush=True)

    name, make, w, h = headline
    scene = make()
    ms, cfg, stats = run(name, scene, w, h)
    n_segments = int(stats.get("n_segments", 0))
    roofline = None
    if on_card:
        try:
            roofline = roofline_split(scene, cfg, stats, ms, device=dev,
                                      fine_impl=impl)
        except Exception as e:
            traceback.print_exc()
            failed = True
            roofline = {"error": f"{type(e).__name__}: {e}"[:200]}
    timing = (f"graphed: {FRAMES} CUDA graph replays back to back, closed "
              f"by a one-element device-to-host copy, an idle-queue copy "
              f"subtracted; host clock; median of {SAMPLES}" if on_card else
              f"eager on the CPU: {FRAMES} frames back to back; host clock; "
              f"median of {SAMPLES}")
    out = {
        "metric": METRIC_NAMES.get(name, f"{name}_ms_per_frame"),
        "value": round(ms, 3),
        "unit": "ms/frame",
        "vs_baseline": None,
        "backend": dev.type,
        "viewport": f"{w}x{h}",
        "frames": FRAMES,
        "samples": SAMPLES,
        "timing": timing,
        "fill_mpix_per_s": round(w * h / (ms * 1e-3) / 1e6, 1),
        "segments_binned_per_s": round(n_segments / (ms * 1e-3), 0),
        "n_segments": n_segments,
        "max_tile_cmds": int(stats.get("max_tile_cmds", 0)),
        "configs": results,
    }
    if roofline is not None:
        out["roofline"] = roofline
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
