"""Per-stage times of a frame on the card (user-invocable, tested).

Port of ``piet_tpu/profiling.py``: the time of each stage of the coarse
pass, then ``coarse_total``, ``fine`` and ``end_to_end``:

    python -m piet_tpu_torch profile --scene tiger --width 1664 --height 1664

How a stage is timed.  The JAX profiler jits cumulative prefixes of the
pass and lets XLA drop every later stage.  PyTorch drops nothing, so a
prefix here stops on its own: ``coarse_rasterize(..., upto=<stage>)``
returns right after that stage.  On a CUDA device each prefix is
captured as its own CUDA graph (renderer/graph.py::CapturedStep) and
timed by ``reps`` back-to-back replays between CUDA events, queued behind
a GPU spin so the events see the device's time, not the host's: a
replay has no host launches, so the prefix times are device times, as
the JAX prefixes are.  ``dispatch_floor`` is the replay of a one-node
graph; a stage's time is ``prefix(k) - prefix(k-1)``, the prefixes'
medians over interleaved rounds projected onto a non-decreasing sequence
first (pool-adjacent-violators), so no stage reads negative.
``coarse_total`` is the whole pass's graph, ``fine`` the fine kernel's
call replayed on that pass's outputs, ``end_to_end`` the frame step of
``make_render_fn`` (its output copy included).  On the CPU (the tests)
the same steps run eagerly, timed by the host clock.

Stage names are the JAX package's (:data:`STAGE_ORDER`).  A JAX stage
that the port does inside an earlier stage's kernel reads 0.0 and is
named in :data:`FOLDED`; so do stages that the pass does not run (the
segment stages of a host-staged scene, "pairing" unless the entries
route pairs -- ``PIET_PAIR``, read as the renderer reads it -- and
"runs" on the dense route or a paired pass).  torch.profiler is not
used: it drops kernel records now and then.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from .config import RenderConfig
from .ops.coarse import coarse_rasterize
from .ops.fine import fine_rasterize_entries
from .ops.fine_xla import fine_rasterize_xla
from .renderer.graph import CapturedStep
from .renderer.renderer import (_solid_to_present_u32, check_device,
                                make_render_fn, prepare_scene,
                                resolve_fine_impl, step_pair_mode)

#: The JAX profiler's stage order (``piet_tpu/profiling.py``).
STAGE_ORDER = (
    "cand_expand",    # item bbox -> candidate record expansion
    "seg_expand",     # per-item attribute row -> per-segment expansion
    "seg_points",     # segment endpoint gathers
    "seg_derive",     # line equations + bboxes over segments
    "seg_rects",      # per-segment tile emission rects
    "hit_expand",     # (segment, tile) hit-record expansion
    "hit_gather",     # packed per-segment attribute row gather
    "hit_tests",      # exact per-record f32 sign tests + slot args
    "cand_emit",      # per-candidate emitted-command counts
    "del_scatter",    # keyed delta sums (crossings ride the hit records
                      # -- the round-5 fold; no separate expansion)
    "deltas",         # backdrop prefix sums
    "rows",           # pre-sort 16-word row assembly
    "sort",           # the global stable sort
    "sorted_gather",  # sorted-order row gather
    "pairing",        # same-class entry pairing + compaction
    "runs",           # same-class run-length annotation (run dispatch)
    "tile_reduce",    # fused per-tile range/bail reductions
)

#: JAX stages done inside another stage's kernel: name -> the stage whose
#: time holds it (kernel B does the hit gather and tests; the one-call
#: keyed sums do the delta scatter).
FOLDED = {"hit_gather": "hit_expand", "hit_tests": "hit_expand",
          "del_scatter": "cand_emit"}

#: The stages a profile reports.
PROFILED = STAGE_ORDER

#: Interleaved rounds; each step's time is its median over them.
ROUNDS = 5
#: GPU spin ahead of each timed batch (~10 ms at H100 clocks): the host
#: queues the whole batch while the device spins.
SPIN_CYCLES = 20_000_000


def _isotonic(y: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators: the L2-nearest non-decreasing sequence."""
    vals = list(map(float, y))
    wts = [1.0] * len(vals)
    out_v: list[float] = []
    out_w: list[float] = []
    for v, w in zip(vals, wts):
        out_v.append(v)
        out_w.append(w)
        while len(out_v) > 1 and out_v[-2] > out_v[-1]:
            v2, w2 = out_v.pop(), out_w.pop()
            v1, w1 = out_v.pop(), out_w.pop()
            out_v.append((v1 * w1 + v2 * w2) / (w1 + w2))
            out_w.append(w1 + w2)
    res = []
    for v, w in zip(out_v, out_w):
        res.extend([v] * int(w))
    return np.asarray(res)


def _first(t: torch.Tensor) -> torch.Tensor:
    """A one-element view of ``t``: a step's output that costs no op."""
    return t.reshape(-1)[:1]


class _Timed:
    """``fn(x)`` as a step: on a CUDA device a captured CUDA graph (or
    ``fn`` itself where it is a step already: ``capture=False``), timed
    over ``reps`` calls between CUDA events behind a GPU spin; on the CPU
    an eager call timed by the host clock."""

    def __init__(self, fn: Callable, x, device: torch.device,
                 capture: bool = True):
        self.device = device
        if device.type == "cuda" and capture:
            step = CapturedStep(fn, device)
            x = step.stage(x)
            self.call = lambda: step(x)
        else:
            self.call = lambda: fn(x)
        self.call()  # capture (CUDA), warm

    def ms(self, reps: int) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                self.call()
            return (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            self.call()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / reps


def profile_render(scene, config: RenderConfig, *, fine_impl: str = "auto",
                   reps: int = 40, device="cuda") -> Dict[str, float]:
    """Stage -> ms for one frame of ``scene`` under ``config`` on
    ``device`` ("cuda" unless the caller asks for the CPU).

    Returns an ordered dict: ``dispatch_floor``, every stage of
    :data:`PROFILED` (its own time; 0.0 for a stage of :data:`FOLDED` or
    one the pass does not run), then ``coarse_total``, ``fine`` and
    ``end_to_end``."""
    dev = check_device(device)
    impl = resolve_fine_impl(fine_impl)
    pair = step_pair_mode(impl)
    staged = prepare_scene(scene, config, dev)
    kw = dict(tiles_x=config.tiles_x, tiles_y=config.tiles_y,
              tile_w=config.tile_width, tile_h=config.tile_height,
              max_segments=config.max_segments, max_hits=config.max_hits,
              max_candidates=config.max_candidates,
              output="entries" if impl == "entries" else "dense",
              cmd_capacity=config.cmd_capacity, pair=pair)
    coarse = coarse_rasterize(staged, with_probes=True, **kw)
    ran = list(coarse.diag["probes"])

    def prefix(name):
        return lambda d: _first(coarse_rasterize(d, upto=name, **kw)[name][0])

    fk = dict(tile_h=config.tile_height, tile_w=config.tile_width)
    if impl == "entries":
        fine_in = (coarse.first, coarse.n_entries,
                   _solid_to_present_u32(coarse.solid), coarse.stream)

        def fine_fn(x):
            return _first(fine_rasterize_entries(
                *x, 0, tiles_x=config.tiles_x, paired=pair != "off", **fk))
    else:
        fine_in = (coarse.counts.reshape(config.tiles_y, config.tiles_x),
                   coarse.tags, coarse.args)

        def fine_fn(x):
            return _first(fine_rasterize_xla(
                *x, 0, cmd_capacity=config.cmd_capacity, **fk))

    render = make_render_fn(config, dev, impl)
    steps: List[_Timed] = [_Timed(lambda d: d.tags[:1].clone(), staged, dev)]
    steps += [_Timed(prefix(n), staged, dev) for n in ran]
    steps += [_Timed(lambda d: _first(coarse_rasterize(d, **kw).solid),
                     staged, dev),
              _Timed(fine_fn, fine_in, dev),
              _Timed(render.flat, render.stage(staged), dev, capture=False)]
    samples = np.array([[s.ms(reps) for s in steps] for _ in range(ROUNDS)])
    med = np.median(samples, axis=0)
    mono = _isotonic(med[:len(ran) + 1])

    stage_ms = dict(zip(ran, np.diff(mono)))
    results: Dict[str, float] = {"dispatch_floor": round(float(mono[0]), 4)}
    for name in PROFILED:
        results[name] = round(float(stage_ms.get(name, 0.0)), 4)
    for name, ms in zip(("coarse_total", "fine", "end_to_end"),
                        med[len(ran) + 1:]):
        results[name] = round(float(ms), 4)
    return results


def format_profile(results: Dict[str, float]) -> str:
    lines = [f"{'stage':<16} {'ms':>8}"]
    for k, v in results.items():
        if k in FOLDED:
            lines.append(f"{k:<16} {'(in ' + FOLDED[k] + ')':>8}")
        else:
            lines.append(f"{k:<16} {v:>8.4f}")
    return "\n".join(lines)
