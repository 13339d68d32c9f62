"""Where the host's cost per graph replay goes, one axis at a time.

Port of ``tools/dispatch_probe.py``.  The JAX tool times null jits that
vary one axis at a time (inputs, outputs, output rank, the render step,
frames per dispatch).  The port's counterpart of a jitted step is a
captured CUDA graph (``renderer/graph.py::CapturedStep``), so each probe
here is a step, timed as the throughput of back-to-back replays with one
synchronize at the end (host clock; median of 3 batches after a warm-up
that captures):

  null_12leaf   the staged DeviceScene (12 tensors) -> tags[:1]
  null_1small   one (128,) int32 input -> its first element
  null_1big     one ``pack_scene`` buffer -> its first element
  null_0in      no input -> a constant
  out_1, out_12, out_0d, out_1d1, out_12x0d
                one small input -> 1 or 12 results, as (128,), 0-d or
                (1,) tensors (a step returns one tensor: 12 results are
                stacked into it)
  render        the frame step (``make_render_fn``)
  render_img    a step of the frame's image alone (no stats)
  chain4_per_frame, chain16_per_frame
                4 and 16 frames a replay (``make_render_sequence_fn`` over
                ``stack_scenes``), per frame

Prints one JSON line per probe, then all of them; ``--skip-render``
keeps to the null steps.

Usage: python -m piet_tpu_torch.tools.dispatch_probe [--reps 40]
       [--width 3840] [--height 2160] [--scale 19.2] [--skip-render]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..config import RenderConfig
from ..renderer.capacity import fit_capacities
from ..renderer.graph import CapturedStep
from ..renderer.renderer import (make_render_fn, make_render_sequence_fn,
                                 pack_scene, prepare_scene, render_slab,
                                 stack_scenes)
from ..scene.svg import make_tiger
from . import card


def replay_ms(fn, reps: int, samples: int = 3) -> float:
    """ms per call of ``fn`` as throughput: ``reps`` calls back to back,
    one synchronize, host clock; the median of ``samples`` batches after
    one warm-up call."""
    fn()
    cuda = torch.cuda.is_available()
    times = []
    for _ in range(samples):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def _step(fn, x, device):
    """``fn`` over ``x`` as a CapturedStep on ``device``, its inputs
    staged once: a call replays and copies no input."""
    step = CapturedStep(fn, device)
    staged = step.stage(x)
    return lambda: step(staged)


def null_probes(scene, cfg, device) -> dict:
    """name -> a call of each null step."""
    dev = prepare_scene(scene, cfg, "cpu", seg_pre=False)
    packed = torch.from_numpy(pack_scene(scene, cfg).view("int32"))
    small = torch.arange(128, dtype=torch.int32)
    one = (lambda x: x.reshape(-1)[:1].clone())
    return {
        "null_12leaf": _step(lambda d: d.tags[:1].clone(), dev, device),
        "null_1small": _step(one, small, device),
        "null_1big": _step(one, packed, device),
        "null_0in": _step(lambda _: torch.full(
            (1,), 7, dtype=torch.int32, device=device), (), device),
        "out_1": _step(lambda x: x + 1, small, device),
        "out_12": _step(lambda x: torch.stack([x + i for i in range(12)]),
                        small, device),
        "out_0d": _step(lambda x: (x + 1)[0], small, device),
        "out_1d1": _step(lambda x: (x + 1)[:1], small, device),
        "out_12x0d": _step(lambda x: torch.stack(
            [(x + i)[0] for i in range(12)]), small, device),
    }


def render_probes(scene, cfg, device, fine_impl="auto",
                  chains=(4, 16)) -> dict:
    """name -> (a call, frames a call): the frame step, its image alone,
    and ``chains`` frames a replay."""
    dev = prepare_scene(scene, cfg, "cpu")
    render = make_render_fn(cfg, device, fine_impl)
    staged = render.stage(dev)
    out = {"render": (lambda: render.flat(staged), 1)}

    def img_only(d):
        img, _ = render_slab(d, cfg, tiles_y=cfg.tiles_y, row0=0,
                             fine_impl=fine_impl)
        return img[:cfg.height, :cfg.width]
    out["render_img"] = (_step(img_only, dev, device), 1)
    for k in chains:
        seq = make_render_sequence_fn(cfg, device, fine_impl)
        st = seq.stage(stack_scenes([scene] * k, cfg, "cpu"))
        out[f"chain{k}_per_frame"] = ((lambda s=seq, x=st: s.flat(x)), k)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--scale", type=float, default=19.2)
    ap.add_argument("--skip-render", action="store_true",
                    help="only the null steps (fast)")
    args = ap.parse_args(argv)
    device = card()
    scene = make_tiger(scale=args.scale)
    cfg = fit_capacities(scene, RenderConfig(width=args.width,
                                             height=args.height))
    results = {}

    def run(name, fn, frames=1, reps=args.reps):
        ms = replay_ms(fn, reps) / frames
        results[name] = round(ms, 4)
        print(json.dumps({"probe": name, "ms_per_step": results[name]}),
              flush=True)

    for name, fn in null_probes(scene, cfg, device).items():
        run(name, fn)
    if not args.skip_render:
        for name, (fn, k) in render_probes(scene, cfg, device).items():
            run(name, fn, k, max(args.reps // k, 3))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
