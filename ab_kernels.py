#!/usr/bin/env python3
"""Time the port's fine and hit-record kernels of two source trees on one
CUDA card, in turns, and print each tree's compiler statistics.

    python3 ab_kernels.py ROOT_A ROOT_B
    python3 ab_kernels.py --ptxas ROOT

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

and counts the device ops of one static frame on each route
(torch.profiler).  Then ``nvcc -Xptxas -v`` on each tree's fine_dense.cu,
hitfuse.cu and fine.cu, with the build's flags: registers, spill bytes
and shared memory per kernel.  Every line names the card and its power
limit.  Needs one card; exits non-zero without one.
"""

import argparse
import json
import os
import re
import subprocess
import sys

SPIN_CYCLES = 50_000_000


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from piet_tpu_torch import kernels
    from piet_tpu_torch.host import make_tiger
    from piet_tpu_torch.ops import coarse, fine, fine_xla, hitfuse
    from piet_tpu_torch.renderer.renderer import (Renderer,
                                                  _solid_to_present_u32)
    assert kernels.__file__.startswith(os.path.abspath(root)), kernels.__file__
    kernels.library()
    dev = torch.device("cuda")

    def time_ms(fn, reps=20):
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

    def device_ops(render_one):
        render_one()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render_one()
            torch.cuda.synchronize()
        return sum(e.device_type == DeviceType.CUDA for e in prof.events())

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
        for impl in ("entries", "dense"):
            rr = Renderer(cfg, dev, fine_impl=impl)
            out[f"device ops, {impl} frame"] = device_ops(
                lambda: rr.render_device(d))
    print("AB " + json.dumps(out), flush=True)


def ptxas(root: str) -> str:
    sys.path.insert(0, root)
    from piet_tpu_torch import kernels
    lines = []
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("fine_dense", "hitfuse", "fine"):
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
    a = ap.parse_args()
    if a.worker:
        worker(a.worker)
        return 0
    if a.ptxas:
        print(ptxas(a.ptxas), flush=True)
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
