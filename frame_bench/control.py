"""The control: the reference in the program's place, one precision down.

    python3 -m frame_bench.control --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does (scene, poses,
the port's fitted capacities; the program renders no frame), renders the
poses that a run compares with the frozen oracle with its per-pixel state
rounded to bfloat16 after every command (``reference/band.py``), and
compares those images with the f32 oracle's by the run's own comparison
(``check.py``).  It prints one JSON line per seed: the numbers compared,
each beside its limit, and whether the control came out correct (it must
not).  Needs the cell's card where the traffic computes its poses there.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def control(c: dict, seed: int, device, workers: int = 0) -> dict:
    from . import check
    from .reference import band
    from .workload import make_workload

    wl = make_workload(c["config"], c["traffic"], seed, device)
    poses = check.compare_poses(wl.n_poses, seed) or [wl.pose(0)]
    scenes = {p: wl.reference_scene(p) for p in poses}
    cfg = wl.cfg
    wl.close()
    rcfg = check.reference_config(cfg)
    images = {p: band.render(s, rcfg, workers=workers, precision="bf16")[0]
              for p, s in scenes.items()}
    checks, _ = check.check(images, scenes, cfg, workers=workers)
    return {"seed": seed, "correct": all(v["value"] <= v["limit"]
                                         for v in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m frame_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    from .spec import cell, load_benchmark
    c = cell(load_benchmark(Path.cwd()), args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **control(c, seed, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
