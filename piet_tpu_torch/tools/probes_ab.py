"""Time the tools' probe kernels of two source trees on one CUDA card, in
turns.

    python -m piet_tpu_torch.tools.probes_ab ROOT_A ROOT_B

ROOT_A and ROOT_B are checkouts of this repository (a parent commit
unpacked with ``git archive`` into a gitignored directory, and the working
tree).  The trees run in a palindrome (A, B, B, A), every run in a process
of its own that imports ``piet_tpu_torch`` and ``chip_smoke`` from its
root, builds its kernels there and times with chip_smoke's ``time_ms``
(CUDA events around back-to-back calls behind a GPU spin):

  div       probe_div on div_probe's 2^20 operands and on 2^22 and 2^24
            seeded ones, and torch.div on the same, three batches of 20
            calls each, the operands and outputs taken in turn from sets
            that together are 4x the L2 (``l2_cold``);
  numerics  probe_numerics on mosaic_numerics_probe's inputs: the 16
            launches (8 ops x 2 shapes, 16 batches a launch) as one
            batch, and the div and sqrt launches beside torch.div and
            torch.sqrt;
  delivery  every probe_delivery variant on arg_delivery_bench's stream,
            ns/entry at one tile with its REPS (two launches), and where
            the tree takes ``tiles``, ns per entry and tile at its
            WIDE_TILES with WIDE_REPS (three launches);
  words off plain  the words of probe_div, every probe_numerics launch
            and (where the tree takes ``tiles``) every delivery variant's
            states and pass counts at WIDE_TILES that differ from the
            plain versions: a tree that is fast and wrong shows here.

Each run prints one JSON line; then, per number, each tree's mean and its
two runs (``tools.ab_lines``).  Exits 1 when no card is present.
"""

from __future__ import annotations

import inspect
import itertools
import json
import math
import os
import subprocess
import sys


def l2_cold(fn, *tensors):
    """``fn`` over copies of ``tensors`` taken in turn, each set with an
    output of its own: enough sets that their operands and outputs
    together are 4x the card's L2, so back-to-back calls read and write
    device memory (the bound of ``roofline.bound`` counts its rate).  A
    set's last output is freed just before its next call, which then
    gets that block from the caching allocator."""
    import torch
    per = sum(t.numel() * t.element_size() for t in (*tensors, fn(*tensors)))
    l2 = torch.cuda.get_device_properties(tensors[0].device).L2_cache_size
    turn = itertools.cycle([[t.clone() for t in tensors] + [None]
                            for _ in range(math.ceil(4 * l2 / per))])

    def call():
        s = next(turn)
        s[-1] = None
        s[-1] = fn(*s[:-1])
        return s[-1]
    return call


def measure(dev) -> dict:
    """The numbers of the module doc for the tree on ``sys.path``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from piet_tpu_torch import kernels
    from piet_tpu_torch.ops import probes
    from piet_tpu_torch.tools import (arg_delivery_bench, div_probe,
                                      mosaic_numerics_probe)

    res = {"library": str(kernels.build())}
    a, b = div_probe.operands()
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    rng = np.random.RandomState(0)
    for size in (20, 22, 24):
        x, y = (at, bt) if size == 20 else (
            torch.from_numpy(rng.uniform(lo, 4, 1 << size).astype(
                np.float32)).to(dev) for lo in (-4, 0.5))
        for name, fn in (("probe_div", probes.probe_div),
                         ("torch.div", torch.div)):
            cold = l2_cold(fn, x, y)
            res[f"{name} 2^{size}"] = [cs.time_ms(cold, reps=20, warm=2)
                                       for _ in range(3)]
            del cold
    off = cs.bitwise(probes.probe_div(at, bt), at / bt)[0]
    calls = []
    for (name, shape), batches in mosaic_numerics_probe.inputs().items():
        ins = [torch.from_numpy(np.stack(c)).to(dev) for c in zip(*batches)]
        calls.append((name, ins))
        off += cs.bitwise(probes.probe_numerics(name, *ins),
                          probes.probe_numerics_plain(name, *ins))[0]
        lib = {"div": torch.div, "sqrt": torch.sqrt}.get(name)
        if lib is not None:
            tag = f"{name} {shape}"
            res[f"probe_numerics {tag}"] = cs.time_ms(
                lambda: probes.probe_numerics(name, *ins), reps=20, warm=2)
            res[f"torch.{tag}"] = cs.time_ms(lambda: lib(*ins), reps=20,
                                             warm=2)
    res["probe_numerics 16 launches"] = cs.time_ms(
        lambda: [probes.probe_numerics(n, *i) for n, i in calls], reps=20,
        warm=2)
    d = arg_delivery_bench.data(device=dev)
    tiled = "tiles" in inspect.signature(probes.probe_delivery).parameters
    for v in probes.DELIVERY_VARIANTS:
        reps = arg_delivery_bench.REPS
        ms = cs.time_ms(lambda: probes.probe_delivery(d, v, reps), reps=2,
                        warm=1)
        res[f"delivery {v} 1 tile ns/entry"] = ms * 1e6 / (d.shape[0] * reps)
        if tiled:
            t = arg_delivery_bench.WIDE_TILES
            reps = arg_delivery_bench.WIDE_REPS
            ms = cs.time_ms(lambda: probes.probe_delivery(d, v, reps, t),
                            reps=3, warm=1)
            res[f"delivery {v} {t} tiles ms"] = ms
            res[f"delivery {v} {t} tiles ns/entry a tile"] = (
                ms * 1e6 / (d.shape[0] * reps * t))
            got, passes = probes.probe_delivery(d, v, reps, t)
            want, want_passes = probes.probe_delivery_plain(d, v, reps, t)
            off += cs.bitwise(got, want)[0] + int(
                (passes != want_passes).sum())
    res["words off plain"] = off
    torch.cuda.synchronize()
    return res


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    print(json.dumps(measure(torch.device("cuda"))), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        worker(os.path.abspath(argv[1]))
        return 0
    import torch

    from piet_tpu_torch.tools import ab_lines, ab_runs
    if not torch.cuda.is_available():
        print("probes_ab: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    trees = dict(zip("AB", (os.path.abspath(r) for r in argv)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    runs = ab_runs(os.path.abspath(__file__), trees)
    if runs is None:
        return 1
    print("\n".join(ab_lines(runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
