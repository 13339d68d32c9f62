"""The port's counterparts of the JAX package's ``tools/``, under the
same names: the numerics probes (``div_probe``,
``mosaic_numerics_probe``) and access-pattern probes (``mosaic_probe``),
the microbenchmarks (``half_experiment``, ``arg_delivery_bench``,
``fine_entry_bench`` on kernel D, ``dispatch_probe``), and the
diagnostics that run the frame's kernels (``group_stats``,
``mesh_balance``, ``engine_probe``, ``eng_bisect_probe``,
``eng_array_probe`` with ``engines``, ``grad_exact_probe``,
``grad_tile_probe``, ``precompile_cache``), and ``time_config`` (one
config of ``piet_tpu_torch.bench``).  Each runs on the card as
``python -m piet_tpu_torch.tools.<name>`` and prints the lines its JAX
tool prints ("mosaic" read as "kernel"); its functions take ``device=``
("cpu" in the tests, where the kernels' plain versions run).  A tool's
``main`` needs the card: there is no CPU fallback (``time_config``
takes ``--cpu`` as the benchmark does).  Two have no JAX counterpart:
``pairing_ab`` and ``probes_ab`` time the pairing path's and the probes'
kernels of two source trees in turns.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch


def card() -> torch.device:
    """The CUDA device the tools run on; raises without one."""
    from ..renderer.renderer import check_device
    return check_device("cuda")


#: GPU spin before a timed batch (~25 ms at H100 clocks): the host
#: enqueues the batch while the card is busy, so the events time
#: back-to-back device work and not the host's launch overhead.
SPIN_CYCLES = 50_000_000


def cuda_ms(fn, calls: int, samples: int = 5) -> float:
    """ms per call of ``fn`` (device work only): CUDA events around
    ``calls`` back-to-back calls, enqueued behind a GPU spin, after one
    warm-up call; the median of ``samples`` such batches."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")
    fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def ab_runs(script: str, trees: dict):
    """The A/B tools' runs: ``python script --worker ROOT`` for each tree
    (name -> root), each in a process of its own started in its root, in
    a palindrome (the trees in order, then in reverse: A B B A for two).
    Returns name -> the tree's two results, each the JSON object on its
    worker's last line, printing a line a run as it ends; None, with the
    worker's output on stderr, when a worker fails."""
    runs = {t: [] for t in trees}
    for t in list(trees) + list(trees)[::-1]:
        proc = subprocess.run([sys.executable, script, "--worker", trees[t]],
                              capture_output=True, text=True, cwd=trees[t])
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return None
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[t].append(res)
        print(f"run {t} {trees[t]}: {json.dumps(res)}", flush=True)
    return runs


def _mean(v):
    return statistics.fmean(v) if isinstance(v, list) else v


def ab_lines(runs: dict) -> list:
    """One line a number of ``ab_runs``' results (all but "library"), each
    tree that has it: its mean over the two runs, then each run's value (a
    list within a run, repeats, taken as its mean)."""
    lines = []
    for key in dict.fromkeys(k for rs in runs.values() for k in rs[0]):
        if key == "library":
            continue
        parts = []
        for t, rs in runs.items():
            if key in rs[0]:
                v = [_mean(r[key]) for r in rs]
                parts.append(f"{t} {statistics.fmean(v):.4f} ("
                             + ", ".join(f"{x:.4f}" for x in v) + ")")
        lines.append(f"ab {key}: " + ", ".join(parts))
    return lines
