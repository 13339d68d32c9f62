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
takes ``--cpu`` as the benchmark does).
"""

from __future__ import annotations

import statistics

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
