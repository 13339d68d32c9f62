"""Measure the per-entry cost of delivering a fine entry's operands to
its vector work: uniform loads from device memory, staged broadcasts from
shared memory, or batches of 8 entries.

Port of ``tools/arg_delivery_bench.py``.  The ``probe_delivery`` kernel
(``csrc/probes.cu``) runs the line_field_sq op mix (subs, muls, a divide,
clamps, a min-accumulate) of every entry of an N-entry stream, REPS times
over, on one tile of 8, 16 or 32 rows of 128 (the tool's grid of one
tile), with the fine kernel's dependency structure: a loop-carried state,
kernel D's eight pixels of a row a thread.  The tool's variants keep
their names; on the card:

  smem*    -- each entry's operands loaded by every thread from device
              memory, one uniform address a word (the TPU's SMEM scalars)
  vmem     -- the entry rows staged in shared memory 128 at a time
              (cp.async, double-buffered) and read as broadcasts
  batch8*  -- staged as vmem, 8 entries an iteration, their fields
              min-reduced before the state (valid for order-free
              accumulations = lines)
  smem_win, smemw32 -- smem plus the row window of the fine kernel's
              line_one: the entry's 8-row window where its band fits,
              else the whole tile
  disp16   -- smem16 plus the dispatch shape: a tag word, four class
              branches (the chain at tag 3, an add at 6, a min at slot-1
              tag 4, a multiply at tags >= 5)

The data is the tool's: ``RandomState(0)`` uniform (0, 128), (N, 16).
Its tag word is int(uniform(0, 128)) (the tool's "always 3" does not
hold), so disp16 runs the chain on 1/128 of its entries.  Reports
ns/entry (a launch's time over N * REPS).

Usage: python -m piet_tpu_torch.tools.arg_delivery_bench [variant ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.probes import DELIVERY_VARIANTS, probe_delivery
from . import card, cuda_ms

N = 2048          # entries per kernel invocation
REPS = 256        # interpret the stream this many times per launch


def data(n: int = N, device="cuda") -> torch.Tensor:
    """The tool's stream: (n, 16) f32, ``RandomState(0)`` uniform (0,
    128)."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(
        rng.uniform(0, 128, size=(n, 16)).astype(np.float32)).to(device)


def ns_per_entry(name: str, d: torch.Tensor, reps: int = REPS) -> float:
    """A launch's time over its entries.  The launch returns the (rows,
    128) state; the tool returns rows 0-7 of it."""
    ms = cuda_ms(lambda: probe_delivery(d, name, reps), calls=1, samples=3)
    return ms * 1e6 / (d.shape[0] * reps)


def main(argv=None) -> int:
    names = sys.argv[1:] if argv is None else argv
    d = data(device=card())
    for name in DELIVERY_VARIANTS:
        if names and name not in names:
            continue
        print(f"{name:8s}: {ns_per_entry(name, d):.1f} ns/entry", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
