"""Measure the per-entry cost of delivering a fine entry's operands to
its vector work: uniform loads from device memory, staged broadcasts from
shared memory, or batches of 8 entries.

Port of ``tools/arg_delivery_bench.py``.  The ``probe_delivery`` kernel
(``csrc/probes.cu``) runs the line_field_sq op mix (subs, muls, a divide,
clamps, a min-accumulate) of every entry of an N-entry stream, REPS times
over, on a tile of 8, 16 or 32 rows of 128, with the fine kernel's
dependency structure: a loop-carried state, kernel D's eight pixels of a
row a thread.  The tool's variants keep their names; on the card:

  smem*    -- each entry's operands loaded by every thread from device
              memory, one uniform 16-byte load of words 0-3 (and one of
              words 4-7 where the variant reads them), the next entry's
              issued before this one's chain (the TPU's SMEM scalars)
  vmem     -- the entry rows staged in shared memory 128 at a time
              (cp.async, double-buffered) and read as 16-byte broadcasts
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
#: The card-wide reading: the 1664^2 tiger's tiles (half_experiment.TILES)
#: and the passes cut to keep a launch near 10-30 ms.
WIDE_TILES = 676
WIDE_REPS = 16


def data(n: int = N, device="cuda") -> torch.Tensor:
    """The tool's stream: (n, 16) f32, ``RandomState(0)`` uniform (0,
    128)."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(
        rng.uniform(0, 128, size=(n, 16)).astype(np.float32)).to(device)


def mixed_data(n: int, device="cuda") -> torch.Tensor:
    """n entries of the tool's stream, every third a short line with a
    thin band (sy from 2.25 to 21.25, ey = sy + 3, thr 0.5: its window
    fits near the top of the tile and misses further down) and every
    fifth tagged 3.  On the tool's own stream no window fits and 1/128
    of the entries is tagged 3; the tests check the windowed and
    dispatch variants on this one."""
    d = data(n, device)
    k = torch.arange(0, n, 3, device=d.device)
    d[k, 1] = 2.25 + (k % 20).to(torch.float32)
    d[k, 3] = d[k, 1] + 3.0
    d[k, 4] = 0.5
    d[::5, 5] = 3.0
    return d


def ns_per_entry(name: str, d: torch.Tensor, reps: int = REPS,
                 tiles: int = 1) -> float:
    """A launch's time over its entries and tiles: at one tile the tool's
    ns/entry.  The launch returns the (tiles, rows, 128) states and each
    tile's count of chain updates; the tool returns rows 0-7 of the one
    tile's state."""
    ms = cuda_ms(lambda: probe_delivery(d, name, reps, tiles), calls=1,
                 samples=3)
    return ms * 1e6 / (d.shape[0] * reps * tiles)


def main(argv=None) -> int:
    names = sys.argv[1:] if argv is None else argv
    d = data(device=card())
    for name in DELIVERY_VARIANTS:
        if names and name not in names:
            continue
        print(f"{name:8s}: {ns_per_entry(name, d):.1f} ns/entry", flush=True)
        wide = ns_per_entry(name, d, WIDE_REPS, WIDE_TILES)
        print(f"{name:8s}: {wide:.3f} ns/entry a tile at {WIDE_TILES} "
              f"tiles (reps cut from {REPS} to {WIDE_REPS})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
