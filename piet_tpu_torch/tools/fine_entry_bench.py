"""Decompose kernel D's cost: ns/entry by class and the per-tile fixed
cost (intercept), on the port's ``fine_rasterize_entries``.

Port of ``tools/fine_entry_bench.py``.  Times kernel D
(``csrc/fine.cu``) on SYNTHETIC streams (every tile the same entry mix)
so its cost is attributed by a linear fit:

  ms(n) = tiles * (intercept + n * slope)

over n in {2, 34, 130} entries a tile, per class mix:

  lines   -- one line run per tile (+ one CmdStroke resolve)
  fills   -- one plain-fill run per tile (+ one CmdDrawFill resolve)
  edges   -- CmdFillEdge entries (slot-0) + one CmdDrawFill
  resolve -- alternating CmdStroke/CmdSolid entries (resolve-heavy)

Timed with CUDA events around back-to-back launches enqueued behind a
GPU spin, so the device's time and not the host's enqueue is measured
(the tool subtracts a host fetch from a host clock).  The port's kernel D always runs its
run dispatch, so the tool's PIET_RUNS knob has no counterpart: the
header says runs=True.

Usage: python -m piet_tpu_torch.tools.fine_entry_bench [mix ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..layout.entry_stream import (ENTRY_WORDS, W_RUN, W_S0_ARG, W_S0_TAG,
                                   W_S1_ARG, W_S1_TAG)
from ..ops.fine import fine_rasterize_entries
from ..raster.ptcl import (CMD_DRAW_FILL, CMD_FILL, CMD_FILL_EDGE, CMD_LINE,
                           CMD_SOLID, CMD_STROKE)
from . import card, cuda_ms

TILE_H, TILE_W = 32, 128
TILES_X, TILES_Y = 8, 8          # 64 tiles
FRAMES = 30
MIXES = ("lines", "fills", "edges", "resolve")
NS = (2, 34, 130)
#: Operand words 8-11 of a draw: the NO_CLIP rect.
NO_CLIP = (-1e9, -1e9, 1e9, 1e9)


def build_stream(mix: str, n: int, rng):
    """Synthetic per-tile entry list, every tile identical in structure,
    as the tool builds it (the same draws from ``rng``).

    Returns (first, n_entries, solid, stream) numpy arrays for a
    (TILES_Y*TILES_X) grid with n entries per tile: int32 (T,) ranges,
    int32 (T,) present colours (0: none), and the (E, 16) f32
    entry-major stream padded to a multiple of 128 entries (the tool's
    (E/128, 16, 128) blocks, transposed)."""
    T = TILES_Y * TILES_X
    total = T * n
    blocks = (total + 127) // 128
    stream = np.zeros((max(blocks, 1) * 128, ENTRY_WORDS), np.float32)

    def put(e, word, val):
        stream[e, word] = val

    def no_clip(e):
        for w, v in zip(range(9, 13), NO_CLIP):
            put(e, w, v)

    for t in range(T):
        ty, tx = divmod(t, TILES_X)
        x0, y0 = tx * TILE_W, ty * TILE_H
        base = t * n
        for k in range(n):
            e = base + k
            last = k == n - 1
            if mix == "lines":
                if last:
                    put(e, W_S0_TAG, CMD_STROKE)
                    put(e, W_S0_ARG + 0, 1.5)            # half width
                    put(e, W_S0_ARG + 1, 0.8)            # color
                    put(e, W_S0_ARG + 4, 1.0)            # alpha
                    no_clip(e)
                else:
                    sx = x0 + rng.uniform(0, TILE_W)
                    sy = y0 + rng.uniform(0, TILE_H)
                    put(e, W_S0_TAG, CMD_LINE)
                    put(e, W_S0_ARG + 0, sx)
                    put(e, W_S0_ARG + 1, sy)
                    put(e, W_S0_ARG + 2, sx + rng.uniform(-9, 9))
                    put(e, W_S0_ARG + 3, sy + rng.uniform(-5, 5))
                    put(e, W_S0_ARG + 4, 2.0)            # thr = hw + .5
                    put(e, W_RUN, -(n - 1 - k))
            elif mix == "fills":
                if last:
                    put(e, W_S0_TAG, CMD_DRAW_FILL)
                    put(e, W_S0_ARG + 0, 0.0)            # backdrop
                    put(e, W_S0_ARG + 1, 0.6)
                    put(e, W_S0_ARG + 4, 1.0)
                    no_clip(e)
                else:
                    sx = x0 + rng.uniform(0, TILE_W)
                    sy = y0 + rng.uniform(0, TILE_H)
                    put(e, W_S1_TAG, CMD_FILL)
                    put(e, W_S1_ARG + 0, sx)
                    put(e, W_S1_ARG + 1, sy)
                    put(e, W_S1_ARG + 2, sx + rng.uniform(-9, 9))
                    put(e, W_S1_ARG + 3, sy + rng.uniform(-5, 5))
                    put(e, W_RUN, n - 1 - k)
            elif mix == "edges":
                if last:
                    put(e, W_S0_TAG, CMD_DRAW_FILL)
                    put(e, W_S0_ARG + 1, 0.6)
                    put(e, W_S0_ARG + 4, 1.0)
                    no_clip(e)
                else:
                    put(e, W_S0_TAG, CMD_FILL_EDGE)
                    put(e, W_S0_ARG + 0, 1.0 if k % 2 == 0 else -1.0)
                    put(e, W_S0_ARG + 1, y0 + rng.uniform(0, TILE_H))
            elif mix == "resolve":
                if k % 2 == 0:
                    put(e, W_S0_TAG, CMD_STROKE)
                    put(e, W_S0_ARG + 0, 1.5)
                    put(e, W_S0_ARG + 1, 0.8)
                    put(e, W_S0_ARG + 4, 0.5)
                else:
                    put(e, W_S0_TAG, CMD_SOLID)
                    put(e, W_S0_ARG + 0, 0.5)
                    put(e, W_S0_ARG + 1, 0.4)
                    put(e, W_S0_ARG + 3, 0.5)
                no_clip(e)
            else:
                raise ValueError(f"unknown mix {mix}")

    first = np.arange(T, dtype=np.int32) * n
    n_entries = np.full(T, n, np.int32)
    solid = np.zeros(T, np.int32)
    return first, n_entries, solid, stream


def inputs(mix: str, n: int, device="cuda"):
    """The stream of ``mix`` at ``n`` entries a tile, drawn from
    ``RandomState(7)`` as the tool draws it, on ``device``."""
    return tuple(torch.from_numpy(x).to(device)
                 for x in build_stream(mix, n, np.random.RandomState(7)))


def render(args) -> torch.Tensor:
    """Kernel D on the stream: the (256, 1024) int32 image."""
    return fine_rasterize_entries(*args, tile_h=TILE_H, tile_w=TILE_W,
                                  tiles_x=TILES_X)


def time_mix(mix: str, n: int, device="cuda") -> float:
    """ms of one kernel D call on the stream, CUDA events around FRAMES
    back-to-back calls, median of 5."""
    args = inputs(mix, n, device)
    return cuda_ms(lambda: render(args), calls=FRAMES)


def fit(ms) -> tuple:
    """(slope ns/entry, intercept ns/tile) of ms(n) = T * (intercept +
    slope * n) over NS, least squares."""
    T = TILES_Y * TILES_X
    A = np.vstack([np.ones(len(NS)), np.array(NS)]).T
    coef, *_ = np.linalg.lstsq(A, np.array(ms) * 1e6 / T, rcond=None)
    icept, slope = coef
    return float(slope), float(icept)


def main(argv=None) -> int:
    mixes = (sys.argv[1:] if argv is None else argv) or list(MIXES)
    dev = card()
    T = TILES_Y * TILES_X
    print(f"# runs=True tiles={T} tile={TILE_W}x{TILE_H}", flush=True)
    for mix in mixes:
        ms = [time_mix(mix, n, dev) for n in NS]
        slope, icept = fit(ms)
        pts = " ".join(f"n={n}:{m:.3f}ms" for n, m in zip(NS, ms))
        # The card runs the 64 tiles at once (4 blocks a tile, 256 of
        # them on 132 SMs), not one after another as the TPU's grid
        # does: T times the fit is what one tile's latency pays.
        print(f"{mix:8s} {pts}  ->  {slope:.1f} ns/entry"
              f" + {icept:.0f} ns/tile (one tile's latency: "
              f"{slope * T:.0f} ns/entry + {icept * T:.0f} ns)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
