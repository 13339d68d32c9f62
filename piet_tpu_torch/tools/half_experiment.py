"""Reduced-precision experiment: does a half-precision state save cycles
on the card?

Port of ``tools/half_experiment.py``.  The reference keeps colour and
coverage in half.  The TPU said no: its VPU lanes are 32-bit and bf16
elementwise ops do not pack two to a lane.  Hopper's ALU does pack: an
``__nv_bfloat162`` op is one instruction on two bf16.  The
``probe_halfmix`` kernel (``csrc/probes.cu``) runs the fine interpreter's
per-entry op mix (mul/add/min/max/select chain over the tile state,
compare in f32) N_ITER times over a (32, 128) and a (16, 128) tile state,
in f32, bf16 and packed bf16x2, at the tool's grid of one tile and at 676
tiles (the 1664^2 tiger's tile count: one tile leaves all but one SM
idle).  Reports ns/entry a tile: a step of the chain over every tile,
over the tiles (at one tile, the tool's ns/entry).

Usage: python -m piet_tpu_torch.tools.half_experiment
"""

from __future__ import annotations

from ..ops.probes import HALFMIX_KINDS, halfmix_init, probe_halfmix
from . import card, cuda_ms

N_ITER = 4096
SHAPES = ((32, 128), (16, 128))
#: The tool's grid of one tile, and the 1664^2 tiger's 676 tiles.
TILES = (1, 676)


def run(kind: str, shape, tiles: int = 1, n_iter: int = N_ITER,
        device="cuda"):
    """st2 after ``n_iter`` steps from the tool's start, (tiles, rows,
    128) f32."""
    return probe_halfmix(halfmix_init(shape[0], device), kind, tiles, n_iter)


def step_ns(kind: str, shape, tiles: int, n_iter: int = N_ITER,
            device="cuda") -> float:
    """ns per step of the chain over all ``tiles``: a launch's time over
    n_iter.  At one tile it is the tool's ns/entry."""
    init = halfmix_init(shape[0], device)
    ms = cuda_ms(lambda: probe_halfmix(init, kind, tiles, n_iter), calls=5)
    return ms * 1e6 / n_iter


def main() -> int:
    dev = card()
    for tiles in TILES:
        for shape in SHAPES:
            for kind in HALFMIX_KINDS:
                ns = step_ns(kind, shape, tiles, device=dev)
                print(f"shape={shape} dtype={kind} tiles={tiles}: "
                      f"{ns / tiles:.2f} ns/entry a tile ({ns:.1f} ns a "
                      f"step of all {tiles})", flush=True)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
