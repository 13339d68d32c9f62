"""Fine work per row slab under the two partitions of the sharded frame.

Port of ``tools/mesh_balance.py``.  Renders the tiger over N row slabs
(``parallel/sharding.py::ShardedRenderer``; by default 8 slabs, all on
``cuda:0``, as the one-card slab cells run them) under the contiguous
partition and under ``interleave=B``, on the dense route (the JAX tool's
``"xla"``), asserts that both images are equal, and reports each slab's
fine-stage work -- its live commands, the work unit of the roofline's
fine model -- with the total and the imbalance max / mean (what a step
that waits for its slowest slab pays over a balanced one).

Prints one JSON line per partition, then one with both.

Usage: python -m piet_tpu_torch.tools.mesh_balance [--scale 8.0]
       [--interleave 4] [--devices 8]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..config import RenderConfig
from ..parallel.sharding import ShardedRenderer
from ..renderer.capacity import fit_capacities
from ..scene.svg import make_tiger
from . import card


def viewport(scene, n_slabs: int, interleave: int) -> int:
    """The square viewport the JAX tool renders: the scene's extent plus
    8, rounded up to whole blocks of ``32 * n_slabs * interleave`` rows
    (tiles_y must divide over the slabs and the interleave blocks)."""
    size = int(np.ceil(scene.bboxes[:, 3].max() + 8))
    block_px = 32 * n_slabs * interleave
    return -(-size // block_px) * block_px


def balance(scale: float = 8.0, interleave: int = 4, devices=None) -> dict:
    """Each partition's live commands per slab on ``devices`` (a list of
    torch devices, one slab each), both images asserted equal."""
    scene = make_tiger(scale=scale)
    size = viewport(scene, len(devices), interleave)
    cfg = fit_capacities(scene, RenderConfig(width=size, height=size),
                         bucket=True)
    out = {"n_devices": len(devices), "viewport": f"{size}x{size}",
           "scale": scale}
    gold = None
    for name, il in (("contiguous", 1),
                     (f"interleave{interleave}", interleave)):
        r = ShardedRenderer(cfg, devices, fine_impl="dense", interleave=il)
        img = r.render(scene)
        if gold is None:
            gold = img
        else:
            # Both partitions must produce the identical image.
            np.testing.assert_array_equal(img, gold)
        le = r.last_stats.get(
            "live_entries", r.last_stats.get("live_cmds")).astype(np.int64)
        out[name] = {
            "live_entries_per_device": le.tolist(),
            "total": int(le.sum()),
            "imbalance_max_over_mean": round(float(le.max())
                                             / max(le.mean(), 1.0), 3),
        }
    return out


def lines(out: dict) -> list:
    parts = [k for k in out if isinstance(out[k], dict)]
    return [json.dumps({k: out[k]}) for k in parts] + [json.dumps(out)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=8.0)
    ap.add_argument("--interleave", type=int, default=4)
    ap.add_argument("--devices", type=int, default=8,
                    help="row slabs, all on the card")
    args = ap.parse_args(argv)
    dev = card()
    for line in lines(balance(args.scale, args.interleave,
                              [dev] * args.devices)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
