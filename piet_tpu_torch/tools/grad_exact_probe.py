"""Diff the gradient demo's frame on kernel D against the numpy oracle.

Port of ``tools/grad_exact_probe.py``.  Renders ``make_gradient_demo
(256)`` under the tool's configuration on the entries route (kernel D,
the JAX tool's "pallas"), diffs the image against ``cpu_render_scene``
and prints the first 8 differing pixels with their tile and both colours;
when any pixel differs it renders the linear and the radial subsets
alone, to attribute the divergence to one resolve.

Usage: python -m piet_tpu_torch.tools.grad_exact_probe
"""

from __future__ import annotations

import math

import numpy as np

from ..config import RenderConfig
from ..raster.cpu_fine import cpu_render_scene
from ..renderer.renderer import Renderer
from ..scene.fixtures import make_gradient_demo
from ..scene.scene import LinearGradient, RadialGradient, SceneBuilder
from . import card

#: The tool's configuration.
CFG = dict(width=256, height=256, tile_height=16, tile_width=128,
           cmd_capacity=256, max_items=512, max_points=1 << 15,
           max_segments=1 << 15, max_hits=1 << 17,
           max_candidates=1 << 14, max_deltas=1 << 15)


def diff_scene(scene, tag: str, device="cuda"):
    """(mismatched pixels, report lines) of ``scene`` on kernel D
    against the oracle."""
    cfg = RenderConfig(**CFG)
    img = Renderer(cfg, device=device, fine_impl="entries").render(scene)
    gold = cpu_render_scene(scene, cfg)
    d = img.astype(int) - gold.astype(int)
    bad = np.argwhere(d.any(axis=-1))
    lines = [f"[{tag}] mismatched px: {len(bad)}"]
    th, tw = cfg.tile_height, cfg.tile_width
    for y, x in bad[:8]:
        lines.append(f"  px ({y},{x}) tile ({y // th},{x // tw}) "
                     f"dev={img[y, x].tolist()} gold={gold[y, x].tolist()}")
    return len(bad), lines


def subset(which: str, s: float = 256.0):
    """The demo's linear sky or its radial disk alone."""
    b = SceneBuilder()
    if which == "linear":
        b.fill([(-1.0, -1.0), (s + 1.0, -1.0), (s + 1.0, s + 1.0),
                (-1.0, s + 1.0)],
               LinearGradient((0.0, 0.0), (0.0, s), 0x1030A0FF, 0xF0D080FF))
    elif which == "radial":
        k = 40
        disk = [(s * 0.32 + s * 0.26 * math.cos(2 * math.pi * i / k),
                 s * 0.62 + s * 0.26 * math.sin(2 * math.pi * i / k))
                for i in range(k)]
        b.fill(disk, RadialGradient((s * 0.28, s * 0.56), s * 0.3,
                                    0xFFF0C0FF, 0xC03000FF))
    return b.build()


def probe(device="cuda"):
    """(mismatched pixels of the demo, report lines)."""
    scene = make_gradient_demo(256)
    lines = [f"items: {scene.n_items} tags: {scene.tags[:scene.n_items]}"]
    n, more = diff_scene(scene, "full demo", device)
    lines += more
    if n:
        lines += diff_scene(subset("linear"), "linear sky only", device)[1]
        lines += diff_scene(subset("radial"), "radial disk only", device)[1]
    return n, lines


def main(argv=None) -> int:
    for line in probe(card())[1]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
