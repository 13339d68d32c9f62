"""Whether what the timed path produced is correct.

After the window, the images the loop kept (the last frame of a replay
cell, the latest frame of each of two seed-drawn poses of the others) are
compared with the frozen oracle's image of the same input, rendered in
worker processes (``reference/band.py``).  The number compared is the
count of pixels whose RGBA8 bytes differ from the oracle's; its limit is
0, since the port's contract is bitwise equality.
"""

from __future__ import annotations

import numpy as np

from .reference import band
from .reference.config import RenderConfig

LIMIT = 0


def compare_poses(n_poses: int, seed: int, k: int = 2):
    """The poses whose frames a run compares: ``k`` drawn from the seed
    (None: the last frame of a one-pose cell)."""
    if n_poses == 1:
        return None
    rng = np.random.default_rng([seed, 0xF8A3E])
    return sorted(int(p) for p in rng.choice(n_poses, size=min(k, n_poses),
                                             replace=False))


def reference_config(cfg) -> RenderConfig:
    """The frozen oracle's config for the port's fitted one: the viewport,
    the tiles and the per-tile command capacity are all its tiler reads."""
    return RenderConfig(width=cfg.width, height=cfg.height,
                        tile_height=cfg.tile_height,
                        tile_width=cfg.tile_width,
                        cmd_capacity=cfg.cmd_capacity)


def rgba8(img_i32: np.ndarray) -> np.ndarray:
    """(H, W) int32 words, R in the low byte -> (H, W, 4) uint8."""
    a = np.ascontiguousarray(img_i32)
    return a.view(np.uint8).reshape(*a.shape, 4)


def pixels_off(image: np.ndarray, ref: np.ndarray) -> int:
    if image.shape != ref.shape:
        return int(ref.shape[0] * ref.shape[1])
    return int((image != ref).any(axis=-1).sum())


def check(images: dict, scenes: dict, cfg, workers: int = 0):
    """``images`` pose -> (H, W, 4) uint8 of the program, ``scenes``
    pose -> the host scene the reference renders.  Returns
    (checks {name: {"value", "limit"}}, ptcl of the first pose)."""
    rcfg = reference_config(cfg)
    checks, first = {}, None
    for p in sorted(scenes):
        ref, ptcl = band.render(scenes[p], rcfg, workers=workers)
        if first is None:
            first = ptcl
        got = images.get(p)
        value = (int(ref.shape[0] * ref.shape[1]) if got is None
                 else pixels_off(got, ref))
        checks[f"pose{p}.pixels_off"] = {"value": value, "limit": LIMIT}
    return checks, first
