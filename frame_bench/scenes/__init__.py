"""The cells' inputs: each configuration's scene from the seed, and the
affines of a traffic mix's poses.

A configuration file's ``scene`` names its ``kind`` and the kind's
parameters.  The maker of kind ``<kind>`` is ``make(params)`` of the module
``scenes/<kind>.py``, which returns a frozen reference ``Scene``: a new
kind of scene is a new module.

The run's seed recolours the scene: every item gets an RGB drawn from the
seed and keeps its alpha.  The geometry, and so every record count, tile
list and pixel the frame works on, is the same for every seed (a seed
that moved the geometry changed the frame's work by up to 5% between
seeds), while each seed's image, and so the comparison, is its own.

Poses (the rebuild and anim mixes) follow the ``animate --affine``
formula: pose k of n turns the scene by a = 2*pi*k/n about the viewport
centre with zoom 1 + zoom*sin(a).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..spec import find_module


def recolor(scene, seed: int):
    """``scene`` with every item's RGB drawn from ``seed``, alpha kept."""
    rng = np.random.default_rng([seed, 0x5EED])
    rgb = rng.integers(0, 1 << 24, size=scene.n_items, dtype=np.uint32)
    colors = (rgb << np.uint32(8)) | (scene.colors & np.uint32(0xFF))
    return dataclasses.replace(scene, colors=colors.astype(np.uint32))


def make_scene(config: dict, seed: int):
    """The configuration's scene for ``seed`` (a frozen reference Scene)."""
    p = config["scene"]
    return recolor(find_module("scenes", p["kind"]).make(p), seed)


def pose_angle(k: int, n: int) -> float:
    return 2.0 * math.pi * k / n


def pose_matrix(k: int, n: int, zoom: float, width: int, height: int):
    """Pose ``k`` of ``n`` as a (6,) f32 affine [a, b, c, d, e, f]
    (x' = a*x + b*y + e, y' = c*x + d*y + f), worked out in f64 on the
    host: the rebuild mix's host scenes."""
    a = pose_angle(k, n)
    s = 1.0 + zoom * math.sin(a)
    ca, sa = math.cos(a) * s, math.sin(a) * s
    cx, cy = width / 2.0, height / 2.0
    return np.array([ca, -sa, sa, ca, cx - ca * cx + sa * cy,
                     cy - sa * cx - ca * cy], np.float32)
