"""The benchmark's generated scene: BASELINE config 3 (a frozen copy of
``make_random_beziers`` from the port's ``scene/fixtures.py``)."""

from __future__ import annotations

import numpy as np

from ..config import TOLERANCE
from ..geometry import BezPath, flatten_path
from .scene import Scene, SceneBuilder


def make_random_beziers(n: int = 10000, size: int = 1024, seed: int = 11,
                        fill_fraction: float = 0.5) -> Scene:
    """BASELINE config 3: 10k random cubic Beziers (stress test for binning).

    Each item is a single flattened cubic; half are filled (implicitly
    closed), half are stroked.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.begin_group()
    for i in range(n):
        base = rng.uniform(0, size, 2)
        ctrl = base + rng.uniform(-size * 0.05, size * 0.05, (3, 2))
        path = BezPath()
        path.move_to((float(base[0]), float(base[1])))
        path.curve_to(tuple(ctrl[0]), tuple(ctrl[1]), tuple(ctrl[2]))
        sub = flatten_path(path, TOLERANCE)
        color = (int(rng.integers(0, 1 << 24)) << 8) | int(rng.integers(64, 256))
        if i % 2 == 0 and fill_fraction > 0:
            b.fill_path(sub, color)
        else:
            b.stroke_path(sub, float(rng.uniform(0.5, 4.0)), color)
    b.end_group()
    return b.build()
