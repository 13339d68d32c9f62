"""Shape primitives -> BezPath (the kurbo::Shape role).

The reference's scene builders construct kurbo shapes (Circle, Line,
BezPath -- src/lib.rs:256-284) and hand them to the encoder; these
helpers give piet-tpu's RenderContext (piet_tpu/api.py) the same
vocabulary.  Curved boundaries use the standard 4-arc cubic circle
approximation (kappa = (4/3)(sqrt(2) - 1)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from .path import BezPath

#: Cubic-arc circle constant.
KAPPA = 4.0 / 3.0 * (math.sqrt(2.0) - 1.0)


@dataclasses.dataclass(frozen=True)
class Rect:
    x0: float
    y0: float
    x1: float
    y1: float

    def to_path(self) -> BezPath:
        p = BezPath()
        p.move_to((self.x0, self.y0))
        p.line_to((self.x1, self.y0))
        p.line_to((self.x1, self.y1))
        p.line_to((self.x0, self.y1))
        p.close_path()
        return p


@dataclasses.dataclass(frozen=True)
class RoundedRect:
    x0: float
    y0: float
    x1: float
    y1: float
    radius: float

    def to_path(self) -> BezPath:
        x0, y0, x1, y1 = self.x0, self.y0, self.x1, self.y1
        r = min(self.radius, (x1 - x0) / 2, (y1 - y0) / 2)
        if r <= 0:
            return Rect(x0, y0, x1, y1).to_path()
        k = r * KAPPA
        p = BezPath()
        p.move_to((x0 + r, y0))
        p.line_to((x1 - r, y0))
        p.curve_to((x1 - r + k, y0), (x1, y0 + r - k), (x1, y0 + r))
        p.line_to((x1, y1 - r))
        p.curve_to((x1, y1 - r + k), (x1 - r + k, y1), (x1 - r, y1))
        p.line_to((x0 + r, y1))
        p.curve_to((x0 + r - k, y1), (x0, y1 - r + k), (x0, y1 - r))
        p.line_to((x0, y0 + r))
        p.curve_to((x0, y0 + r - k), (x0 + r - k, y0), (x0 + r, y0))
        p.close_path()
        return p


@dataclasses.dataclass(frozen=True)
class Ellipse:
    center: Tuple[float, float]
    rx: float
    ry: float

    def to_path(self) -> BezPath:
        cx, cy = self.center
        rx, ry = self.rx, self.ry
        kx, ky = rx * KAPPA, ry * KAPPA
        p = BezPath()
        p.move_to((cx + rx, cy))
        p.curve_to((cx + rx, cy + ky), (cx + kx, cy + ry), (cx, cy + ry))
        p.curve_to((cx - kx, cy + ry), (cx - rx, cy + ky), (cx - rx, cy))
        p.curve_to((cx - rx, cy - ky), (cx - kx, cy - ry), (cx, cy - ry))
        p.curve_to((cx + kx, cy - ry), (cx + rx, cy - ky), (cx + rx, cy))
        p.close_path()
        return p


@dataclasses.dataclass(frozen=True)
class CirclePath:
    """A circle as a PATH (4 cubic arcs).

    Distinct from the scene-item circle (SceneBuilder.circle /
    RenderContext's Circle fast path, which uses the reference's exact
    per-pixel circle command, PietRender.metal:481-493).
    """
    center: Tuple[float, float]
    radius: float

    def to_path(self) -> BezPath:
        return Ellipse(self.center, self.radius, self.radius).to_path()


@dataclasses.dataclass(frozen=True)
class Line:
    p0: Tuple[float, float]
    p1: Tuple[float, float]

    def to_path(self) -> BezPath:
        p = BezPath()
        p.move_to(self.p0)
        p.line_to(self.p1)
        return p
