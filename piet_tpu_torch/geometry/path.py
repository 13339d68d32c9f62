"""Path element representation and affine transforms.

Plays the role kurbo's ``BezPath`` / ``Affine`` play for the reference
(reference: src/lib.rs:7 uses kurbo 0.5.6).  Host-side geometry is float64,
matching kurbo; coordinates are only narrowed to float32 at scene-encode time
(reference: src/lib.rs:99-101 ``point_to_f32s``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Tuple

Point = Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class MoveTo:
    p: Point


@dataclasses.dataclass(frozen=True)
class LineTo:
    p: Point


@dataclasses.dataclass(frozen=True)
class QuadTo:
    p1: Point
    p2: Point


@dataclasses.dataclass(frozen=True)
class CurveTo:
    p1: Point
    p2: Point
    p3: Point


@dataclasses.dataclass(frozen=True)
class ClosePath:
    pass


PathEl = object  # union of the five element types above


@dataclasses.dataclass(frozen=True)
class Affine:
    """2D affine transform as (a, b, c, d, e, f):  x' = a*x + c*y + e,
    y' = b*x + d*y + f  (column-major coefficient order, as kurbo)."""

    coeffs: Tuple[float, float, float, float, float, float]

    @staticmethod
    def identity() -> "Affine":
        return Affine((1.0, 0.0, 0.0, 1.0, 0.0, 0.0))

    @staticmethod
    def scale(s: float) -> "Affine":
        return Affine((s, 0.0, 0.0, s, 0.0, 0.0))

    @staticmethod
    def translate(tx: float, ty: float) -> "Affine":
        return Affine((1.0, 0.0, 0.0, 1.0, tx, ty))

    @staticmethod
    def rotate(theta: float) -> "Affine":
        c, s = math.cos(theta), math.sin(theta)
        return Affine((c, s, -s, c, 0.0, 0.0))

    def __mul__(self, other: "Affine") -> "Affine":
        a1, b1, c1, d1, e1, f1 = self.coeffs
        a2, b2, c2, d2, e2, f2 = other.coeffs
        return Affine((
            a1 * a2 + c1 * b2,
            b1 * a2 + d1 * b2,
            a1 * c2 + c1 * d2,
            b1 * c2 + d1 * d2,
            a1 * e2 + c1 * f2 + e1,
            b1 * e2 + d1 * f2 + f1,
        ))

    def apply(self, p: Point) -> Point:
        a, b, c, d, e, f = self.coeffs
        x, y = p
        return (a * x + c * y + e, b * x + d * y + f)


class BezPath:
    """A sequence of path elements (subpaths start with MoveTo)."""

    def __init__(self, elements: Iterable[PathEl] = ()):  # noqa: D401
        self.elements: List[PathEl] = list(elements)

    def move_to(self, p: Point) -> None:
        self.elements.append(MoveTo(p))

    def line_to(self, p: Point) -> None:
        self.elements.append(LineTo(p))

    def quad_to(self, p1: Point, p2: Point) -> None:
        self.elements.append(QuadTo(p1, p2))

    def curve_to(self, p1: Point, p2: Point, p3: Point) -> None:
        self.elements.append(CurveTo(p1, p2, p3))

    def close_path(self) -> None:
        self.elements.append(ClosePath())

    def transform(self, affine: Affine) -> "BezPath":
        out = BezPath()
        for el in self.elements:
            if isinstance(el, MoveTo):
                out.move_to(affine.apply(el.p))
            elif isinstance(el, LineTo):
                out.line_to(affine.apply(el.p))
            elif isinstance(el, QuadTo):
                out.quad_to(affine.apply(el.p1), affine.apply(el.p2))
            elif isinstance(el, CurveTo):
                out.curve_to(affine.apply(el.p1), affine.apply(el.p2),
                             affine.apply(el.p3))
            else:
                out.close_path()
        return out

    def __len__(self) -> int:
        return len(self.elements)

    def __iter__(self):
        return iter(self.elements)
