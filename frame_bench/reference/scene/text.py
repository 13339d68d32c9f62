"""The benchmark's text page: body text set in DejaVu Sans, each glyph one
combined fill, so that a glyph's counters (the holes of ``o``, ``e``,
``d``) stay holes.

The outlines are the font's TrueType contours in font units, read from
``reference/assets/dejavu_sans_glyphs.json`` (written by
``assets/dejavu_glyphs.py``).  The layout is plain: no kerning, no hinting,
the pen's x the sum of the advance widths in f64, never snapped; words wrap
at spaces at the right margin.  TrueType's quadratic segments are raised to
their exact cubics in f64 device space, since the flattener (the
reference's ``flatten.rs`` semantics) drops ``QuadTo``; the cubics are then
flattened at ``TOLERANCE``.  That flattener counts its
pieces by how far a cubic is from a quadratic, so a raised quadratic
flattens to its one chord: each glyph is the polygon of its on-curve and
implied on-curve points (up to 0.57 px off the curve at 16 px).
"""

from __future__ import annotations

import functools
import itertools
import json
import os
from typing import List, Tuple

from ..config import TOLERANCE
from ..geometry import BezPath, flatten_path
from .scene import Scene, SceneBuilder

Point = Tuple[float, float]

GLYPHS_PATH = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "assets", "dejavu_sans_glyphs.json"))

#: The standard Lorem ipsum passage, repeated as the page needs.
LOREM = (
    "Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed do "
    "eiusmod tempor incididunt ut labore et dolore magna aliqua. Ut enim "
    "ad minim veniam, quis nostrud exercitation ullamco laboris nisi ut "
    "aliquip ex ea commodo consequat. Duis aute irure dolor in "
    "reprehenderit in voluptate velit esse cillum dolore eu fugiat nulla "
    "pariatur. Excepteur sint occaecat cupidatat non proident, sunt in "
    "culpa qui officia deserunt mollit anim id est laborum.")

#: Opaque black (0xRRGGBBAA); the run's seed recolours each item.
INK = 0x000000FF


@functools.lru_cache(maxsize=1)
def load_glyphs() -> dict:
    """The asset: ``units_per_em``, ``version``, ``source`` and per
    character its ``advance`` and ``contours`` ([op, points] as
    fontTools' RecordingPen gives them)."""
    with open(GLYPHS_PATH, encoding="utf-8") as f:
        return json.load(f)


def elevate(p0: Point, q: Point, p2: Point) -> Tuple[Point, Point]:
    """The inner control points of the cubic equal to the quadratic
    (p0, q, p2): p0 + 2/3 (q - p0) and p2 + 2/3 (q - p2)."""
    return ((p0[0] + 2.0 / 3.0 * (q[0] - p0[0]),
             p0[1] + 2.0 / 3.0 * (q[1] - p0[1])),
            (p2[0] + 2.0 / 3.0 * (q[0] - p2[0]),
             p2[1] + 2.0 / 3.0 * (q[1] - p2[1])))


def glyph_path(contours, x: float, baseline: float, scale: float) -> BezPath:
    """A glyph's contours in device space (y down) with its origin at
    (x, baseline), every quadratic raised to its cubic.  A ``qCurveTo``'s
    run of off-curve points has implied on-curve points at the midpoints
    of consecutive off-curve points."""
    def dev(p) -> Point:
        return (x + p[0] * scale, baseline - p[1] * scale)

    path, cur = BezPath(), None
    for op, pts in contours:
        if op == "moveTo":
            cur = dev(pts[0])
            path.move_to(cur)
        elif op == "lineTo":
            cur = dev(pts[0])
            path.line_to(cur)
        elif op == "qCurveTo":
            off, end = [dev(p) for p in pts[:-1]], dev(pts[-1])
            for i, q in enumerate(off):
                p2 = end if i + 1 == len(off) else (
                    (q[0] + off[i + 1][0]) / 2.0, (q[1] + off[i + 1][1]) / 2.0)
                path.curve_to(*elevate(cur, q, p2), p2)
                cur = p2
        elif op != "closePath":
            raise ValueError(f"unexpected pen operation {op!r}")
    return path


def layout(n_glyphs: int, size: int, px: float, line: float,
           margin: float) -> List[Tuple[str, float, float]]:
    """(character, pen x, baseline) of the first ``n_glyphs`` characters
    with an outline: the passage, repeated, word-wrapped between the
    margins; the first baseline at ``margin + px``."""
    font = load_glyphs()
    glyphs, scale = font["glyphs"], px / font["units_per_em"]
    edge = size - margin
    space = glyphs[" "]["advance"] * scale
    x, y, placed = float(margin), float(margin + px), []
    for word in itertools.cycle(LOREM.split()):
        width = sum(glyphs[c]["advance"] for c in word) * scale
        if x > margin and x + width > edge:
            x, y = float(margin), y + line
        if y > edge:
            raise ValueError(f"{n_glyphs} glyphs do not fit a {size} page")
        for c in word:
            if glyphs[c]["contours"]:
                placed.append((c, x, y))
                if len(placed) == n_glyphs:
                    return placed
            x += glyphs[c]["advance"] * scale
        x += space


def make_text_page(n_glyphs: int = 5000, size: int = 1024, px: float = 16.0,
                   line: float = 20.0, margin: float = 8.0) -> Scene:
    """A ``size`` square page of ``n_glyphs`` glyphs of body text, each
    one ``fill_path(..., combined=True)`` in opaque black, nonzero."""
    font = load_glyphs()
    scale = px / font["units_per_em"]
    b = SceneBuilder()
    for c, x, y in layout(n_glyphs, size, px, line, margin):
        path = glyph_path(font["glyphs"][c]["contours"], x, y, scale)
        b.fill_path(flatten_path(path, TOLERANCE), INK, combined=True)
    return b.build()
