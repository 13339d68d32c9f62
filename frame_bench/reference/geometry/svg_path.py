"""SVG path-data parser: the `d` attribute -> BezPath.

Plays the role of kurbo 0.5.6's ``BezPath::from_svg`` used by the reference
tiger loader (reference: src/lib.rs:296).  Supports the full SVG 1.1 command
set (M/L/H/V/C/S/Q/T/A/Z, absolute and relative, with implicit repeats);
arcs are converted to cubic Beziers via the standard endpoint-to-center
parameterization so downstream flattening only ever sees lines and cubics.
"""

from __future__ import annotations

import math
import re
from typing import List, Tuple

from .path import BezPath, Point

_NUM_RE = re.compile(
    r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
_TOKEN_RE = re.compile(
    r"([MmLlHhVvCcSsQqTtAaZz])|" + _NUM_RE.pattern)


class SvgPathError(ValueError):
    pass


def _tokenize(d: str):
    for m in _TOKEN_RE.finditer(d):
        if m.group(1):
            yield ("cmd", m.group(1))
        else:
            yield ("num", float(m.group(0)))


def _arc_to_cubics(p0: Point, rx: float, ry: float, x_rot_deg: float,
                   large_arc: bool, sweep: bool, p1: Point
                   ) -> List[Tuple[Point, Point, Point]]:
    """Convert an SVG elliptical arc to cubic segments (W3C F.6.5/F.6.6)."""
    x1, y1 = p0
    x2, y2 = p1
    if (x1, y1) == (x2, y2):
        return []
    rx, ry = abs(rx), abs(ry)
    if rx == 0.0 or ry == 0.0:
        return [((x1 + (x2 - x1) / 3, y1 + (y2 - y1) / 3),
                 (x1 + 2 * (x2 - x1) / 3, y1 + 2 * (y2 - y1) / 3),
                 (x2, y2))]
    phi = math.radians(x_rot_deg)
    cos_phi, sin_phi = math.cos(phi), math.sin(phi)
    dx2, dy2 = (x1 - x2) / 2.0, (y1 - y2) / 2.0
    x1p = cos_phi * dx2 + sin_phi * dy2
    y1p = -sin_phi * dx2 + cos_phi * dy2
    lam = (x1p / rx) ** 2 + (y1p / ry) ** 2
    if lam > 1.0:
        s = math.sqrt(lam)
        rx *= s
        ry *= s
    num = rx * rx * ry * ry - rx * rx * y1p * y1p - ry * ry * x1p * x1p
    den = rx * rx * y1p * y1p + ry * ry * x1p * x1p
    coef = math.sqrt(max(num / den, 0.0))
    if large_arc == sweep:
        coef = -coef
    cxp = coef * rx * y1p / ry
    cyp = -coef * ry * x1p / rx
    cx = cos_phi * cxp - sin_phi * cyp + (x1 + x2) / 2.0
    cy = sin_phi * cxp + cos_phi * cyp + (y1 + y2) / 2.0

    def angle(ux, uy, vx, vy):
        dot = ux * vx + uy * vy
        norm = math.hypot(ux, uy) * math.hypot(vx, vy)
        a = math.acos(max(-1.0, min(1.0, dot / norm)))
        if ux * vy - uy * vx < 0:
            a = -a
        return a

    theta1 = angle(1.0, 0.0, (x1p - cxp) / rx, (y1p - cyp) / ry)
    dtheta = angle((x1p - cxp) / rx, (y1p - cyp) / ry,
                   (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not sweep and dtheta > 0:
        dtheta -= 2 * math.pi
    elif sweep and dtheta < 0:
        dtheta += 2 * math.pi

    n_segs = max(1, int(math.ceil(abs(dtheta) / (math.pi / 2.0))))
    out = []
    for i in range(n_segs):
        t0 = theta1 + dtheta * i / n_segs
        t1 = theta1 + dtheta * (i + 1) / n_segs
        dt = t1 - t0
        # Cubic approximation of a unit-circle arc of sweep dt.
        k = 4.0 / 3.0 * math.tan(dt / 4.0)

        def on_ellipse(t):
            ct, st = math.cos(t), math.sin(t)
            return (cx + rx * cos_phi * ct - ry * sin_phi * st,
                    cy + rx * sin_phi * ct + ry * cos_phi * st)

        def deriv(t):
            ct, st = math.cos(t), math.sin(t)
            return (-rx * cos_phi * st - ry * sin_phi * ct,
                    -rx * sin_phi * st + ry * cos_phi * ct)

        s0, s1 = on_ellipse(t0), on_ellipse(t1)
        d0, d1 = deriv(t0), deriv(t1)
        c1 = (s0[0] + k * d0[0], s0[1] + k * d0[1])
        c2 = (s1[0] - k * d1[0], s1[1] - k * d1[1])
        out.append((c1, c2, s1))
    return out


def parse_svg_path(d: str) -> BezPath:  # noqa: C901 - a parser is a switch
    path = BezPath()
    tokens = list(_tokenize(d))
    pos = 0

    def take_nums(k: int) -> List[float]:
        nonlocal pos
        vals = []
        for _ in range(k):
            if pos >= len(tokens) or tokens[pos][0] != "num":
                raise SvgPathError(f"expected number at token {pos} in {d!r}")
            vals.append(tokens[pos][1])
            pos += 1
        return vals

    cur: Point = (0.0, 0.0)
    start: Point = (0.0, 0.0)
    last_cmd = ""
    last_ctrl: Point = cur  # reflection point for S/T

    while pos < len(tokens):
        kind, val = tokens[pos]
        if kind == "cmd":
            cmd = val
            pos += 1
        else:
            # Implicit command repeat; an implicit M becomes L (SVG spec).
            if last_cmd in ("M",):
                cmd = "L"
            elif last_cmd in ("m",):
                cmd = "l"
            elif last_cmd == "":
                raise SvgPathError(f"number before any command in {d!r}")
            else:
                cmd = last_cmd

        rel = cmd.islower()
        op = cmd.upper()

        def ap(x: float, y: float) -> Point:
            return (cur[0] + x, cur[1] + y) if rel else (x, y)

        if op == "M":
            x, y = take_nums(2)
            cur = ap(x, y)
            start = cur
            path.move_to(cur)
            last_ctrl = cur
        elif op == "L":
            x, y = take_nums(2)
            cur = ap(x, y)
            path.line_to(cur)
            last_ctrl = cur
        elif op == "H":
            (x,) = take_nums(1)
            cur = (cur[0] + x if rel else x, cur[1])
            path.line_to(cur)
            last_ctrl = cur
        elif op == "V":
            (y,) = take_nums(1)
            cur = (cur[0], cur[1] + y if rel else y)
            path.line_to(cur)
            last_ctrl = cur
        elif op == "C":
            x1, y1, x2, y2, x, y = take_nums(6)
            p1, p2, p3 = ap(x1, y1), ap(x2, y2), ap(x, y)
            path.curve_to(p1, p2, p3)
            last_ctrl = p2
            cur = p3
        elif op == "S":
            x2, y2, x, y = take_nums(4)
            if last_cmd.upper() in ("C", "S"):
                p1 = (2 * cur[0] - last_ctrl[0], 2 * cur[1] - last_ctrl[1])
            else:
                p1 = cur
            p2, p3 = ap(x2, y2), ap(x, y)
            path.curve_to(p1, p2, p3)
            last_ctrl = p2
            cur = p3
        elif op == "Q":
            x1, y1, x, y = take_nums(4)
            p1, p2 = ap(x1, y1), ap(x, y)
            path.quad_to(p1, p2)
            last_ctrl = p1
            cur = p2
        elif op == "T":
            x, y = take_nums(2)
            if last_cmd.upper() in ("Q", "T"):
                p1 = (2 * cur[0] - last_ctrl[0], 2 * cur[1] - last_ctrl[1])
            else:
                p1 = cur
            p2 = ap(x, y)
            path.quad_to(p1, p2)
            last_ctrl = p1
            cur = p2
        elif op == "A":
            rx, ry, rot, laf, swf, x, y = take_nums(7)
            p1 = ap(x, y)
            for (c1, c2, p3) in _arc_to_cubics(cur, rx, ry, rot,
                                               laf != 0.0, swf != 0.0, p1):
                path.curve_to(c1, c2, p3)
            cur = p1
            last_ctrl = cur
        elif op == "Z":
            path.close_path()
            cur = start
            last_ctrl = cur
        else:  # pragma: no cover
            raise SvgPathError(f"unknown command {cmd!r}")
        last_cmd = cmd
    return path
