"""General SVG document loader (beyond the reference's tiger subset).

The reference parses exactly the Ghostscript Tiger's structure: one flat
group of ``<path>`` elements with literal ``fill``/``stroke`` hex
attributes (src/lib.rs:286-328) -- faithfully mirrored by scene/svg.py,
quirks included.  This module is the piet-tpu EXTENSION for real-world
documents:

* recursive ``<g>`` traversal with presentation-attribute inheritance
  (fill, stroke, stroke-width, fill-rule, opacity, transform), both as
  attributes and inline ``style="..."``,
* ``transform`` lists: matrix / translate / scale / rotate / skewX/Y,
  composed down the tree; stroke widths scale by sqrt(|det|),
* shape elements: path, rect (incl. rounded), circle, ellipse, line,
  polyline, polygon,
* colors: ``#rgb``/``#rrggbb``, ``rgb(...)`` (ints or percents), the
  CSS basic named colors, ``none`` (properly skipped -- unlike the
  reference's magenta fallback), with fill-opacity/stroke-opacity folded
  into the alpha byte,
* group/element ``opacity`` -> a real compositing layer
  (SceneBuilder.push_layer -- the group-opacity extension),
* ``fill="url(#id)"`` 2-stop linear/radial gradients from ``<defs>``
  (mapped onto the gradient-brush extension; documents with more stops
  use the first and last, and SVG's elliptical radials are approximated
  by the average-axis circle).

The viewBox maps to pixels via ``scale`` (or ``target_width``), with the
viewBox origin translated to (0, 0).

Default paint follows the SVG spec (fill=black, stroke=none) rather than
the reference's attribute-presence test.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import TOLERANCE
from ..geometry import Affine, BezPath, flatten_path, parse_svg_path
from ..geometry.path import CurveTo, LineTo, MoveTo
from .scene import LinearGradient, RadialGradient, Scene, SceneBuilder

#: CSS basic color keywords (CSS 2.1 section 4.3.6) plus a few common
#: extended ones.
NAMED_COLORS = {
    "black": 0x000000, "silver": 0xC0C0C0, "gray": 0x808080,
    "grey": 0x808080, "white": 0xFFFFFF, "maroon": 0x800000,
    "red": 0xFF0000, "purple": 0x800080, "fuchsia": 0xFF00FF,
    "green": 0x008000, "lime": 0x00FF00, "olive": 0x808000,
    "yellow": 0xFFFF00, "navy": 0x000080, "blue": 0x0000FF,
    "teal": 0x008080, "aqua": 0x00FFFF, "orange": 0xFFA500,
    "brown": 0xA52A2A, "pink": 0xFFC0CB, "gold": 0xFFD700,
    "magenta": 0xFF00FF, "cyan": 0x00FFFF,
    "darkgray": 0xA9A9A9, "darkgrey": 0xA9A9A9,
    "lightgray": 0xD3D3D3, "lightgrey": 0xD3D3D3,
}

#: Cubic-arc circle constant: (4/3) tan(pi/8).
_KAPPA = 0.5522847498307936


def _localname(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _parse_len(v: Optional[str], default: float = 0.0,
               ref: float = 1.0) -> float:
    """Parse an SVG length; '%' resolves against ``ref``; units dropped."""
    if v is None:
        return default
    v = v.strip()
    if v.endswith("%"):
        return float(v[:-1]) / 100.0 * ref
    return float(re.sub(r"(px|pt|mm|cm|in|em)$", "", v))


def parse_color_full(value: str) -> Optional[int]:
    """SVG paint -> logical 0xRRGGBBAA, or None for 'none'.

    Unlike the reference-faithful scene/color.py::parse_color (magenta
    fallback, src/lib.rs:383), unknown colors here raise."""
    v = value.strip()
    if v == "none":
        return None
    if v.startswith("#"):
        h = v[1:]
        if len(h) == 3:
            h = "".join(c * 2 for c in h)
        if len(h) != 6:
            raise ValueError(f"unsupported hex color {value!r}")
        return (int(h, 16) << 8) | 0xFF
    m = re.match(r"rgb\(\s*([^)]*)\)", v)
    if m:
        parts = [p.strip() for p in m.group(1).split(",")]
        ch = []
        for p in parts:
            if p.endswith("%"):
                ch.append(int(round(float(p[:-1]) * 2.55)))
            else:
                ch.append(int(round(float(p))))
        r, g, b = (max(0, min(255, c)) for c in ch[:3])
        return (r << 24) | (g << 16) | (b << 8) | 0xFF
    if v.lower() in NAMED_COLORS:
        return (NAMED_COLORS[v.lower()] << 8) | 0xFF
    raise ValueError(f"unsupported color {value!r}")


_XFORM_RE = re.compile(r"(matrix|translate|scale|rotate|skewX|skewY)"
                       r"\s*\(([^)]*)\)")


def parse_transform(text: str) -> Affine:
    """Parse an SVG transform list into one Affine (left-to-right)."""
    out = Affine.identity()
    for name, argstr in _XFORM_RE.findall(text):
        args = [float(a) for a in re.split(r"[\s,]+", argstr.strip()) if a]
        if name == "matrix":
            t = Affine(tuple(args))
        elif name == "translate":
            tx = args[0]
            ty = args[1] if len(args) > 1 else 0.0
            t = Affine.translate(tx, ty)
        elif name == "scale":
            sx = args[0]
            sy = args[1] if len(args) > 1 else sx
            t = Affine((sx, 0.0, 0.0, sy, 0.0, 0.0))
        elif name == "rotate":
            t = Affine.rotate(math.radians(args[0]))
            if len(args) == 3:
                cx, cy = args[1], args[2]
                t = (Affine.translate(cx, cy) * t
                     * Affine.translate(-cx, -cy))
        elif name == "skewX":
            t = Affine((1.0, 0.0, math.tan(math.radians(args[0])),
                        1.0, 0.0, 0.0))
        else:  # skewY
            t = Affine((1.0, math.tan(math.radians(args[0])), 0.0,
                        1.0, 0.0, 0.0))
        out = out * t
    return out


def _shape_to_path(node) -> Optional[BezPath]:
    """Convert a shape element to a BezPath (None for non-shapes)."""
    tag = _localname(node.tag)
    g = node.get

    def f(name, default=0.0):
        return _parse_len(g(name), default)

    if tag == "path":
        d = g("d")
        return parse_svg_path(d) if d else None
    if tag == "rect":
        x, y, w, h = f("x"), f("y"), f("width"), f("height")
        if w <= 0 or h <= 0:
            return None
        rx = f("rx", 0.0) or f("ry", 0.0)
        ry = f("ry", 0.0) or rx
        rx, ry = min(rx, w / 2), min(ry, h / 2)
        els: List[object] = []
        if rx <= 0:
            els = [MoveTo((x, y)), LineTo((x + w, y)),
                   LineTo((x + w, y + h)), LineTo((x, y + h))]
        else:
            kx, ky = rx * _KAPPA, ry * _KAPPA
            els = [
                MoveTo((x + rx, y)), LineTo((x + w - rx, y)),
                CurveTo((x + w - rx + kx, y), (x + w, y + ry - ky),
                        (x + w, y + ry)),
                LineTo((x + w, y + h - ry)),
                CurveTo((x + w, y + h - ry + ky),
                        (x + w - rx + kx, y + h), (x + w - rx, y + h)),
                LineTo((x + rx, y + h)),
                CurveTo((x + rx - kx, y + h), (x, y + h - ry + ky),
                        (x, y + h - ry)),
                LineTo((x, y + ry)),
                CurveTo((x, y + ry - ky), (x + rx - kx, y), (x + rx, y)),
            ]
        return BezPath(els)
    if tag in ("circle", "ellipse"):
        cx, cy = f("cx"), f("cy")
        rx = f("r") if tag == "circle" else f("rx")
        ry = f("r") if tag == "circle" else f("ry")
        if rx <= 0 or ry <= 0:
            return None
        kx, ky = rx * _KAPPA, ry * _KAPPA
        els = [
            MoveTo((cx + rx, cy)),
            CurveTo((cx + rx, cy + ky), (cx + kx, cy + ry), (cx, cy + ry)),
            CurveTo((cx - kx, cy + ry), (cx - rx, cy + ky), (cx - rx, cy)),
            CurveTo((cx - rx, cy - ky), (cx - kx, cy - ry), (cx, cy - ry)),
            CurveTo((cx + kx, cy - ry), (cx + rx, cy - ky), (cx + rx, cy)),
        ]
        return BezPath(els)
    if tag == "line":
        return BezPath([MoveTo((f("x1"), f("y1"))),
                        LineTo((f("x2"), f("y2")))])
    if tag in ("polyline", "polygon"):
        raw = [float(v) for v in
               re.split(r"[\s,]+", (g("points") or "").strip()) if v]
        pts = list(zip(raw[0::2], raw[1::2]))
        if len(pts) < 2:
            return None
        els = [MoveTo(pts[0])] + [LineTo(p) for p in pts[1:]]
        if tag == "polygon":
            els.append(LineTo(pts[0]))
        return BezPath(els)
    return None


_INHERITED = ("fill", "stroke", "stroke-width", "fill-rule")


def _style_of(node, parent: Dict[str, str]) -> Dict[str, str]:
    """Resolve the node's effective presentation style."""
    st = {k: v for k, v in parent.items() if k in _INHERITED}
    for k in ("fill", "stroke", "stroke-width", "fill-rule", "opacity",
              "fill-opacity", "stroke-opacity", "display"):
        v = node.get(k)
        if v is not None:
            st[k] = v
    css = node.get("style")
    if css:
        for decl in css.split(";"):
            if ":" in decl:
                k, v = decl.split(":", 1)
                st[k.strip()] = v.strip()
    return st


def _scale_alpha(rgba: int, *opacities: float) -> int:
    a = rgba & 0xFF
    for o in opacities:
        a = int(a * max(0.0, min(1.0, o)))
    return (rgba & 0xFFFFFF00) | a


class _GradientDef:
    def __init__(self, node, ns_defs):
        self.kind = _localname(node.tag)  # linearGradient | radialGradient
        self.node = node
        self.units = node.get("gradientUnits", "objectBoundingBox")
        self.xform = parse_transform(node.get("gradientTransform", ""))
        # Stop resolution with href chaining (common in exported SVGs).
        stops = self._stops(node)
        href = (node.get("href")
                or node.get("{http://www.w3.org/1999/xlink}href"))
        if not stops and href and href.startswith("#"):
            ref = ns_defs.get(href[1:])
            if ref is not None:
                stops = self._stops(ref.node)
        self.stops = stops

    @staticmethod
    def _stops(node):
        out = []
        for ch in node:
            if _localname(ch.tag) != "stop":
                continue
            st = {k.strip(): v.strip() for k, v in
                  (d.split(":", 1) for d in (ch.get("style") or "").split(";")
                   if ":" in d)}
            color = ch.get("stop-color") or st.get("stop-color") or "#000"
            op = float(ch.get("stop-opacity")
                       or st.get("stop-opacity") or 1.0)
            rgba = parse_color_full(color)
            if rgba is None:
                rgba = 0x000000FF
            out.append(_scale_alpha(rgba, op))
        return out

    def brush(self, bbox: Tuple[float, float, float, float],
              xform: Affine, fill_opacity: float):
        """Resolve to a piet-tpu gradient brush in device space."""
        if not self.stops:
            return 0x000000FF
        c0 = _scale_alpha(self.stops[0], fill_opacity)
        c1 = _scale_alpha(self.stops[-1], fill_opacity)
        x0, y0, x1, y1 = bbox
        bw, bh = max(x1 - x0, 1e-6), max(y1 - y0, 1e-6)
        obb = self.units == "objectBoundingBox"

        def resolve(px, py):
            if obb:
                px, py = x0 + px * bw, y0 + py * bh
            return xform.apply(self.xform.apply((px, py)))

        g = self.node.get
        if self.kind == "linearGradient":
            p0 = resolve(_parse_len(g("x1"), 0.0), _parse_len(g("y1"), 0.0))
            p1 = resolve(_parse_len(g("x2"), 1.0), _parse_len(g("y2"), 0.0))
            return LinearGradient(p0, p1, c0, c1)
        cx = _parse_len(g("cx"), 0.5)
        cy = _parse_len(g("cy"), 0.5)
        r = _parse_len(g("r"), 0.5)
        center = resolve(cx, cy)
        # Circle radius under the composed (possibly non-uniform) map:
        # average-axis approximation (documented).
        ex = resolve(cx + r, cy)
        ey = resolve(cx, cy + r)
        rx = math.hypot(ex[0] - center[0], ex[1] - center[1])
        ry = math.hypot(ey[0] - center[0], ey[1] - center[1])
        # SVG radial gradients paint stop-1 OUTSIDE the circle (pad
        # spread); our brush clamps t the same way.
        return RadialGradient(center, 0.5 * (rx + ry), c0, c1)


def load_svg_document(svg_text: str, *, scale: Optional[float] = None,
                      target_width: Optional[int] = None,
                      tolerance: float = TOLERANCE) -> Scene:
    """Build a Scene from a general SVG document (see module doc)."""
    root = ET.fromstring(svg_text)
    vb = root.get("viewBox")
    if vb:
        minx, miny, vw, vh = (float(v) for v in
                              re.split(r"[\s,]+", vb.strip()))
    else:
        minx = miny = 0.0
        vw = _parse_len(root.get("width"), 512.0)
        vh = _parse_len(root.get("height"), 512.0)
    if scale is None:
        scale = (target_width / vw) if target_width else 1.0
    base = Affine.scale(scale) * Affine.translate(-minx, -miny)

    # Collect gradient defs anywhere in the document (two passes so
    # href chains resolve regardless of order).
    defs: Dict[str, _GradientDef] = {}
    for node in root.iter():
        if _localname(node.tag) in ("linearGradient", "radialGradient"):
            gid = node.get("id")
            if gid:
                defs[gid] = _GradientDef(node, defs)

    b = SceneBuilder()

    def paint_of(st: Dict[str, str], key: str, default: Optional[str]):
        return st.get(key, default)

    def emit(node, st: Dict[str, str], xform: Affine) -> None:
        path = _shape_to_path(node)
        if path is None or not path.elements:
            return
        flat = flatten_path(path.transform(xform), tolerance)
        flat = [sp for sp in flat if len(sp) >= 2]
        if not flat:
            return
        opacity = float(st.get("opacity", 1.0))
        fill_op = float(st.get("fill-opacity", 1.0))
        stroke_op = float(st.get("stroke-opacity", 1.0))
        layered = opacity < 1.0
        if layered:
            b.push_layer(opacity)
        fill = paint_of(st, "fill", "black")
        tag = _localname(node.tag)
        fillable = tag not in ("line", "polyline")
        if fill and fill != "none" and fillable:
            even_odd = st.get("fill-rule") == "evenodd"
            m = re.match(r"url\(#([^)]+)\)", fill)
            if m and m.group(1) in defs:
                pts = np.concatenate([np.asarray(sp) for sp in flat])
                # Gradient geometry resolves against the USER-SPACE
                # bbox of the whole shape (un-transform the flattened
                # device bbox is avoidable: recompute from path space).
                upts = np.concatenate(
                    [np.asarray(sp) for sp in
                     flatten_path(path, tolerance) or [[(0, 0), (0, 0)]]])
                bbox = (float(upts[:, 0].min()), float(upts[:, 1].min()),
                        float(upts[:, 0].max()), float(upts[:, 1].max()))
                brush = defs[m.group(1)].brush(bbox, xform, fill_op)
                del pts
                # The gradient brush uses nonzero winding (extension
                # limitation) -- documented approximation for evenodd.
                b.fill_path(flat, brush, even_odd=False, combined=True)
            else:
                rgba = parse_color_full(fill)
                if rgba is not None:
                    # combined=True: subpaths share one winding number,
                    # so holes render correctly under both fill rules.
                    b.fill_path(flat, _scale_alpha(rgba, fill_op),
                                even_odd=even_odd, combined=True)
        stroke = paint_of(st, "stroke", None)
        if stroke and stroke != "none":
            rgba = parse_color_full(stroke)
            if rgba is not None:
                sw = float(st.get("stroke-width", 1.0))
                a, bb, c, d = xform.coeffs[:4]
                sw *= math.sqrt(abs(a * d - bb * c))
                b.stroke_path(flat, sw, _scale_alpha(rgba, stroke_op))
        if layered:
            b.pop()

    def walk(node, st: Dict[str, str], xform: Affine) -> None:
        tag = _localname(node.tag)
        if tag in ("defs", "linearGradient", "radialGradient", "symbol",
                   "metadata", "title", "desc", "style", "clipPath",
                   "mask", "pattern"):
            return
        st = _style_of(node, st)
        if st.get("display") == "none":
            return
        t = node.get("transform")
        if t:
            xform = xform * parse_transform(t)
        if tag in ("svg", "g", "a", "switch"):
            opacity = float(st.pop("opacity", 1.0))
            layered = opacity < 1.0
            if layered:
                b.push_layer(opacity)
            for child in node:
                walk(child, st, xform)
            if layered:
                b.pop()
        else:
            emit(node, st, xform)

    walk(root, {}, base)
    return b.build()


def load_svg_file(path: str, **kw) -> Scene:
    with open(path, "r", encoding="utf-8") as f:
        return load_svg_document(f.read(), **kw)
