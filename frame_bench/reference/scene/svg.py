"""SVG document -> Scene: the tiger loader.

Reimplements the reference's ``make_tiger`` (src/lib.rs:286-328) semantics:
the root's first element child (a ``<g>``) is scanned; each element child
with a ``d`` attribute becomes items.  ``fill`` attribute -> one Fill item
per flattened subpath; ``stroke`` attribute -> one StrokePolyLine per subpath
with ``stroke-width * scale`` and the thin-line fudge.  Attribute values are
read off the path element only (no CSS/inheritance), matching roxmltree use;
note this means a literal ``fill="none"`` renders as the magenta fallback
color -- a faithful reference quirk (src/lib.rs:383, one tiger path hits it).
"""

from __future__ import annotations

import os

import numpy as np
import xml.etree.ElementTree as ET
from ..config import TIGER_SCALE, TOLERANCE
from ..geometry import Affine, flatten_path, parse_svg_path
from .color import parse_color
from .scene import Scene, SceneBuilder

_ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
TIGER_PATH = os.path.abspath(os.path.join(_ASSETS, "Ghostscript_Tiger.svg"))


def _localname(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def load_svg_scene(svg_text: str, scale: float = 1.0,
                   tolerance: float = TOLERANCE) -> Scene:
    """Build a scene from an SVG document string (reference group layout)."""
    root = ET.fromstring(svg_text)
    group = None
    for child in root:
        group = child
        break
    if group is None:
        raise ValueError("svg document has no element children")

    xform = Affine.scale(scale)
    builder = SceneBuilder()
    builder.begin_group()
    for node in group:
        d = node.get("d")
        if d is None:
            continue
        try:
            bez = parse_svg_path(d)
        except ValueError:
            continue
        bez = bez.transform(xform)
        fill = node.get("fill")
        stroke = node.get("stroke")
        if fill is not None or stroke is not None:
            flattened = flatten_path(bez, tolerance)
        if fill is not None:
            # SVG fill-rule -> piet FillRule (extension; the reference
            # ignores the attribute and always renders nonzero).
            builder.fill_path(flattened, parse_color(fill),
                              even_odd=node.get("fill-rule") == "evenodd")
        if stroke is not None:
            # f32 multiply, as the reference does (src/lib.rs:319-320:
            # ``f32::from_str(..)? * (scale as f32)``).
            width = float(np.float32(node.get("stroke-width"))
                          * np.float32(scale))
            builder.stroke_path(flattened, width, parse_color(stroke))
    builder.end_group()
    return builder.build()


def make_tiger(scale: float = TIGER_SCALE,
               tolerance: float = TOLERANCE) -> Scene:
    """The Ghostscript Tiger demo scene at the given scale.

    Reference default is 8x => ~1600x1600 px (src/lib.rs:287).  For a W-px
    target, use ``scale = W / 200`` (the tiger viewBox is 200x200).
    """
    with open(TIGER_PATH, "r", encoding="utf-8") as f:
        return load_svg_scene(f.read(), scale=scale, tolerance=tolerance)
