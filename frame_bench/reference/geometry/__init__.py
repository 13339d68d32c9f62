"""Host-side geometry: paths, Bezier flattening, SVG path parsing.

TPU-native equivalent of the reference's kurbo usage + src/flatten.rs.
"""

from .path import (Affine, BezPath, ClosePath, CurveTo, LineTo, MoveTo, Point,
                   QuadTo)
from .bezier import (cubic_eval, flatten_cubic, flatten_cubics_batch,
                     flatten_path, quad_count)
from .svg_path import SvgPathError, parse_svg_path

__all__ = [
    "Affine", "BezPath", "ClosePath", "CurveTo", "LineTo", "MoveTo", "Point",
    "QuadTo", "cubic_eval", "flatten_cubic", "flatten_cubics_batch",
    "flatten_path", "quad_count", "SvgPathError", "parse_svg_path",
]
