"""Scene representation, building, serialization and fixture scenes (numpy
host layer; copies of the ``piet_tpu/scene`` modules), plus the device
animation stages ``affine`` and ``animate`` (PyTorch, imported by
name)."""

from .color import (decode_color_linear, linear_to_srgb, parse_color,
                    srgb_to_linear, unpack_rgba)
from .scene import (Scene, SceneBuilder, TAG_CIRCLE, TAG_FILL, TAG_LINE,
                    TAG_POLY, quantize_bbox)
from .wire import decode_scene, encode_scene
from .fixtures import (get_scene, make_animated_frame, make_cardioid,
                       make_circles_rects, make_glyph_page, make_path_test,
                       make_random_beziers)
from .svg import load_svg_scene, make_tiger

__all__ = [
    "Scene", "SceneBuilder", "TAG_CIRCLE", "TAG_LINE", "TAG_FILL", "TAG_POLY",
    "quantize_bbox", "parse_color", "unpack_rgba", "srgb_to_linear",
    "linear_to_srgb", "decode_color_linear", "encode_scene", "decode_scene",
    "get_scene", "make_tiger", "load_svg_scene", "make_path_test",
    "make_cardioid", "make_circles_rects", "make_random_beziers",
    "make_glyph_page", "make_animated_frame",
]
