"""The scene and ptcl layout modules.

Declares the same wire layouts as the reference's codegen driver
(src/main.rs:11-48 scene module, :50-93 ptcl module), with the hand-fixups
the reference applied afterwards baked in (tag values start at 1,
GenTypes.h:324-328 "TODO: these are manually fixed up").
"""

from __future__ import annotations

from .dsl import Enum, Field, Module, Ref, Struct, f32, i32, u16, u32, vec
from .packing import pack_module


def _s(name, fields, tag_offset=0):
    return Struct(name, [Field(n, t) for n, t in fields],
                  tag_offset=tag_offset)


def scene_module() -> Module:
    m = Module("scene", [
        _s("SimpleGroup", [
            ("n_items", u32),
            ("items_ix", Ref("PietItem")),
            ("bbox", vec(u16, 4)),
        ]),
        # Variant structs carry a 4-byte tag offset (embedded in PietItem).
        # Reference variants 1-4.  Fields past the reference's layout
        # (flags on Circle/Poly, clip_ix / grad_ix byte refs) ride words the
        # reference zero-fills, so reference scenes encode byte-identically
        # (a ref of 0 -- the group header -- means "absent").
        _s("PietCircle", [
            ("flags", u32),
            ("clip_ix", Ref("f32")),
        ], tag_offset=4),
        _s("PietStrokeLine", [
            ("flags", u32),
            ("rgba_color", u32),
            ("width", f32),
            ("start", vec(f32, 2)),
            ("end", vec(f32, 2)),
        ], tag_offset=4),
        _s("PietFill", [
            ("flags", u32),
            ("rgba_color", u32),
            ("n_points", u32),
            ("points_ix", Ref("f32")),
            ("grad_ix", Ref("f32")),
            ("clip_ix", Ref("f32")),
        ], tag_offset=4),
        _s("PietStrokePolyLine", [
            ("rgba_color", u32),
            ("width", f32),
            ("n_points", u32),
            ("points_ix", Ref("f32")),
            ("flags", u32),
            ("clip_ix", Ref("f32")),
        ], tag_offset=4),
        # Extension variants 5-8 (piet-tpu items beyond the reference's
        # four: clip/layer groups, and a rect-clipped line whose inline
        # layout has no free word -- its points spill out-of-line).
        _s("PietClip", [
            ("flags", u32),
            ("n_points", u32),
            ("points_ix", Ref("f32")),
        ], tag_offset=4),
        _s("PietPop", [
            ("flags", u32),
            ("alpha", f32),
        ], tag_offset=4),
        _s("PietLayer", [
            ("flags", u32),
            ("alpha", f32),
        ], tag_offset=4),
        _s("PietLineExt", [
            ("flags", u32),
            ("rgba_color", u32),
            ("width", f32),
            ("points_ix", Ref("f32")),
            ("clip_ix", Ref("f32")),
        ], tag_offset=4),
        Enum("PietItem", [
            ("Circle", "PietCircle"),
            ("Line", "PietStrokeLine"),
            ("Fill", "PietFill"),
            ("Poly", "PietStrokePolyLine"),
            ("Clip", "PietClip"),
            ("Pop", "PietPop"),
            ("Layer", "PietLayer"),
            ("LineExt", "PietLineExt"),
        ], first_tag=1),
    ])
    return pack_module(m)


def ptcl_module() -> Module:
    m = Module("ptcl", [
        _s("CmdCircle", [("bbox", vec(u16, 4))], tag_offset=4),
        _s("CmdLine", [("start", vec(f32, 2)), ("end", vec(f32, 2))],
           tag_offset=4),
        _s("CmdStroke", [("halfWidth", f32), ("rgba_color", u32)],
           tag_offset=4),
        _s("CmdFill", [("start", vec(f32, 2)), ("end", vec(f32, 2))],
           tag_offset=4),
        _s("CmdFillEdge", [("sign", i32), ("y", f32)], tag_offset=4),
        _s("CmdDrawFill", [("backdrop", i32), ("rgba_color", u32)],
           tag_offset=4),
        _s("CmdSolid", [("rgba_color", u32)], tag_offset=4),
        Enum("Cmd", [
            ("End", None),
            ("Circle", "CmdCircle"),
            ("Line", "CmdLine"),
            ("Fill", "CmdFill"),
            ("Stroke", "CmdStroke"),
            ("FillEdge", "CmdFillEdge"),
            ("DrawFill", "CmdDrawFill"),
            ("Solid", "CmdSolid"),
            ("Bail", None),
        ], first_tag=1),
    ])
    return pack_module(m)
