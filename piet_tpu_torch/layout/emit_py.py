"""Python emitter: DSL module -> layout descriptor dicts.

The Python-side counterpart of emit_cpp: produces, for each struct, its
size, per-field (offset, bit_shift, dtype) and enum tag values -- consumed
by the pure-Python wire codec tests and available for index arithmetic in
device code (the analog of the reference generating MSL accessors for its
kernels, piet-gpu-derive/src/lib.rs:70-98)."""

from __future__ import annotations

from typing import Any, Dict

from .dsl import Enum, Module, NP_TYPES, Ref, Scalar, Struct, Vector
from .packing import snake


def describe(module: Module) -> Dict[str, Any]:
    out: Dict[str, Any] = {"name": module.name, "structs": {}, "enums": {}}
    for d in module.defs:
        if isinstance(d, Struct):
            fields = {}
            for f in d.fields:
                if isinstance(f.ty, Scalar):
                    ty = NP_TYPES[f.ty.kind]
                    n = 1
                elif isinstance(f.ty, Vector):
                    ty = NP_TYPES[f.ty.elem.kind]
                    n = f.ty.n
                elif isinstance(f.ty, Ref):
                    ty = "u4"
                    n = 1
                else:
                    raise TypeError(f.ty)
                fields[f.name] = {
                    "offset": f.offset, "bit_shift": f.bit_shift,
                    "dtype": ty, "n": n,
                }
            out["structs"][d.name] = {
                "size": d.size + d.tag_offset,
                "tag_offset": d.tag_offset,
                "fields": fields,
                "size_macro": f"{snake(d.name)}_SIZE",
            }
        elif isinstance(d, Enum):
            out["enums"][d.name] = {
                "size": d.size,
                "tags": {v: d.first_tag + i
                         for i, (v, _) in enumerate(d.variants)},
            }
    return out
