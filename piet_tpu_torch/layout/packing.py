"""Word packing: assign byte offsets / bit shifts to DSL fields.

Replicates the reference packer's semantics (piet-gpu-derive/src/lib.rs:
377-411 ``PackedField::pack``): fields are packed greedily into 4-byte
words; a sub-word field is placed at the next free bit offset in the current
word, and the word is closed when the next field does not fit.  Word-sized
and larger fields start on a fresh word.  Enums become a u32 tag plus a body
sized to the largest variant; structs embedded in enums carry a 4-byte tag
offset (lib.rs:651-654, doc comment :3-5).
"""

from __future__ import annotations

from typing import Dict, List

from .dsl import Enum, Field, Module, Ref, Scalar, Struct, StructRef, Vector


def _field_size(ty) -> int:
    return ty.size


def pack_struct(struct: Struct, base_offset: int = 0) -> None:
    """Assign offsets in place; sets ``struct.size`` (excluding tag_offset)."""
    offset = base_offset
    bit = 0  # bit position within the currently open word (0 = none open)
    for f in struct.fields:
        size = _field_size(f.ty)
        if size >= 4 or isinstance(f.ty, (Ref, StructRef)):
            # Close any open word.
            if bit:
                offset += 4
                bit = 0
            # Word-or-larger fields honor natural (power-of-two, max 16)
            # alignment -- this reproduces the reference ptcl layouts where
            # e.g. CmdCircle's ushort4 bbox sits at offset 8 after a 4-byte
            # tag (GenTypes.h:340-343) and float2 pairs are 8-aligned.
            align = 1
            while align < size and align < 16:
                align *= 2
            offset = -(-offset // align) * align
            f.offset = offset
            f.bit_shift = 0
            offset += (size + 3) // 4 * 4
        else:
            sub_bits = size * 8
            if isinstance(f.ty, Vector) and f.ty.size < 4:
                sub_bits = f.ty.size * 8
            if bit + sub_bits > 32:
                offset += 4
                bit = 0
            f.offset = offset
            f.bit_shift = bit
            bit += sub_bits
            if bit == 32:
                offset += 4
                bit = 0
    if bit:
        offset += 4
    struct.size = offset - base_offset


def pack_module(module: Module) -> Module:
    """Pack all defs; enum sizes = 4 + max variant size, rounded to words."""
    sizes: Dict[str, int] = {}
    for d in module.defs:
        if isinstance(d, Struct):
            pack_struct(d, base_offset=d.tag_offset)
            sizes[d.name] = d.size + d.tag_offset
    for d in module.defs:
        if isinstance(d, Enum):
            body = 0
            for _, payload in d.variants:
                if payload is not None:
                    body = max(body, sizes[payload])
            # Tag shares the variant's 4-byte tag slot (variants are packed
            # with tag_offset=4), so the enum size is just the max variant
            # footprint, min 4 for the tag itself.
            d.size = max(body, 4)
            sizes[d.name] = d.size
    return module


def snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i and (not name[i - 1].isupper()):
            out.append("_")
        out.append(ch.upper())
    return "".join(out)
