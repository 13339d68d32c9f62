"""Layout DSL: single source of truth for packed GPU/wire struct layouts.

TPU-native equivalent of the reference's ``piet_gpu!`` proc-macro system
(piet-gpu-derive/src/lib.rs): you declare structs and tagged-union enums
once, and generators emit (a) a C++ header used by the native cc/ encoder,
and (b) Python descriptors (numpy dtypes + unpack index arithmetic) used by
the Python wire codec and tests.  This solves the same three-languages-
byte-agreement problem the reference solved for Rust/ObjC/MSL
(src/lib.rs:13 "Keep these in sync" -- the bug class C5 exists to kill).

Type system mirrors the reference DSL (piet-gpu-derive/src/lib.rs:29-68):
scalars i8/u8/i16/u16/i32/u32/f32, fixed vectors [T; N] (N <= 4), `Ref<T>`
(a u32 byte offset), inline structs, and enums as tag + max-sized body.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

SCALAR_SIZES = {
    "u8": 1, "i8": 1, "u16": 2, "i16": 2, "u32": 4, "i32": 4, "f32": 4,
}

CPP_TYPES = {
    "u8": "uint8_t", "i8": "int8_t", "u16": "uint16_t", "i16": "int16_t",
    "u32": "uint32_t", "i32": "int32_t", "f32": "float",
}

NP_TYPES = {
    "u8": "u1", "i8": "i1", "u16": "u2", "i16": "i2",
    "u32": "u4", "i32": "i4", "f32": "f4",
}


@dataclasses.dataclass(frozen=True)
class Scalar:
    kind: str  # one of SCALAR_SIZES

    @property
    def size(self) -> int:
        return SCALAR_SIZES[self.kind]


@dataclasses.dataclass(frozen=True)
class Vector:
    elem: Scalar
    n: int

    def __post_init__(self):
        if not (1 <= self.n <= 4):
            raise ValueError("vector arity must be 1..4")

    @property
    def size(self) -> int:
        return self.elem.size * self.n


@dataclasses.dataclass(frozen=True)
class Ref:
    """u32 byte offset to another type (piet-gpu-derive/src/lib.rs:909-919)."""
    target: str

    @property
    def size(self) -> int:
        return 4


FieldType = Union[Scalar, Vector, Ref, "StructRef"]


@dataclasses.dataclass(frozen=True)
class StructRef:
    """Inline use of a previously declared struct."""
    name: str
    size: int


@dataclasses.dataclass
class Field:
    name: str
    ty: FieldType
    # Filled by the packer:
    offset: int = -1         # byte offset in the packed struct
    bit_shift: int = 0       # for sub-word fields sharing a u32


@dataclasses.dataclass
class Struct:
    name: str
    fields: List[Field]
    size: int = 0            # filled by the packer
    tag_offset: int = 0      # 4 when embedded in an enum (lib.rs:651-654)


@dataclasses.dataclass
class Enum:
    """Tagged union: u32 tag + body sized to the largest variant
    (piet-gpu-derive/src/lib.rs:1128-1139).  Tag values are declaration
    order, starting at ``first_tag``."""
    name: str
    variants: List[Tuple[str, Optional[str]]]  # (variant, struct name|None)
    first_tag: int = 1
    size: int = 0


@dataclasses.dataclass
class Module:
    name: str
    defs: List[Union[Struct, Enum]]

    def struct(self, name: str) -> Struct:
        for d in self.defs:
            if isinstance(d, Struct) and d.name == name:
                return d
        raise KeyError(name)

    def enum(self, name: str) -> Enum:
        for d in self.defs:
            if isinstance(d, Enum) and d.name == name:
                return d
        raise KeyError(name)


# Convenience constructors.
u8, i8 = Scalar("u8"), Scalar("i8")
u16, i16 = Scalar("u16"), Scalar("i16")
u32, i32, f32 = Scalar("u32"), Scalar("i32"), Scalar("f32")


def vec(elem: Scalar, n: int) -> Vector:
    return Vector(elem, n)
