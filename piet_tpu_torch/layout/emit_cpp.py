"""C++ emitter: DSL module -> header with packed accessors.

The role GenTypes.h plays for the reference's Metal kernels
(piet-gpu-derive/src/lib.rs:630-833 generates per-struct ``_read`` /
per-field accessors / ``_write``), retargeted at C++: byte-buffer readers
and writers over ``const char* buf`` used by the native cc/ scene codec.
Unlike the reference (whose generated output was pasted into the tree and
hand-fixed, GenTypes.h:3,324), generation is fully automated and golden-
tested; ``cc/gen/`` is regenerated by ``python -m piet_tpu.layout``.
"""

from __future__ import annotations

from typing import List

from .dsl import CPP_TYPES, Enum, Module, Ref, Scalar, Struct, Vector
from .packing import snake


def _cpp_type(ty) -> str:
    if isinstance(ty, Scalar):
        return CPP_TYPES[ty.kind]
    if isinstance(ty, Vector):
        return f"std::array<{CPP_TYPES[ty.elem.kind]}, {ty.n}>"
    if isinstance(ty, Ref):
        return "uint32_t"
    raise TypeError(ty)


def _read_expr(ty, off: int, shift: int) -> str:
    if isinstance(ty, Scalar):
        if ty.size < 4:
            mask = (1 << (ty.size * 8)) - 1
            base = f"(load_u32(buf, ref + {off & ~3}) >> {shift}) & {mask}u"
            return f"({CPP_TYPES[ty.kind]})({base})"
        return f"load<{CPP_TYPES[ty.kind]}>(buf, ref + {off})"
    if isinstance(ty, Vector):
        elems = []
        esz = ty.elem.size
        for k in range(ty.n):
            eoff = off + k * esz
            elems.append(_read_expr(ty.elem, eoff, (eoff % 4) * 8))
        inner = ", ".join(elems)
        return f"{_cpp_type(ty)}{{{{{inner}}}}}"
    if isinstance(ty, Ref):
        return f"load<uint32_t>(buf, ref + {off})"
    raise TypeError(ty)


def _write_stmts(ty, off: int, value: str) -> List[str]:
    if isinstance(ty, Scalar):
        if ty.size < 4:
            # Sub-word writes are read-modify-write on the containing u32.
            mask = (1 << (ty.size * 8)) - 1
            shift = (off % 4) * 8
            word = off & ~3
            return [f"store_u32(buf, ref + {word}, "
                    f"(load_u32(buf, ref + {word}) & ~({mask}u << {shift})) |"
                    f" ((uint32_t({value}) & {mask}u) << {shift}));"]
        return [f"store<{CPP_TYPES[ty.kind]}>(buf, ref + {off}, {value});"]
    if isinstance(ty, Vector):
        out = []
        for k in range(ty.n):
            out += _write_stmts(ty.elem, off + k * ty.elem.size,
                                f"{value}[{k}]")
        return out
    if isinstance(ty, Ref):
        return [f"store<uint32_t>(buf, ref + {off}, {value});"]
    raise TypeError(ty)


PRELUDE = """\
// Generated by piet_tpu.layout -- DO NOT EDIT.
// Single source of truth: piet_tpu/layout/modules.py.
#pragma once
#include <array>
#include <cstdint>
#include <cstring>

namespace piet {

#ifndef PIET_LAYOUT_PRELUDE_
#define PIET_LAYOUT_PRELUDE_
template <typename T>
inline T load(const char* buf, uint32_t ref) {
  T v;
  std::memcpy(&v, buf + ref, sizeof(T));
  return v;
}
inline uint32_t load_u32(const char* buf, uint32_t ref) {
  return load<uint32_t>(buf, ref);
}
template <typename T>
inline void store(char* buf, uint32_t ref, T v) {
  std::memcpy(buf + ref, &v, sizeof(T));
}
inline void store_u32(char* buf, uint32_t ref, uint32_t v) {
  store<uint32_t>(buf, ref, v);
}
#endif  // PIET_LAYOUT_PRELUDE_
"""


def emit_cpp(module: Module) -> str:
    out = [PRELUDE, f"// ---- module {module.name} ----\n"]
    for d in module.defs:
        if isinstance(d, Struct):
            total = d.size + d.tag_offset
            out.append(f"struct {d.name} {{")
            for f in d.fields:
                out.append(f"  {_cpp_type(f.ty)} {f.name};")
            out.append("};")
            out.append(f"constexpr uint32_t {snake(d.name)}_SIZE = {total};\n")
            out.append(f"inline {d.name} {d.name}_read(const char* buf, "
                       "uint32_t ref) {")
            if not d.fields:
                out.append("  (void)buf; (void)ref;")
            out.append(f"  {d.name} r{{}};")
            for f in d.fields:
                out.append(
                    f"  r.{f.name} = {_read_expr(f.ty, f.offset, f.bit_shift)};")
            out.append("  return r;")
            out.append("}")
            for f in d.fields:
                out.append(
                    f"inline {_cpp_type(f.ty)} {d.name}_{f.name}"
                    "(const char* buf, uint32_t ref) {"
                    f" return {_read_expr(f.ty, f.offset, f.bit_shift)}; }}")
            out.append(f"inline void {d.name}_write(char* buf, uint32_t ref, "
                       f"const {d.name}& s) {{")
            if not d.fields:
                out.append("  (void)buf; (void)ref; (void)s;")
            for f in d.fields:
                for st in _write_stmts(f.ty, f.offset, f"s.{f.name}"):
                    out.append("  " + st)
            out.append("}\n")
        elif isinstance(d, Enum):
            out.append(f"constexpr uint32_t {snake(d.name)}_SIZE = {d.size};")
            for i, (vname, _) in enumerate(d.variants):
                out.append(f"constexpr uint32_t {d.name}_{vname} = "
                           f"{d.first_tag + i};")
            out.append(
                f"inline uint32_t {d.name}_tag(const char* buf, "
                "uint32_t ref) { return load_u32(buf, ref); }")
            out.append(
                f"inline void {d.name}_write_tag(char* buf, uint32_t ref, "
                "uint32_t tag) { store_u32(buf, ref, tag); }\n")
    out.append("}  // namespace piet")
    return "\n".join(out) + "\n"


def emit_srgb_header() -> str:
    """Emit the sRGB decode table + deterministic encode as a C++ header.

    The decode table is computed in float64 on the Python side and emitted
    as exact f32 bit patterns, and the encode algorithm mirrors
    scene/color.py::linear_to_srgb_det operation-for-operation, so the C++
    golden rasterizer is bit-identical to the numpy oracle and the Pallas
    kernel (which requires -ffp-contract=off, set in cc/Makefile).
    """
    import numpy as np

    from ..scene.color import srgb_decode_table

    from ..scene.color import SRGB_PE, SRGB_PL

    bits = srgb_decode_table().view(np.uint32)
    rows = []
    for i in range(0, 256, 6):
        rows.append("    " + ", ".join(f"0x{b:08x}u" for b in bits[i:i + 6])
                    + ",")
    table = "\n".join(rows)
    pl_bits = "    " + ", ".join(f"0x{b:08x}u"
                                 for b in SRGB_PL.view(np.uint32))
    pe_bits = "    " + ", ".join(f"0x{b:08x}u"
                                 for b in SRGB_PE.view(np.uint32))
    n_pl, n_pe = len(SRGB_PL), len(SRGB_PE)
    return f"""// Generated by python -m piet_tpu.layout; do not edit.
// sRGB decode table + deterministic encode (see piet_tpu/scene/color.py).
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>

namespace piet_srgb {{

// u8 sRGB code -> linear f32, computed in float64 and rounded once
// (bit-exact across numpy / XLA / C++ by construction).
inline const uint32_t kDecodeBits[256] = {{
{table}
}};

inline float decode(uint32_t code) {{
  float v;
  uint32_t b = kDecodeBits[code & 0xFF];
  std::memcpy(&v, &b, 4);
  return v;
}}

// Deterministic linear -> sRGB encode: x^(1/2.4) as 2^(log2(x)/2.4) with
// a bit-level exponent/mantissa split and polynomial log2/exp2 -- only
// mul/add/floor/compare/bitcast, all exactly rounded and identical across
// numpy / TPU / C++ (device sqrt/div are NOT IEEE-correctly rounded; see
// scene/color.py::linear_to_srgb_det).  Mirrors that function
// operation-for-operation -- keep the order identical (and
// -ffp-contract=off, set in cc/Makefile).
inline const uint32_t kLogPolyBits[{n_pl}] = {{
{pl_bits}
}};
inline const uint32_t kExpPolyBits[{n_pe}] = {{
{pe_bits}
}};

inline float encode(float v) {{
  v = std::min(std::max(v, 0.0f), 1.0f);
  float lo = v * 12.92f;
  uint32_t u;
  std::memcpy(&u, &v, 4);
  float e = (float)((int32_t)(u >> 23) - 127);
  uint32_t mb = (u & 0x007FFFFFu) | 0x3F800000u;
  float m;
  std::memcpy(&m, &mb, 4);
  float c, acc;
  std::memcpy(&acc, &kLogPolyBits[0], 4);
  for (int i = 1; i < {n_pl}; ++i) {{
    std::memcpy(&c, &kLogPolyBits[i], 4);
    acc = acc * m + c;
  }}
  float t = (e + acc) * (1.0f / 2.4f);
  float k = std::floor(t);
  float fr = t - k;
  uint32_t sb = (uint32_t)(((int32_t)k + 127) << 23);
  float s;
  std::memcpy(&s, &sb, 4);
  float pe;
  std::memcpy(&pe, &kExpPolyBits[0], 4);
  for (int i = 1; i < {n_pe}; ++i) {{
    std::memcpy(&c, &kExpPolyBits[i], 4);
    pe = pe * fr + c;
  }}
  float hi = 1.055f * (s * pe) - 0.055f;
  return v < 0.0031308f ? lo : hi;
}}

// Linear f32 -> u8 code (round-half-even, matching np.round / jnp.round).
inline uint8_t encode_u8(float v) {{
  return (uint8_t)(int)std::nearbyintf(encode(v) * 255.0f);
}}

}}  // namespace piet_srgb
"""
