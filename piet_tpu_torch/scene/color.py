"""Color handling: parsing and sRGB conversion.

Color convention throughout piet-tpu: a logical u32 ``0xRRGGBBAA``.  The
reference stores this same logical value byte-swapped (``rgba.to_be()``,
src/lib.rs:181,200) so that the little-endian GPU u32 has R in the low byte;
our SoA arrays keep the logical value and the wire-format serializer does the
byte swap (see scene/wire.py).

sRGB policy (must match the CPU golden rasterizer bit-for-bit): colors are
8-bit sRGB + linear alpha; blending happens in linear space after decode
(PietRender.metal:503 ``unpack_unorm4x8_srgb_to_half``); the final image is
re-encoded with the exact piecewise sRGB formula (PietRender.metal:563).
"""

from __future__ import annotations

import numpy as np

MAGENTA_FALLBACK = 0xFF00FF80  # non-hex colors (reference src/lib.rs:383)


def parse_color(color: str) -> int:
    """Parse an SVG color attribute to logical 0xRRGGBBAA.

    Matches reference src/lib.rs:375-385: ``#rgb`` nibbles are doubled,
    ``#rrggbb`` gets alpha 0xff appended, anything else becomes the
    magenta-ish debug fallback 0xff00ff80.
    """
    if color and color[0] == "#":
        hexval = int(color[1:], 16)
        if len(color) == 4:
            hexval = ((hexval >> 8) * 0x110000
                      + ((hexval >> 4) & 0xF) * 0x1100
                      + (hexval & 0xF) * 0x11)
        return ((hexval << 8) + 0xFF) & 0xFFFFFFFF
    return MAGENTA_FALLBACK


def unpack_rgba(color) -> tuple:
    """Logical 0xRRGGBBAA -> (r, g, b, a) channel bytes (ints or arrays)."""
    color = np.asarray(color, dtype=np.uint32)
    r = (color >> 24) & 0xFF
    g = (color >> 16) & 0xFF
    b = (color >> 8) & 0xFF
    a = color & 0xFF
    return r, g, b, a


def srgb_to_linear(u: np.ndarray) -> np.ndarray:
    """Decode sRGB-encoded [0,1] values to linear, float32.

    The exact unorm8-sRGB decode used by Metal's
    ``unpack_unorm4x8_srgb_to_half`` (IEC 61966-2-1): the inverse of
    `linear_to_srgb` below.
    """
    u = np.asarray(u, dtype=np.float32)
    lo = u / np.float32(12.92)
    hi = ((u + np.float32(0.055)) / np.float32(1.055)) ** np.float32(2.4)
    return np.where(u <= np.float32(0.04045), lo, hi).astype(np.float32)


def linear_to_srgb(v: np.ndarray) -> np.ndarray:
    """Encode linear [0,1] to sRGB, float32.

    Exactly the in-shader formula at PietRender.metal:563:
    ``select(1.055*pow(x, 1/2.4) - 0.055, 12.92*x, x < 0.0031308)``.
    """
    v = np.asarray(v, dtype=np.float32)
    lo = v * np.float32(12.92)
    hi = (np.float32(1.055) * np.power(v, np.float32(1.0 / 2.4))
          - np.float32(0.055))
    return np.where(v < np.float32(0.0031308), lo, hi).astype(np.float32)


def srgb_decode_table() -> np.ndarray:
    """The 256-entry u8-sRGB -> linear-f32 decode table.

    Decode is only ever applied to 8-bit codes, so piet-tpu defines it as a
    table computed in float64 and rounded once to float32 -- bit-identical
    across numpy, XLA and the C++ golden rasterizer by construction (a
    per-pixel f32 ``pow`` would differ in the last ulp between libm
    implementations).  The table is emitted into the generated C++ headers
    by the layout codegen (cc/gen/piet_srgb_gen.h).
    """
    u = np.arange(256, dtype=np.float64) / 255.0
    lo = u / 12.92
    hi = ((u + 0.055) / 1.055) ** 2.4
    return np.where(u <= 0.04045, lo, hi).astype(np.float32)


_SRGB_DECODE_TABLE = srgb_decode_table()


#: Canonical sRGB-encode polynomial coefficients (Horner order, highest
#: first), stored as exact f32 bit patterns.  PL approximates log2(m) over
#: m in [1, 2] (Chebyshev degree 8), PE approximates 2^f over f in [0, 1]
#: (degree 5); end-to-end curve error of the full f32 chain vs true sRGB
#: is < 4.4e-6 (~0.0011 of a u8 code), measured over 300k points.
_SRGB_PL_BITS = (0xbc11672d, 0x3df85f12, 0xbf3c26e2, 0x40265a14,
                 0xc0be1d92, 0x41133b6a, 0xc11f25ba, 0x41021532,
                 0xc05af24e)
_SRGB_PE_BITS = (0x3af86540, 0x3c129325, 0x3d64d0e6, 0x3e75e776,
                 0x3f317295, 0x3f7ffffe)
SRGB_PL = np.array(_SRGB_PL_BITS, np.uint32).view(np.float32)
SRGB_PE = np.array(_SRGB_PE_BITS, np.uint32).view(np.float32)


def linear_to_srgb_det(v: np.ndarray) -> np.ndarray:
    """Deterministic linear -> sRGB encode: the piet-tpu precision policy.

    Same piecewise curve as `linear_to_srgb`, but ``x^(1/2.4)`` is
    evaluated as ``2^(log2(x)/2.4)`` with the exponent/mantissa split done
    by BIT operations and both transcendentals by fixed-order Horner
    polynomials -- the chain uses ONLY multiply, add, floor, compare and
    bitcast.  f32 multiply/add are correctly rounded on every backend we
    target (numpy/x86, XLA:CPU with contraction barriers, and the TPU VPU
    -- pinned by tools/mosaic_numerics_probe.py), and floor/bitcast are
    exact, so numpy, the Pallas fine kernel and the C++ golden rasterizer
    are bit-identical BY CONSTRUCTION.

    The previous sqrt+Newton chain relied on device div/sqrt being
    IEEE-correctly rounded -- measured FALSE on TPU (round 4: both are
    <= 2 ulp off on ~34% of inputs; deterministic and shape-independent,
    but not equal to numpy), which flipped the u8 rounding of isolated
    boundary pixels (the round-3 32-row and gradient-demo divergences).

    Any change here must be mirrored in ops/cmd_math.py::srgb_encode_u32
    and the generated piet_srgb::encode (layout/emit_cpp.py).
    """
    f = np.float32
    shape = np.shape(v)
    v = np.ascontiguousarray(
        np.atleast_1d(np.clip(np.asarray(v, dtype=f), f(0.0), f(1.0))))
    lo = v * f(12.92)
    u = v.view(np.uint32)
    e = ((u >> 23).astype(np.int32) - 127).astype(f)
    m = ((u & 0x007FFFFF) | 0x3F800000).view(f)
    acc = np.full_like(m, SRGB_PL[0])
    for c in SRGB_PL[1:]:
        acc = acc * m + c
    t = (e + acc) * f(1.0 / 2.4)
    k = np.floor(t)
    fr = (t - k).astype(f)
    s = ((k.astype(np.int32) + 127) << 23).view(f)
    pe = np.full_like(fr, SRGB_PE[0])
    for c in SRGB_PE[1:]:
        pe = pe * fr + c
    hi = f(1.055) * (s * pe) - f(0.055)
    return np.where(v < f(0.0031308), lo, hi).astype(f).reshape(shape)


def srgb_encode_u8(v: np.ndarray) -> np.ndarray:
    """Deterministic linear f32 -> sRGB u8 (round-half-even, as jnp.round,
    np.round and C++ nearbyintf all implement)."""
    return np.round(linear_to_srgb_det(v) * np.float32(255.0)).astype(np.uint8)


def decode_color_linear(color) -> np.ndarray:
    """Logical color(s) -> float32 (..., 4) linear-RGB premul-ready values.

    RGB channels are sRGB-decoded; alpha stays linear ([0,1]).  This is the
    per-command decode the fine rasterizer applies
    (PietRender.metal:503,541,548) -- hoisted to encode/bin time in the TPU
    design since the result is command-constant.
    """
    r, g, b, a = unpack_rgba(color)
    rgb = _SRGB_DECODE_TABLE[np.stack([r, g, b], axis=-1)]
    alpha = np.asarray(a, dtype=np.float32)[..., None] / np.float32(255.0)
    return np.concatenate([rgb, alpha], axis=-1).astype(np.float32)
