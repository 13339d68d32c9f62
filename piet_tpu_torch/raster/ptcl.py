"""PTCL: per-tile command lists, as fixed-shape arrays.

The reference streams variable-length 24-byte commands into a 4096-byte
byte buffer per tile (TileEncoder, PietRender.metal:69-157).  The TPU-native
representation is capacity-padded dense arrays -- directly consumable by a
Pallas kernel with one tile per grid step:

  tags   (T, CAP)    int32   command tag per slot (reference tag values)
  args   (T, CAP, 8) float32 command operands (layouts below)
  counts (T,)        int32   live commands per tile
  solid  (T,)        uint32  bail color (logical 0xRRGGBBAA); 0 = no bail
  overflow (T,)      int32   commands dropped per tile (the reference's
                             unhandled-overflow deficiency, made detectable)

Tag values match the reference PTCL exactly (GenTypes.h:440-495):
  End=1 Circle=2 Line=3 Fill=4 Stroke=5 FillEdge=6 DrawFill=7 Solid=8 Bail=9
(End/Bail never appear in the arrays -- `counts`/`solid` carry that state --
but the numbering is preserved for parity tooling.)

Arg layouts (f32 words; colors are pre-decoded to linear RGB + alpha, a
command-constant computation the reference redid per pixel,
PietRender.metal:503,541,548).  Words 8-11 of every DRAW command carry the
item's clip rectangle (piet clip extension; the no-clip default rect is
huge, making the coverage multiply an exact *1.0):
  Circle   [x0, y0, x1, y1, -, -, -, -, cx0, cy0, cx1, cy1]
  Line     [x0, y0, x1, y1, hw+0.5, inv_denom]
  Fill     [x0, y0, y1, m, K]
  Stroke   [halfWidth, r, g, b, a, -, -, -, cx0, cy0, cx1, cy1]
  FillEdge [sign, y]
  DrawFill [backdrop, r, g, b, a, even_odd, -, -, cx0, cy0, cx1, cy1]
  Solid    [r, g, b, a, -, -, -, -, cx0, cy0, cx1, cy1]

The Line/Fill per-command constants (round 5, the division-free fine
math -- ops/cmd_math.py module doc): inv_denom = div_det(1, |v|^2)
(+inf for zero-length segments), m = div_det(x1-x0, y1-y0) (x slope per
unit y), K = div_det(-(y1-y0), |x1-x0|) (window Jacobian carrying the
winding sign).  All three ride ``div_det_np`` -- the numpy mirror of the
device's exact-residual division selection -- so coarse outputs and the
oracle agree bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..scene.color import decode_color_linear

CMD_END = 1
CMD_CIRCLE = 2
CMD_LINE = 3
CMD_FILL = 4
CMD_STROKE = 5
CMD_FILL_EDGE = 6
CMD_DRAW_FILL = 7
CMD_SOLID = 8
CMD_BAIL = 9
# -- extension commands (clip/layer groups; no reference analog) --------
CMD_BEGIN_CLIP = 10   # [backdrop, even_odd]: area -> clip coverage, push
CMD_END_CLIP = 11     # []: pop the clip stack
CMD_BEGIN_LAYER = 12  # []: push the rgb state (group opacity layer)
CMD_END_LAYER = 13    # [alpha]: composite pushed vs current rgb
# -- gradient resolves (2-stop brush extension; see scene.LinearGradient).
# Payload uses ALL 12 arg words, so gradient draws carry no rect clip
# (arbitrary clip GROUPS still apply) and use nonzero winding:
#   [backdrop, g0, g1, g2, c0r, c0g, c0b, c0a, c1r, c1g, c1b, c1a]
# where (g0,g1,g2) = (gx,gy,gofs) linear (t = gx*x + gy*y + gofs) or
# (cx,cy,1/r) radial (t = |p - c| / r), precomputed on host in f32.
CMD_DRAW_LIN_GRAD = 14
CMD_DRAW_RAD_GRAD = 15
# -- winding carry (multi-subpath fill extension; scene.FLAG_FILL_CONT).
# [backdrop]: area += backdrop, NO resolve -- a non-final subpath's
# interior winding rides into the group's final DrawFill, giving real
# hole support (the reference encodes one Fill per subpath and cannot
# represent holes, src/lib.rs:342-347).  Like CMD_FILL, it does not
# touch bail state.
CMD_WIND = 16

ARG_WORDS = 12

#: "No clip" rectangle: huge bounds make the clip-coverage multiply an
#: exact *1.0 (X+1 - X is exact in f32 for viewport coordinates).
NO_CLIP = (-1e9, -1e9, 1e9, 1e9)

_F = np.float32


def div_det_np(a, b):
    """Numpy mirror of ops/cmd_math.py::div_det (bitwise; see there).

    Seeded with numpy's IEEE quotient; the exact-residual candidate
    selection is seed-independent, so this returns the same bits as the
    device's rcp-seeded selection for every (a, b).  Vectorized over
    arrays; scalar inputs return a python float."""
    a_arr = np.atleast_1d(np.asarray(a, _F))
    b_arr = np.atleast_1d(np.asarray(b, _F))
    a_arr, b_arr = np.broadcast_arrays(a_arr, b_arr)
    a_arr = np.ascontiguousarray(a_arr, _F)
    b_arr = np.ascontiguousarray(b_arr, _F)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        q0 = a_arr / b_arr
        cb = b_arr * _F(4097.0)
        bh = cb - (cb - b_arr)
        bl = b_arr - bh
        u0 = q0.view(np.uint32)
        best_q = q0.copy()
        best_r = np.full_like(q0, np.inf)
        best_even = np.zeros(q0.shape, bool)
        for delta in (-3, -2, -1, 0, 1, 2, 3):
            q = (u0 + np.uint32(delta & 0xFFFFFFFF)).view(_F)
            cq = q * _F(4097.0)
            qh = cq - (cq - q)
            ql = q - qh
            r = np.abs((((a_arr - qh * bh) - qh * bl) - ql * bh) - ql * bl)
            even = (q.view(np.uint32) & np.uint32(1)) == 0
            take = (r < best_r) | ((r == best_r) & even & ~best_even)
            best_q = np.where(take, q, best_q)
            best_even = np.where(take, even, best_even)
            best_r = np.where(take, r, best_r)
        ok = (b_arr != 0.0) & np.isfinite(q0)
        out = np.where(ok, best_q, q0).astype(_F)
    if np.ndim(a) == 0 and np.ndim(b) == 0:
        return float(out[0])
    return out.reshape(np.broadcast_shapes(np.shape(a), np.shape(b)))


def dot2_det_np(x, y):
    """Numpy mirror of ops/cmd_math.py::dot2_det (see there)."""
    x = np.asarray(x, _F)
    y = np.asarray(y, _F)

    def sq(v):
        c = v * _F(4097.0)
        h = c - (c - v)
        l = v - h
        return h * h, _F(2.0) * (h * l), l * l

    with np.errstate(over="ignore", invalid="ignore"):
        xh, xm, xl = sq(x)
        yh, ym, yl = sq(y)
        return ((xh + xm) + xl) + ((yh + ym) + yl)


@dataclasses.dataclass
class Ptcl:
    """Dense per-tile command lists for a (tiles_y, tiles_x) grid."""

    tags: np.ndarray      # (T, CAP) int32
    args: np.ndarray      # (T, CAP, 8) float32
    counts: np.ndarray    # (T,) int32
    solid: np.ndarray     # (T,) uint32
    overflow: np.ndarray  # (T,) int32

    @property
    def n_tiles(self) -> int:
        return int(self.tags.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.tags.shape[1])

    def tile_commands(self, t: int) -> List[Tuple[int, np.ndarray]]:
        """Decoded (tag, args) list for one tile -- for tests/debugging."""
        n = int(self.counts[t])
        return [(int(self.tags[t, i]), self.args[t, i].copy())
                for i in range(n)]


class TileCmdEncoder:
    """Python-side equivalent of the reference TileEncoder
    (PietRender.metal:69-157), used by the CPU golden tiler.

    Replicates the solid-tile optimization exactly: an *opaque* CmdSolid
    resets the write cursor (everything beneath is occluded) and records the
    bail color; any other draw command clears the bail state.  A translucent
    CmdSolid does NOT clear previously-recorded bail state -- a faithful
    reference quirk (PietRender.metal:127-142: only the opaque branch touches
    ``solidColor``; draws clear it, translucent solids don't).
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.cmds: List[Tuple[int, List[float]]] = []
        # Background: opaque white (PietRender.metal:74).
        self.solid_color: int = 0xFFFFFFFF
        self.overflow: int = 0

    def _push(self, tag: int, args: List[float]) -> None:
        if len(self.cmds) >= self.capacity:
            self.overflow += 1
            return
        self.cmds.append((tag, args))

    @staticmethod
    def _rgba_linear(rgba: int) -> List[float]:
        return [float(v) for v in decode_color_linear(np.uint32(rgba))]

    def circle(self, bbox, clip=NO_CLIP) -> None:
        self.solid_color = 0
        self._push(CMD_CIRCLE, [float(v) for v in bbox] + [0.0] * 4
                   + [float(v) for v in clip])

    def line(self, x0: float, y0: float, x1: float, y1: float,
             ycull: float = 0.0, inv_denom=None) -> None:
        """``ycull``: the emitting stroke's hw + 0.5 in arg word 4 --
        unused by the fine math, consumed by the Pallas kernel's row cull
        (ops/fine.py footprint restriction).  Word 5 is the per-SEGMENT
        inverse squared length (division-free fine math; module doc) --
        passed in by the tiler (computed once per segment), or derived
        here from the endpoints when omitted."""
        self.solid_color = 0
        if inv_denom is None:
            lvx = _F(x1) - _F(x0)
            lvy = _F(y1) - _F(y0)
            inv_denom = div_det_np(1.0, dot2_det_np(lvx, lvy))
        self._push(CMD_LINE, [float(x0), float(y0), float(x1), float(y1),
                              float(ycull), float(inv_denom)])

    def stroke(self, rgba: int, width: float, clip=NO_CLIP) -> None:
        self.solid_color = 0
        hw = float(np.float32(0.5) * np.float32(width))
        self._push(CMD_STROKE, [hw] + self._rgba_linear(rgba) + [0.0] * 3
                   + [float(v) for v in clip])

    def fill(self, x0: float, y0: float, x1: float, y1: float,
             m=None, K=None) -> None:
        # Fill coverage commands don't clear bail state by themselves
        # (TileEncoder.encodeFill leaves solidColor untouched,
        # PietRender.metal:102-109); the DrawFill that follows does.
        # Operands are [sx, sy, ey, m, K] -- the endpoint pair reduced to
        # the per-SEGMENT constants of the division-free trapezoid math
        # (ops/cmd_math.py::fill_delta), passed in by the tiler (the slope
        # of a clipped sub-segment is the SEGMENT's slope -- one shared
        # definition), or derived from the endpoints when omitted.
        # Degenerate segments (dy == 0: masked everywhere; dx == 0: the
        # degenerate-column guard path, which reads neither constant)
        # carry zeroed constants so the wire stays finite/deterministic.
        if m is None:
            dx = _F(x1) - _F(x0)
            dy = _F(y1) - _F(y0)
            m = div_det_np(dx, dy)
            K = div_det_np(-dy, np.abs(dx))
        m = float(m) if np.isfinite(m) else 0.0
        K = float(K) if np.isfinite(K) else 0.0
        self._push(CMD_FILL, [float(x0), float(y0), float(y1), m, K])

    def fill_edge(self, sign: float, y: float) -> None:
        self._push(CMD_FILL_EDGE, [float(sign), float(y)])

    def wind(self, backdrop: int) -> None:
        """Winding carry of a non-final combined-fill subpath (extension
        command CMD_WIND): area += backdrop, no resolve, bail state
        untouched (like CMD_FILL)."""
        self._push(CMD_WIND, [float(backdrop)])

    # -- clip / layer groups (extension commands) -----------------------
    def begin_clip(self, backdrop: int, even_odd: bool = False) -> None:
        self.solid_color = 0
        self._push(CMD_BEGIN_CLIP,
                   [float(backdrop), 1.0 if even_odd else 0.0])

    def end_clip(self) -> None:
        self.solid_color = 0
        self._push(CMD_END_CLIP, [])

    def begin_layer(self) -> None:
        self.solid_color = 0
        self._push(CMD_BEGIN_LAYER, [])

    def end_layer(self, alpha: float) -> None:
        self.solid_color = 0
        self._push(CMD_END_LAYER, [float(alpha)])

    def draw_grad(self, backdrop: int, params3, c0_lin, c1_lin,
                  radial: bool) -> None:
        """Gradient fill resolve (gradient extension): like draw_fill but
        the color is lerp(c0, c1, t) per pixel; colors arrive pre-decoded
        LINEAR (c0 from the scene color table, c1 from Scene.grads)."""
        self.solid_color = 0
        tag = CMD_DRAW_RAD_GRAD if radial else CMD_DRAW_LIN_GRAD
        self._push(tag, [float(backdrop)] + [float(v) for v in params3]
                   + [float(v) for v in c0_lin] + [float(v) for v in c1_lin])

    def draw_fill(self, backdrop: int, rgba: int, even_odd: bool = False,
                  clip=NO_CLIP) -> None:
        self.solid_color = 0
        self._push(CMD_DRAW_FILL, [float(backdrop)] + self._rgba_linear(rgba)
                   + [1.0 if even_odd else 0.0, 0.0, 0.0]
                   + [float(v) for v in clip])

    def solid(self, rgba: int, clip=NO_CLIP, in_group: bool = False) -> None:
        if tuple(clip) != NO_CLIP or in_group:
            # A clipped solid -- or one inside an open clip/layer group --
            # is a PARTIAL draw: it can neither bail the tile nor leave
            # earlier bail state standing (unlike the reference's
            # translucent-solid quirk, which predates clips).
            self.solid_color = 0
        elif (rgba & 0xFF) == 0xFF:
            self.solid_color = rgba
            self.cmds.clear()
            self.overflow = 0
        self._push(CMD_SOLID, self._rgba_linear(rgba) + [0.0] * 4
                   + [float(v) for v in clip])

    def end(self) -> int:
        """Returns the bail color (0 = render the command list)."""
        return self.solid_color


def assemble_ptcl(encoders: List[TileCmdEncoder], capacity: int) -> Ptcl:
    """Pack per-tile encoders into dense arrays."""
    t = len(encoders)
    tags = np.zeros((t, capacity), np.int32)
    args = np.zeros((t, capacity, ARG_WORDS), np.float32)
    counts = np.zeros((t,), np.int32)
    solid = np.zeros((t,), np.uint32)
    overflow = np.zeros((t,), np.int32)
    for i, enc in enumerate(encoders):
        solid[i] = enc.end()
        if solid[i]:
            continue  # bail: command list is dead (Cmd_Bail semantics)
        counts[i] = len(enc.cmds)
        overflow[i] = enc.overflow
        for j, (tag, a) in enumerate(enc.cmds):
            tags[i, j] = tag
            args[i, j, :len(a)] = np.asarray(a, np.float32)
    return Ptcl(tags=tags, args=args, counts=counts, solid=solid,
                overflow=overflow)
