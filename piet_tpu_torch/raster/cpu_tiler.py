"""CPU golden tiler: Scene -> PTCL, the binning oracle.

Implements exactly the per-tile command-generation math of the reference's
``tileKernel`` (PietRender.metal:160-454), with the SIMT ballot machinery
removed: the ballots/strip culls there exist to skip work under divergence
and are output-invariant (any segment they cull generates no commands for
any tile in the strip), so the oracle visits, per tile, every item whose
quantized bbox hits the tile, in scene order, and applies the reference's
per-tile tests verbatim:

* item bbox hit:  bbox.x1 >= x0 && bbox.x0 < x0+tw && bbox.y1 >= y0 &&
  bbox.y0 < y0+th  (PietRender.metal:214)
* fills: per-segment y-cull (:265), left-ray backdrop via the line-equation
  sign test (:326-333), left-edge crossing emitting CmdFillEdge + a clipped
  CmdFill (:334-344), 4-corner sign cull for plain CmdFill (:345-353),
  trailing CmdDrawFill / CmdSolid (:359-363)
* polylines: bbox + 4-corner cull inflated by hw = width/2 + 0.5 (:411-435),
  trailing CmdStroke (:441-443)
* lines: 4-corner cull with the same inflation (:223-247)
* circles: bbox only (:218-222)

All arithmetic is float32 (Metal ``float``), and the identical formulas are
implemented by the XLA coarse pass (ops/coarse.py), so PTCL equivalence is
testable command-for-command.  Tile size is parametric (the reference
hard-codes 16x16; our TPU default is 16x128 -- see config.py).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..config import RenderConfig
from ..scene.scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL,
                           FLAG_EVEN_ODD, FLAG_FILL_CONT, FLAG_FILL_FINAL,
                           FLAG_IN_GROUP, FLAG_POP_LAYER,
                           Scene, TAG_CIRCLE, TAG_CLIP, TAG_FILL, TAG_LAYER,
                           TAG_LINE, TAG_POLY, TAG_POP)
from .ptcl import (Ptcl, TileCmdEncoder, assemble_ptcl, div_det_np,
                   dot2_det_np)

F = np.float32


@dataclasses.dataclass
class _ItemSegs:
    """Precomputed f32 segment geometry for one item."""
    start: np.ndarray  # (S, 2)
    end: np.ndarray    # (S, 2)
    xymin: np.ndarray  # (S, 2)
    xymax: np.ndarray  # (S, 2)
    a: np.ndarray      # (S,)
    b: np.ndarray
    c: np.ndarray
    # Per-segment constants of the division-free fine math (round 5;
    # ops/cmd_math.py module doc), computed ONCE per segment through the
    # deterministic division selection -- the device coarse pass derives
    # the same values in its segment stage and ships them in the wire.
    inv_denom: np.ndarray  # div_det(1, |v|^2); +inf on zero-length segs
    m: np.ndarray          # div_det(dx, dy), zeroed when non-finite
    K: np.ndarray          # div_det(-dy, |dx|), zeroed when non-finite


def _segments(points: np.ndarray, wrap: bool) -> _ItemSegs:
    pts = points.astype(F)
    if wrap:
        start = pts
        end = np.roll(pts, -1, axis=0)
    else:
        start = pts[:-1]
        end = pts[1:]
    a = end[:, 1] - start[:, 1]
    b = start[:, 0] - end[:, 0]
    c = -(a * start[:, 0] + b * start[:, 1])
    lvx = end[:, 0] - start[:, 0]
    lvy = end[:, 1] - start[:, 1]
    inv_denom = div_det_np(np.ones_like(lvx), dot2_det_np(lvx, lvy))
    with np.errstate(invalid="ignore"):
        m = np.asarray(div_det_np(lvx, lvy))
        K = np.asarray(div_det_np(-lvy, np.abs(lvx)))
    m = np.where(np.isfinite(m), m, F(0.0))
    K = np.where(np.isfinite(K), K, F(0.0))
    return _ItemSegs(start=start, end=end,
                     xymin=np.minimum(start, end), xymax=np.maximum(start, end),
                     a=a, b=b, c=c, inv_denom=np.asarray(inv_denom),
                     m=m, K=K)


def _fill_coverage(enc: TileCmdEncoder, seg: _ItemSegs,
                   x0: F, y0: F, tw: F, th: F):
    """Emit the per-tile fill COVERAGE commands (edges + fills) of a
    closed path; returns (any_fill, backdrop) for the caller's tail
    command (reference fill logic, PietRender.metal:248-364)."""
    s = seg
    ycull = (s.xymax[:, 1] >= y0) & (s.xymin[:, 1] < y0 + th)
    idx = np.nonzero(ycull)[0]
    if idx.size == 0:
        return False, F(0.0)
    start, end = s.start[idx], s.end[idx]
    xymin, xymax = s.xymin[idx], s.xymax[idx]
    a, b, c = s.a[idx], s.b[idx], s.c[idx]
    s_m, s_K = s.m[idx], s.K[idx]

    left = a * x0
    right = a * (x0 + tw)
    ytop = np.maximum(y0, xymin[:, 1])
    ybot = np.minimum(y0 + th, xymax[:, 1])
    top = b * ytop
    bot = b * ybot
    s_top_left = np.sign(left + y0 * b + c)
    s00 = np.sign(top + left + c)
    s01 = np.sign(top + right + c)
    s10 = np.sign(bot + left + c)
    s11 = np.sign(bot + right + c)
    four_corner = s00 * s01 + s00 * s10 + s00 * s11 < F(3.0)

    backdrop_mask = (s_top_left == np.sign(a)) & (xymin[:, 1] <= y0)
    backdrop = -np.sum(s00[backdrop_mask], dtype=F)

    crosses_left = (xymin[:, 0] < x0) & (xymax[:, 0] > x0)
    with np.errstate(divide="ignore", invalid="ignore"):
        # div_det_np: the intercept is a PTCL operand the device computes
        # with the exact-residual division selection (ops/coarse.py);
        # the oracle mirrors it bitwise.
        t_edge = div_det_np(start[:, 0] - x0, b)
        y_edge = start[:, 1] + (end[:, 1] - start[:, 1]) * t_edge
    edge_in_tile = crosses_left & (y_edge >= y0) & (y_edge < y0 + th)

    plain_a = crosses_left & ~edge_in_tile & four_corner
    plain_b = (~crosses_left & four_corner
               & (xymin[:, 0] < x0 + tw) & (xymax[:, 0] > x0))

    any_fill = False
    for k in range(idx.size):
        if edge_in_tile[k]:
            enc.fill_edge(s00[k], y_edge[k])
            # Clipped sub-segments carry the SEGMENT's m/K (the slope of
            # a line is the line's; one shared per-segment definition).
            if b[k] > 0.0:
                enc.fill(start[k, 0], start[k, 1], x0, y_edge[k],
                         m=s_m[k], K=s_K[k])
            else:
                enc.fill(x0, y_edge[k], end[k, 0], end[k, 1],
                         m=s_m[k], K=s_K[k])
            any_fill = True
        elif plain_a[k] or plain_b[k]:
            enc.fill(start[k, 0], start[k, 1], end[k, 0], end[k, 1],
                     m=s_m[k], K=s_K[k])
            any_fill = True

    return any_fill, backdrop


def _fill_tile(enc: TileCmdEncoder, seg: _ItemSegs, color: int,
               even_odd: bool, clip, in_group: bool,
               x0: F, y0: F, tw: F, th: F, grad=None, radial=False,
               cont: bool = False, final: bool = False) -> None:
    """Reference fill logic for one (item, tile); ``grad`` (a Scene.grads
    row) switches the resolve to a gradient draw (gradient extension);
    ``cont``/``final`` implement multi-subpath fills (hole extension,
    scene.FLAG_FILL_CONT/FLAG_FILL_FINAL): a CONT subpath carries its
    interior winding in a CMD_WIND instead of resolving; a FINAL subpath
    resolves unconditionally (a sibling may have contributed where it has
    no presence of its own)."""
    any_fill, backdrop = _fill_coverage(enc, seg, x0, y0, tw, th)
    if cont:
        if backdrop != F(0.0):
            enc.wind(int(backdrop))
    elif grad is not None:
        # Gradient brush: the tile can never bail to a solid (the color
        # varies per pixel), so interior tiles (winding only) get the
        # same draw command with area == 0.
        if any_fill or backdrop != F(0.0) or final:
            from ..scene.color import decode_color_linear
            c0 = decode_color_linear(np.uint32(color))
            enc.draw_grad(int(backdrop), grad[:3], c0, grad[3:7], radial)
    elif any_fill or final:
        enc.draw_fill(int(backdrop), color, even_odd=even_odd, clip=clip)
    elif backdrop != F(0.0):
        enc.solid(color, clip=clip, in_group=in_group)


def _clip_tile(enc: TileCmdEncoder, seg: _ItemSegs, even_odd: bool,
               x0: F, y0: F, tw: F, th: F) -> None:
    """Arbitrary-path clip push (extension): the path's coverage commands
    followed by BeginClip -- emitted in EVERY tile (outside the path the
    coverage must become 0)."""
    _, backdrop = _fill_coverage(enc, seg, x0, y0, tw, th)
    enc.begin_clip(int(backdrop), even_odd=even_odd)


def _poly_tile(enc: TileCmdEncoder, seg: _ItemSegs, color: int, width: F,
               clip, x0: F, y0: F, tw: F, th: F) -> None:
    """Reference polyline logic (PietRender.metal:366-444)."""
    hw = F(0.5) * width + F(0.5)
    s = seg
    bcull = ((s.xymax[:, 1] > y0 - hw) & (s.xymin[:, 1] < y0 + th + hw)
             & (s.xymax[:, 0] > x0 - hw) & (s.xymin[:, 0] < x0 + tw + hw))
    left = s.a * (x0 - hw)
    right = s.a * (x0 + tw + hw)
    top = s.b * (y0 - hw)
    bot = s.b * (y0 + th + hw)
    s00 = np.sign(top + left + s.c)
    s01 = np.sign(top + right + s.c)
    s10 = np.sign(bot + left + s.c)
    s11 = np.sign(bot + right + s.c)
    keep = bcull & (s00 * s01 + s00 * s10 + s00 * s11 < F(3.0))
    any_stroke = False
    for k in np.nonzero(keep)[0]:
        enc.line(s.start[k, 0], s.start[k, 1], s.end[k, 0], s.end[k, 1],
                 ycull=hw, inv_denom=s.inv_denom[k])
        any_stroke = True
    if any_stroke:
        enc.stroke(color, width, clip=clip)


def _line_tile(enc: TileCmdEncoder, seg: _ItemSegs, color: int, width: F,
               clip, x0: F, y0: F, tw: F, th: F) -> None:
    """Reference single-line logic (PietRender.metal:223-247)."""
    hw = F(0.5) * width + F(0.5)
    left = seg.a * (x0 - hw)
    right = seg.a * (x0 + tw + hw)
    top = seg.b * (y0 - hw)
    bot = seg.b * (y0 + th + hw)
    s00 = np.sign(top + left + seg.c)
    s01 = np.sign(top + right + seg.c)
    s10 = np.sign(bot + left + seg.c)
    s11 = np.sign(bot + right + seg.c)
    if (s00 * s01 + s00 * s10 + s00 * s11 < F(3.0))[0]:
        enc.line(seg.start[0, 0], seg.start[0, 1], seg.end[0, 0],
                 seg.end[0, 1], ycull=hw, inv_denom=seg.inv_denom[0])
        enc.stroke(color, width, clip=clip)


def cpu_tile_scene(scene: Scene, config: RenderConfig) -> Ptcl:
    """Bin a scene into per-tile command lists (the golden coarse pass)."""
    tw, th = F(config.tile_width), F(config.tile_height)
    tiles_x, tiles_y = config.tiles_x, config.tiles_y

    segs: List[_ItemSegs] = []
    for i in range(scene.n_items):
        tag = int(scene.tags[i])
        off, n = int(scene.pt_offset[i]), int(scene.n_pts[i])
        pts = scene.points[off:off + n]
        segs.append(_segments(pts, wrap=(tag in (TAG_FILL, TAG_CLIP))))

    bb = scene.bboxes
    encoders: List[TileCmdEncoder] = []
    for ty in range(tiles_y):
        y0 = F(ty) * th
        for tx in range(tiles_x):
            x0 = F(tx) * tw
            enc = TileCmdEncoder(config.cmd_capacity)
            hit = np.nonzero(
                (bb[:, 2] >= x0) & (bb[:, 0] < x0 + tw)
                & (bb[:, 3] >= y0) & (bb[:, 1] < y0 + th))[0]
            for i in hit:
                tag = int(scene.tags[i])
                color = int(scene.colors[i])
                width = F(scene.widths[i])
                if tag == TAG_CIRCLE:
                    enc.circle(bb[i], clip=tuple(scene.clips[i]))
                elif tag == TAG_LINE:
                    _line_tile(enc, segs[i], color, width,
                               tuple(scene.clips[i]), x0, y0, tw, th)
                elif tag == TAG_FILL:
                    fl = int(scene.flags[i])
                    is_grad = fl & (FLAG_BRUSH_LINEAR | FLAG_BRUSH_RADIAL)
                    _fill_tile(enc, segs[i], color,
                               bool(fl & FLAG_EVEN_ODD),
                               tuple(scene.clips[i]),
                               bool(fl & FLAG_IN_GROUP),
                               x0, y0, tw, th,
                               grad=scene.grads[i] if is_grad else None,
                               radial=bool(fl & FLAG_BRUSH_RADIAL),
                               cont=bool(fl & FLAG_FILL_CONT),
                               final=bool(fl & FLAG_FILL_FINAL))
                elif tag == TAG_POLY:
                    _poly_tile(enc, segs[i], color, width,
                               tuple(scene.clips[i]), x0, y0, tw, th)
                elif tag == TAG_CLIP:
                    _clip_tile(enc, segs[i],
                               bool(scene.flags[i] & FLAG_EVEN_ODD),
                               x0, y0, tw, th)
                elif tag == TAG_LAYER:
                    enc.begin_layer()
                elif tag == TAG_POP:
                    if scene.flags[i] & FLAG_POP_LAYER:
                        enc.end_layer(float(scene.widths[i]))
                    else:
                        enc.end_clip()
            encoders.append(enc)
    return assemble_ptcl(encoders, config.cmd_capacity)
