"""The fine kernel's share of its roofline: its least time over its
measured time (``fine.device_ms``).

The work is counted from the reference's PTCL of the cell's scene (the
commands the frozen oracle's tiler emits), not from the program's records,
so it reads the same work whatever route or kernel does it.  The least
time is the larger of

* bytes / the card's memory bandwidth: each live command read once
  (its tag and 12 argument words, 52 bytes) and each pixel of a tile that
  does not bail written once (4 bytes);
* operations / the card's f32 rate without fused multiply-add (exactness
  forbids it): only the per-pixel f32 arithmetic (add, subtract,
  multiply, min, max, abs, sqrt) that any exact implementation must do,
  on the pixels where the command can change the result.

Per command (``OPS``): what depends on a pixel's row alone or its column
alone is left out, as are compares and selects, and a command's pixels
are limited as follows (X, Y the pixel's corner, inside the viewport):

* Line: its segment's box widened by word 4 (half width + 0.5) on each
  side, open: outside it the distance reaches the stroke's edge, so the
  stroke's coverage there is 0;
* Stroke: the largest of its lines' pixel counts (a lower bound of their
  union);
* Fill: rows with min(sy, ey) - 1 < Y < max(sy, ey) (elsewhere both
  window ends clamp alike and the command adds nothing) and columns with
  X > min(x) - 1 (to the left both u >= 1 and the term is exactly 0);
  the cheaper of its two exact branches (the vertical-edge limit);
* FillEdge: rows with Y > ye - 1 (elsewhere the edge adds 0);
* Circle: the square inscribed in its disk;
* DrawFill, clip pushes and gradients: the resolve's first three
  operations (area + backdrop, abs, min) on every pixel; Solid and the
  layer pop: the colour blend (9) on every pixel; Wind: one add on every
  pixel where its backdrop is not 0.

The present encode (linear to sRGB) is not counted.  Every term is a
lower bound, so a share above 100% means the time leaves out work.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .fine_device_ms import fine_seconds

NAME = "fine_roofline"
UNIT = "%"
LAYER = "fine"
SOURCE = "device_trace"
MOVES = "frame_ms"

CMD_CIRCLE, CMD_LINE, CMD_FILL, CMD_STROKE, CMD_FILL_EDGE = 2, 3, 4, 5, 6
CMD_DRAW_FILL, CMD_SOLID = 7, 8
CMD_BEGIN_CLIP, CMD_END_CLIP, CMD_BEGIN_LAYER, CMD_END_LAYER = 10, 11, 12, 13
CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD, CMD_WIND = 14, 15, 16

#: f32 operations per live pixel, by command tag.
OPS = {
    # add (sum of the two products), mul (inv_denom), saturate (2),
    # fx and fy (2 each), fx*fx + fy*fy (3), sqrt, min with the field.
    CMD_LINE: 13,
    # hw + 0.5 - df (1), saturate (2), alpha * a (1), blend (3 x 3).
    CMD_STROKE: 13,
    # ua, ub (2), min and max (2), umax - umin (1), the vertical-edge
    # branch: saturate (2), 1 - c (1), * (w0 - w1) (1); area + delta (1).
    CMD_FILL: 10,
    # area + edge term.
    CMD_FILL_EDGE: 1,
    # x^2 + y^2 (1), sqrt, r - dist (1), saturate (2), 1 - alpha (1),
    # three channel multiplies.
    CMD_CIRCLE: 9,
    # area + backdrop, abs, min.
    CMD_DRAW_FILL: 3, CMD_BEGIN_CLIP: 3, CMD_DRAW_LIN_GRAD: 3,
    CMD_DRAW_RAD_GRAD: 3,
    # blend (3 x 3).
    CMD_SOLID: 9, CMD_END_LAYER: 9,
    CMD_WIND: 1,
    CMD_END_CLIP: 0, CMD_BEGIN_LAYER: 0,
}

CMD_BYTES = 4 + 12 * 4
PIXEL_BYTES = 4

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def _span(lo, hi, a, b):
    """Integers n with lo <= n < hi and a < n < b (open), counted."""
    a = np.clip(a, lo - 1, hi)
    b = np.clip(b, lo - 1, hi)
    first = np.maximum(lo, np.floor(a).astype(np.int64) + 1)
    last = np.minimum(hi - 1, np.ceil(b).astype(np.int64) - 1)
    return np.maximum(last - first + 1, 0)


def count(ptcl: dict, width: int, height: int, tile_w: int, tile_h: int,
          tiles_x: int) -> dict:
    """Operations and bytes of the fine pass for one frame's PTCL (the
    reference's: ``tile``, ``tag``, ``args`` of every live command and the
    tiles' ``solid`` colours)."""
    tile = ptcl["tile"].astype(np.int64)
    tag = ptcl["tag"].astype(np.int64)
    a = ptcl["args"].astype(np.float64)
    x0 = (tile % tiles_x) * tile_w
    y0 = (tile // tiles_x) * tile_h
    x1 = np.minimum(x0 + tile_w, width)
    y1 = np.minimum(y0 + tile_h, height)
    cols_all = np.maximum(x1 - x0, 0)
    rows_all = np.maximum(y1 - y0, 0)
    inf = np.full(len(tag), np.inf)
    px = np.zeros(len(tag), np.int64)

    m = tag == CMD_LINE
    w = a[:, 4]
    lx0, lx1 = np.minimum(a[:, 0], a[:, 2]), np.maximum(a[:, 0], a[:, 2])
    ly0, ly1 = np.minimum(a[:, 1], a[:, 3]), np.maximum(a[:, 1], a[:, 3])
    line_px = (_span(x0, x1, lx0 - w, lx1 + w)
               * _span(y0, y1, ly0 - w, ly1 + w))
    px[m] = line_px[m]

    # A stroke's lines are the line commands right before it.
    nonline = (tag != CMD_LINE).astype(np.int64)
    group = np.cumsum(nonline) - nonline
    best = np.zeros(len(tag) + 1, np.int64)
    np.maximum.at(best, group[m], line_px[m])
    s = tag == CMD_STROKE
    px[s] = best[group[s]]

    f = tag == CMD_FILL
    sx, sy, ey, slope = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    ex = sx + slope * (ey - sy)
    fill_px = (_span(x0, x1, np.minimum(sx, ex) - 1.0, inf)
               * _span(y0, y1, np.minimum(sy, ey) - 1.0, np.maximum(sy, ey)))
    px[f] = fill_px[f]

    e = tag == CMD_FILL_EDGE
    px[e] = (cols_all * _span(y0, y1, a[:, 1] - 1.0, inf))[e]

    c = tag == CMD_CIRCLE
    cx = a[:, 0] + 0.5 * (a[:, 2] - a[:, 0])
    cy = a[:, 1] + 0.5 * (a[:, 3] - a[:, 1])
    r = np.minimum(cx - a[:, 0], cy - a[:, 1]) / np.sqrt(2.0)
    px[c] = (_span(x0, x1, cx - r, cx + r) * _span(y0, y1, cy - r, cy + r))[c]

    whole = np.isin(tag, [CMD_DRAW_FILL, CMD_BEGIN_CLIP, CMD_DRAW_LIN_GRAD,
                          CMD_DRAW_RAD_GRAD, CMD_SOLID, CMD_END_LAYER])
    whole |= (tag == CMD_WIND) & (a[:, 0] != 0.0)
    px[whole] = (cols_all * rows_all)[whole]

    ops_per_px = np.zeros(len(tag), np.int64)
    for t, k in OPS.items():
        ops_per_px[tag == t] = k
    ops = int((px * ops_per_px).sum())

    solid = ptcl["solid"].reshape(-1)
    t_all = np.arange(solid.size)
    tx0 = (t_all % tiles_x) * tile_w
    ty0 = (t_all // tiles_x) * tile_h
    tile_px = (np.maximum(np.minimum(tx0 + tile_w, width) - tx0, 0)
               * np.maximum(np.minimum(ty0 + tile_h, height) - ty0, 0))
    pixels = int(tile_px[solid == 0].sum())
    return {"ops": ops, "bytes": CMD_BYTES * len(tag) + PIXEL_BYTES * pixels,
            "commands": int(len(tag)), "pixels": pixels}


def peaks_for(kind: str) -> dict:
    """The card's peaks from ``peaks.json`` (keyed by a fragment of the
    card's name), or None for a card the table does not know."""
    with open(PEAKS, encoding="utf-8") as fh:
        table = json.load(fh)
    for frag, p in table.items():
        if frag in kind:
            return p
    return None


def least_seconds(work: dict, peaks: dict) -> float:
    return max(work["ops"] / peaks["f32_ops_per_s"],
               work["bytes"] / peaks["hbm_bytes_per_s"])


def read(ctx):
    ptcl, peaks = ctx.get("ptcl"), ctx.get("peaks")
    if ptcl is None or peaks is None or not ctx["frames"]:
        return None
    sec = fine_seconds(ctx) / ctx["frames"]
    if sec <= 0:
        return None
    g = ctx["geometry"]
    work = count(ptcl, g["width"], g["height"], g["tile_width"],
                 g["tile_height"], g["tiles_x"])
    return 100.0 * least_seconds(work, peaks) / sec
