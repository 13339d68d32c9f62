"""Capacity fitting: exact record counts for a scene, computed on host.

Every record array in the coarse pass (segments, hit records, candidates,
winding deltas) is capacity-padded, and every op over them prices the
CAPACITY, not the live count -- oversizing max_hits by 4x costs real
milliseconds per frame.  This module mirrors the coarse pass's count
arithmetic (ops/coarse.py) in numpy -- the same f32 expressions, so counts
are exact, not estimates -- and returns a config whose caps fit the scene.

Caps can be fitted exactly (fastest frames; any scene change recompiles)
or bucketed to 1.3x-rounded powers-of-two-ish sizes (amortizes recompiles
across animated scenes, SURVEY.md section 7 "hard parts" item 6).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import RenderConfig
from ..scene.scene import TAG_CLIP, TAG_FILL, TAG_LINE, TAG_POLY

F = np.float32


def count_records(scene, config: RenderConfig):
    """Exact (n_segments, n_hits, n_candidates, n_deltas) for this scene
    under this config's tile geometry (identical math to ops/coarse.py)."""
    tw, th = config.tile_width, config.tile_height
    tiles_x, tiles_y = config.tiles_x, config.tiles_y
    tags = scene.tags
    n_pts = scene.n_pts

    # Item tile rects (integer, exact).
    bx0 = np.maximum(scene.bboxes[:, 0] // tw, 0)
    by0 = np.maximum(scene.bboxes[:, 1] // th, 0)
    bx1 = np.minimum(scene.bboxes[:, 2] // tw, tiles_x - 1)
    by1 = np.minimum(scene.bboxes[:, 3] // th, tiles_y - 1)
    bw = np.maximum(bx1 - bx0 + 1, 0)
    bh = np.maximum(by1 - by0 + 1, 0)
    n_cand = int((bw * bh).sum())

    is_fill_item = (tags == TAG_FILL) | (tags == TAG_CLIP)
    seg_counts = np.where(
        is_fill_item, n_pts,
        np.where(tags == TAG_POLY, np.maximum(n_pts - 1, 0),
                 np.where(tags == TAG_LINE, 1, 0)))
    n_segs = int(seg_counts.sum())

    # Per-segment geometry (f32, as the device computes it).
    item_of_seg = np.repeat(np.arange(scene.n_items), seg_counts)
    local = np.arange(n_segs) - np.repeat(
        np.cumsum(seg_counts) - seg_counts, seg_counts)
    i0 = scene.pt_offset[item_of_seg] + local
    wrap = is_fill_item[item_of_seg] & (local + 1 == n_pts[item_of_seg])
    i1 = np.where(wrap, scene.pt_offset[item_of_seg], i0 + 1)
    p0 = scene.points[i0].astype(F)
    p1 = scene.points[i1].astype(F)
    xmn = np.minimum(p0, p1)
    xmx = np.maximum(p0, p1)
    s_hw = F(0.5) * scene.widths[item_of_seg].astype(F) + F(0.5)
    twf, thf = F(tw), F(th)
    is_fill = is_fill_item[item_of_seg]
    is_line = tags[item_of_seg] == TAG_LINE

    fx_lo = np.floor(xmn[:, 0] / twf).astype(np.int32)
    fx_hi = np.ceil(xmx[:, 0] / twf).astype(np.int32) - 1
    fy_lo = np.floor(xmn[:, 1] / thf).astype(np.int32)
    fy_hi = np.floor(xmx[:, 1] / thf).astype(np.int32)
    def _stroke_range(lo_v, hi_v, dim, step):
        lo = np.floor(lo_v / step).astype(np.int32)
        hi = np.ceil(hi_v / step).astype(np.int32) - 1

        def passes(t):
            o = t.astype(F) * step
            return (xmx[:, dim] > o - s_hw) & (xmn[:, dim] < o + step + s_hw)

        lo = np.where(passes(lo - 1), lo - 1, lo)
        hi = np.where(passes(hi + 1), hi + 1, hi)
        return lo, hi

    st_x_lo, st_x_hi = _stroke_range(xmn[:, 0] - s_hw, xmx[:, 0] + s_hw,
                                     0, twf)
    st_y_lo, st_y_hi = _stroke_range(xmn[:, 1] - s_hw, xmx[:, 1] + s_hw,
                                     1, thf)

    sb = (bx0[item_of_seg], by0[item_of_seg], bx1[item_of_seg],
          by1[item_of_seg])
    r_x_lo = np.maximum(np.where(is_fill, fx_lo,
                                 np.where(is_line, sb[0], st_x_lo)), sb[0])
    r_x_hi = np.minimum(np.where(is_fill, fx_hi,
                                 np.where(is_line, sb[2], st_x_hi)), sb[2])
    r_y_lo = np.maximum(np.where(is_fill, fy_lo,
                                 np.where(is_line, sb[1], st_y_lo)), sb[1])
    r_y_hi = np.minimum(np.where(is_fill, fy_hi,
                                 np.where(is_line, sb[3], st_y_hi)), sb[3])
    r_w = np.maximum(r_x_hi - r_x_lo + 1, 0)
    r_h = np.maximum(r_y_hi - r_y_lo + 1, 0)
    a = p1[:, 1] - p0[:, 1]
    # Round-5 delta fold: fill segments whose column range is empty but
    # whose rows carry winding deltas get one forced column (identical
    # widening in ops/coarse.py; rationale there).
    widen = (is_fill & (a != 0) & (r_w == 0) & (r_h > 0)
             & (sb[0] <= sb[2]))
    wcol = np.clip(fx_lo, sb[0], sb[2])
    r_x_lo = np.where(widen, wcol, r_x_lo)
    r_x_hi = np.where(widen, wcol, r_x_hi)
    r_w = np.where(widen, 1, r_w)
    n_hits = int((r_w * r_h).sum())

    d_y_lo = np.maximum(np.ceil(xmn[:, 1] / thf).astype(np.int32), 0)
    d_y_hi = np.minimum(np.floor(xmx[:, 1] / thf).astype(np.int32),
                        tiles_y - 1)
    n_deltas = int(np.where(is_fill & (a != 0),
                            np.maximum(d_y_hi - d_y_lo + 1, 0), 0).sum())

    # Per-tile command upper bound (<= 2 commands per hit record + 1 per
    # candidate) via 2-D difference arrays -- sizes the dense path's
    # cmd_capacity without enumerating records.
    def rect_hist(xl, xh, yl, yh, w):
        keep = (xh >= xl) & (yh >= yl) & (w > 0)
        xl, xh, yl, yh = xl[keep], xh[keep], yl[keep], yh[keep]
        wk = np.broadcast_to(w, keep.shape)[keep] if np.ndim(w) else             np.full(keep.sum(), w, np.int64)
        D = np.zeros((tiles_y + 1, tiles_x + 1), np.int64)
        np.add.at(D, (yl, xl), wk)
        np.add.at(D, (yl, xh + 1), -wk)
        np.add.at(D, (yh + 1, xl), -wk)
        np.add.at(D, (yh + 1, xh + 1), wk)
        return D.cumsum(0).cumsum(1)[:tiles_y, :tiles_x]

    hist = (2 * rect_hist(r_x_lo, r_x_hi, r_y_lo, r_y_hi, 1)
            + rect_hist(bx0, bx1, by0, by1, 1))
    max_tile_cmds_ub = int(hist.max()) if hist.size else 0
    return n_segs, n_hits, n_cand, n_deltas, max_tile_cmds_ub


def _round_cap(n: int, bucket: bool) -> int:
    n = max(n, 128)
    if not bucket:
        return -(-n // 128) * 128
    # 1.3x headroom, then round to the next 1/4-power-of-two step --
    # few distinct sizes across an animated scene, so few recompiles.
    target = max(int(n * 1.3), 256)
    step = 1 << max(target.bit_length() - 3, 7)
    return -(-target // step) * step


def fit_capacities(scene, config: RenderConfig,
                   bucket: bool = False) -> RenderConfig:
    """Return a config whose record capacities fit ``scene`` exactly
    (bucket=False) or with bucketed headroom for animated workloads.

    Also sizes ``cmd_capacity`` (used by the dense/portable path; the
    entry-stream path has no per-tile capacity) from a per-tile command
    upper bound."""
    n_segs, n_hits, n_cand, n_deltas, cmds_ub = count_records(scene, config)
    return dataclasses.replace(
        config,
        max_items=_round_cap(scene.n_items, bucket),
        max_points=_round_cap(scene.n_points, bucket),
        max_segments=_round_cap(n_segs, bucket),
        max_hits=_round_cap(n_hits, bucket),
        max_candidates=_round_cap(n_cand, bucket),
        max_deltas=_round_cap(n_deltas, bucket),
        cmd_capacity=_round_cap(cmds_ub, bucket))
