"""The device segment stage's rows: each segment slot's (S, 27) row, its
hit count, their exclusive scan and total, from the expanded item rows and
the two endpoints.

``ops/coarse.py::derive_seg_stage`` calls :func:`seg_rows` after the
endpoint gather: on CUDA tensors one call of ``csrc/seg_rows.cu`` (a
launch where S fits one block of 256 slots, else two, the second a
programmatic dependent launch behind the first), on CPU tensors its plain
version :func:`seg_rows_plain` (the JAX pass's derivation, in PyTorch);
both give the same words on every slot, dead slots included.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..scene.scene import TAG_CLIP, TAG_FILL, TAG_LINE, TAG_POLY
from .cmd_math import _bits, div_det, dot2_det
from .gatherm import SITEM_WORDS
from .hitfuse import SEG_WORDS

I32, F32 = torch.int32, torch.float32
_INF = float("inf")

#: Segment slots a block of the kernel.
BLOCK = 256


def seg_rows(sitem: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
             n_segs: torch.Tensor, *, tile_w: int, tile_h: int):
    """The segment rows of every slot, one call on the card.

    Args:
      sitem: (S, 14) int32 expanded item rows, one per segment slot
        (``ops/coarse.py::derive_seg_stage``: words 0 tag, 3 the item's
        first candidate slot, 4-7 its tile bbox, 8 its width in tiles, 9
        its stroke width's f32 bits, 11 the item), 16-byte aligned.
      p0, p1: (S, 2) f32 endpoints (``gatherm.gather_endpoints``).
      n_segs: (1,) int32 live segment count, on the device.
      tile_w, tile_h: the tile's size in pixels, powers of two.

    Returns ``(rows, hit_counts, hit_excl, n_hits)``: the (S, 27) int32
    rows (their bits: 0-11 the f32 line, bounds and half width, 12-22 the
    flags and integer words, 23-25 the f32 fine constants, 26 the slot's
    hit offset), the (S,) int32 hit counts and their exclusive scan, and
    the (1,) int32 total, as :func:`seg_rows_plain` gives them.
    """
    kw = dict(tile_w=tile_w, tile_h=tile_h)
    if not kernels.on_cuda(sitem, p0, p1, n_segs):
        return seg_rows_plain(sitem, p0, p1, n_segs, **kw)
    S = sitem.shape[0]
    kernels.check_cuda_tensor(sitem, I32, "sitem", (S, SITEM_WORDS))
    kernels.check_cuda_tensor(p0, F32, "p0", (S, 2))
    kernels.check_cuda_tensor(p1, F32, "p1", (S, 2))
    kernels.check_cuda_tensor(n_segs, I32, "n_segs", (1,))
    if sitem.data_ptr() % 16 or p0.data_ptr() % 8 or p1.data_ptr() % 8:
        raise ValueError("sitem must be 16-byte aligned, p0 and p1 8-byte")
    if S == 0 or tile_w <= 0 or tile_h <= 0:
        raise ValueError("seg_rows needs segment slots and a positive tile")
    dev = sitem.device
    rows = torch.empty((S, SEG_WORDS), dtype=I32, device=dev)
    hit_counts, hit_excl = (torch.empty((S,), dtype=I32, device=dev)
                            for _ in range(2))
    n_hits = torch.empty((1,), dtype=I32, device=dev)
    sums = torch.empty((-(-S // BLOCK),), dtype=I32, device=dev)
    kernels.launch("seg_rows", "piet_seg_rows", sitem.data_ptr(),
                   p0.data_ptr(), p1.data_ptr(), n_segs.data_ptr(),
                   sums.data_ptr(), rows.data_ptr(), hit_counts.data_ptr(),
                   hit_excl.data_ptr(), n_hits.data_ptr(), S, tile_w,
                   tile_h)
    return rows, hit_counts, hit_excl, n_hits


def seg_rows_plain(sitem, p0, p1, n_segs, *, tile_w: int, tile_h: int):
    """The segment rows from the expanded item rows and the endpoints: a
    port of ``piet_tpu/ops/coarse.py:379-587`` after the endpoint gather,
    expression for expression.  The plain version of :func:`seg_rows`;
    returns its ``(rows, hit_counts, hit_excl, n_hits)``.

    Eager PyTorch rounds every product on its own, so the JAX pass's
    contraction barriers (``_bar``) have no counterpart here."""
    dev = sitem.device
    max_segments = sitem.shape[0]
    twf, thf = float(tile_w), float(tile_h)
    sitem_f = sitem.view(F32)
    seg_idx = torch.arange(max_segments, dtype=I32, device=dev)
    seg_valid = seg_idx < n_segs
    seg_item = sitem[:, 11]
    s_tag, s_cand_excl = sitem[:, 0], sitem[:, 3]
    s_bx0, s_by0, s_bx1, s_by1, s_bw = (sitem[:, 4], sitem[:, 5],
                                        sitem[:, 6], sitem[:, 7],
                                        sitem[:, 8])
    s_is_fill_tag = (s_tag == TAG_FILL) | (s_tag == TAG_CLIP)
    sx, sy = p0[:, 0], p0[:, 1]
    ex, ey = p1[:, 0], p1[:, 1]
    a = ey - sy
    b = sx - ex
    c = -((a * sx) + (b * sy))
    xmn = torch.minimum(p0, p1)
    xmx = torch.maximum(p0, p1)
    s_hw = 0.5 * sitem_f[:, 9] + 0.5
    is_fill_seg = seg_valid & s_is_fill_tag
    is_stroke_seg = seg_valid & ((s_tag == TAG_POLY) | (s_tag == TAG_LINE))

    # ---- per-segment emission rects ------------------------------------
    # Fill: exact solve of the reference's extent conditions (tile dims
    # are powers of two).  Stroke: the rect of the inflated segment, each
    # end probed one tile further with the per-record cull's own f32
    # expressions.  Line items: the item bbox rect.
    fx_lo = torch.floor(xmn[:, 0] / twf).to(I32)
    fx_hi = torch.ceil(xmx[:, 0] / twf).to(I32) - 1
    fy_lo = torch.floor(xmn[:, 1] / thf).to(I32)
    fy_hi = torch.floor(xmx[:, 1] / thf).to(I32)

    def _stroke_range(lo_v, hi_v, dim, step):
        lo = torch.floor(lo_v / step).to(I32)
        hi = torch.ceil(hi_v / step).to(I32) - 1

        def passes(t):
            o = t.to(F32) * step
            return (xmx[:, dim] > o - s_hw) & (xmn[:, dim] < o + step + s_hw)

        lo = torch.where(passes(lo - 1), lo - 1, lo)
        hi = torch.where(passes(hi + 1), hi + 1, hi)
        return lo, hi

    st_x_lo, st_x_hi = _stroke_range(xmn[:, 0] - s_hw, xmx[:, 0] + s_hw,
                                     0, twf)
    st_y_lo, st_y_hi = _stroke_range(xmn[:, 1] - s_hw, xmx[:, 1] + s_hw,
                                     1, thf)
    W = torch.where
    is_line_item = s_tag == TAG_LINE
    r_x_lo = W(is_fill_seg, fx_lo, W(is_line_item, s_bx0, st_x_lo))
    r_x_hi = W(is_fill_seg, fx_hi, W(is_line_item, s_bx1, st_x_hi))
    r_y_lo = W(is_fill_seg, fy_lo, W(is_line_item, s_by0, st_y_lo))
    r_y_hi = W(is_fill_seg, fy_hi, W(is_line_item, s_by1, st_y_hi))
    # Clip to the item's bbox rect (the reference's per-tile hit gate).
    r_x_lo = torch.maximum(r_x_lo, s_bx0)
    r_x_hi = torch.minimum(r_x_hi, s_bx1)
    r_y_lo = torch.maximum(r_y_lo, s_by0)
    r_y_hi = torch.minimum(r_y_hi, s_by1)
    r_w = torch.clamp(r_x_hi - r_x_lo + 1, min=0)
    r_h = torch.clamp(r_y_hi - r_y_lo + 1, min=0)
    # A fill segment with winding rows but an empty column range still
    # gets one column: its records carry the per-row crossing emission.
    widen = (is_fill_seg & (a != 0.0) & (r_w == 0) & (r_h > 0)
             & (s_bx0 <= s_bx1))
    wcol = torch.minimum(torch.maximum(fx_lo, s_bx0), s_bx1)
    r_x_lo = W(widen, wcol, r_x_lo)
    r_w = W(widen, 1, r_w)
    hit_counts = W(seg_valid, r_w * r_h, 0)
    hit_incl = torch.cumsum(hit_counts, 0, dtype=I32)
    hit_excl = hit_incl - hit_counts

    seg_flags = (is_fill_seg.to(I32) | (is_stroke_seg.to(I32) << 1)
                 | (is_line_item.to(I32) << 2))
    seg_i32 = torch.stack(
        [seg_flags, r_x_lo, r_y_lo, torch.clamp(r_w, min=1), seg_item,
         s_cand_excl, s_by0, torch.clamp(s_bw, min=1), s_bx0, s_by1,
         s_bx1], dim=1)                                  # (S, 11)
    # Per-segment constants of the division-free fine math.
    lvx = ex - sx
    lvy = ey - sy
    s_invd = div_det(1.0, dot2_det(lvx, lvy))
    s_m = div_det(lvx, lvy)
    s_K = div_det(-lvy, torch.abs(lvx))
    s_m = W(torch.abs(s_m) < _INF, s_m, 0.0)
    s_K = W(torch.abs(s_K) < _INF, s_K, 0.0)
    rows = torch.cat(
        [_bits(torch.stack([sx, sy, ex, ey, a, b, c, xmn[:, 0], xmn[:, 1],
                            xmx[:, 0], xmx[:, 1], s_hw], dim=1)),
         seg_i32,
         _bits(torch.stack([s_invd, s_m, s_K], dim=1)),
         hit_excl[:, None]], dim=1).contiguous()        # (S, 27)
    return rows, hit_counts, hit_excl, hit_incl[-1:]
