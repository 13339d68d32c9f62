"""Hit-record expansion with the exact per-tile tests (kernel B).

Port of ``piet_tpu/ops/hitfuse.py``.  Each (S, 27) segment row expands
into one record per (segment, tile in its emission rect); each record runs
the reference's exact fill and stroke sign tests, fills its two command
slots, and emits its meta word, packed sort key and folded winding delta.
Every expression is the JAX module's, in the same order.

Output: one (cap, 24) f32 array per call, 24 words per record:

  0-15   the entry words (layout/entry_stream.py word map)
  16     packed sort key: tile * stride + item * 2, +inf when dead
  17     h_cand: the record's candidate slot
  18     n_cmds (0/1/2)
  19     cexcl: the item's first candidate slot
  20     cand_end: one past the item's last candidate slot
  21     d_val: winding-delta value (+-1; 0 = no delta)
  22     d_cand: the delta's candidate slot (0 when d_val == 0)
  23     zero

Records at or past the live total are all zero with key = +inf.
The CUDA kernel is ``csrc/hitfuse.cu``; :func:`hit_records_fused_plain`
is its plain PyTorch version, bit for bit.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..layout.entry_stream import META_CLEAR_BIT
from ..raster.ptcl import CMD_FILL, CMD_FILL_EDGE, CMD_LINE
from .candfuse import fdivmod, owner_of
from .cmd_math import div_det, sign

#: Words per input segment row (ops/coarse.py seg_all + hit_excl).
SEG_WORDS = 27
OUT_WORDS = 24
K_KEY, K_CAND, K_NCMDS, K_CEXCL, K_CEND = 16, 17, 18, 19, 20
K_DVAL, K_DCAND = 21, 22

_INF = float("inf")


def f2i_sat(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 saturating, NaN -> 0 (XLA's convert)."""
    x64 = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return x64.clamp(-2147483648.0, 2147483647.0).to(torch.int32)


def split_fused(out: torch.Tensor) -> dict:
    """The (cap, 24) record array as the JAX wrapper's dict of views."""
    return {"rows": out[:, :16], "key": out[:, K_KEY],
            "h_cand": out[:, K_CAND], "n_cmds": out[:, K_NCMDS],
            "cexcl": out[:, K_CEXCL], "cand_end": out[:, K_CEND],
            "d_val": out[:, K_DVAL], "d_cand": out[:, K_DCAND]}


def hit_records_fused_plain(seg_rows, counts, excl, total, row0: int,
                            cap: int, *, tile_w: int, tile_h: int,
                            tiles_x: int, stride: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B; see :func:`hit_records_fused`."""
    f32 = torch.float32
    p, s = owner_of(excl, counts, cap)
    valid = p < total
    row = torch.where(valid[:, None], seg_rows[s], 0)
    rf = row.view(f32)
    h_sx, h_sy, h_ex, h_ey = rf[:, 0], rf[:, 1], rf[:, 2], rf[:, 3]
    h_a, h_b, h_c = rf[:, 4], rf[:, 5], rf[:, 6]
    xmn_x, xmn_y, xmx_x, xmx_y = rf[:, 7], rf[:, 8], rf[:, 9], rf[:, 10]
    h_hw = rf[:, 11]
    h_flags = row[:, 12]
    rxlo, rylo, rw = row[:, 13], row[:, 14], row[:, 15]
    h_item, cexcl = row[:, 16], row[:, 17]
    by0, bw, bx0, by1, bx1 = (row[:, 18], row[:, 19], row[:, 20],
                              row[:, 21], row[:, 22])
    h_invd, h_m, h_K = rf[:, 23], rf[:, 24], rf[:, 25]
    hexcl = row[:, 26]

    h_dy, h_dx = fdivmod(p - hexcl, torch.clamp(rw, min=1))
    h_ty = rylo + h_dy
    h_tx = rxlo + h_dx
    h_tile = (h_ty - row0) * tiles_x + h_tx
    h_cand = cexcl + (h_ty - by0) * bw + (h_tx - bx0)
    cand_end = cexcl + (by1 - by0 + 1) * bw

    twf, thf = float(tile_w), float(tile_h)
    x0f = h_tx.to(f32) * twf
    y0f = h_ty.to(f32) * thf
    h_is_fill = ((h_flags & 1) != 0) & valid
    h_is_stroke = ((h_flags & 2) != 0) & valid

    # ---- exact fill tests ----
    ycull = (xmx_y >= y0f) & (xmn_y < y0f + thf)
    left = h_a * x0f
    right = h_a * (x0f + twf)
    ytop = torch.maximum(y0f, xmn_y)
    ybot = torch.minimum(y0f + thf, xmx_y)
    top = h_b * ytop
    bot = h_b * ybot
    s00 = sign(top + left + h_c)
    s01 = sign(top + right + h_c)
    s10 = sign(bot + left + h_c)
    s11 = sign(bot + right + h_c)
    four = s00 * s01 + s00 * s10 + s00 * s11 < 3.0
    crosses_left = (xmn_x < x0f) & (xmx_x > x0f)
    t_edge = div_det(h_sx - x0f, h_b)
    y_edge = h_sy + ((h_ey - h_sy) * t_edge)
    edge_in = crosses_left & (y_edge >= y0f) & (y_edge < y0f + thf)
    plain = ((crosses_left & ~edge_in & four)
             | (~crosses_left & four & (xmn_x < x0f + twf) & (xmx_x > x0f)))
    fill_emit_edge = h_is_fill & ycull & edge_in
    fill_emit_plain = h_is_fill & ycull & plain
    bpos = h_b > 0
    clip_sx = torch.where(bpos, h_sx, x0f)
    clip_sy = torch.where(bpos, h_sy, y_edge)
    clip_ey = torch.where(bpos, y_edge, h_ey)

    # ---- exact stroke tests ----
    st_bcull = ((xmx_y > y0f - h_hw) & (xmn_y < y0f + thf + h_hw)
                & (xmx_x > x0f - h_hw) & (xmn_x < x0f + twf + h_hw))
    st_bcull = ((h_flags & 4) != 0) | st_bcull
    sleft = h_a * (x0f - h_hw)
    sright = h_a * (x0f + twf + h_hw)
    stop_ = h_b * (y0f - h_hw)
    sbot = h_b * (y0f + thf + h_hw)
    z00 = sign(stop_ + sleft + h_c)
    z01 = sign(stop_ + sright + h_c)
    z10 = sign(sbot + sleft + h_c)
    z11 = sign(sbot + sright + h_c)
    st_four = z00 * z01 + z00 * z10 + z00 * z11 < 3.0
    stroke_emit = h_is_stroke & st_bcull & st_four

    # ---- command slots + entry words ----
    slot0_valid = fill_emit_edge | stroke_emit
    slot1_valid = fill_emit_edge | fill_emit_plain
    n_cmds = slot0_valid.to(torch.int32) + slot1_valid.to(torch.int32)
    tag0 = torch.where(slot0_valid, torch.where(
        stroke_emit, float(CMD_LINE), float(CMD_FILL_EDGE)), 0.0)
    tag1 = torch.where(slot1_valid, float(CMD_FILL), 0.0)
    meta = (n_cmds + stroke_emit.to(torch.int32) * META_CLEAR_BIT).to(f32)
    key = torch.where(n_cmds > 0, (h_tile * stride + h_item * 2).to(f32),
                      _INF)

    def gate(ok, v):
        return torch.where(ok, v, 0.0)

    z = torch.zeros_like(h_sx)
    s0 = [gate(slot0_valid, torch.where(stroke_emit, v, w)) for v, w in (
        (h_sx, s00), (h_sy, y_edge), (h_ex, z), (h_ey, z), (h_hw, z),
        (h_invd, z))]
    s1 = [gate(slot1_valid, v) for v in (
        torch.where(fill_emit_edge, clip_sx, h_sx),
        torch.where(fill_emit_edge, clip_sy, h_sy),
        torch.where(fill_emit_edge, clip_ey, h_ey), h_m, h_K)]

    # ---- winding-delta emission: one crossing per (fill segment, row) ----
    del_ok = (h_is_fill & (h_a != 0.0) & (h_dx == 0) & (xmn_y <= y0f)
              & (xmx_y >= y0f) & (bx0 <= bx1))
    x_cross = -((h_b * y0f) + h_c) / h_a
    tx_guess = f2i_sat(torch.floor(x_cross / twf)) + 1
    sign_a = sign(h_a)

    def dprobe(dtx):
        x0p = (tx_guess + dtx).to(f32) * twf
        return sign((h_a * x0p) + (h_b * y0f) + h_c) == sign_a

    tx_c = torch.where(dprobe(-1), tx_guess - 1,
                       torch.where(dprobe(0), tx_guess,
                                   torch.where(dprobe(1), tx_guess + 1,
                                               tx_guess + 2)))
    tx_eff = torch.maximum(tx_c, bx0)
    d_ok = del_ok & (tx_eff <= bx1)
    d_cand = cexcl + (h_ty - by0) * bw + (tx_eff - bx0)
    d_val = torch.where(d_ok, -sign_a, 0.0)
    d_cand_f = torch.where(d_ok, d_cand.to(f32), 0.0)

    out = torch.stack(
        [tag0] + s0 + [z, tag1] + s1 + [meta, z, key, h_cand.to(f32),
                                        n_cmds.to(f32), cexcl.to(f32),
                                        cand_end.to(f32), d_val, d_cand_f, z],
        dim=1)
    # Dead records: all zero, key = +inf (the kernel's contract).
    dead = torch.zeros(OUT_WORDS, dtype=f32, device=out.device)
    dead[K_KEY] = _INF
    return torch.where(valid[:, None], out, dead)


def hit_records_fused(seg_rows, counts, excl, total, row0: int, cap: int, *,
                      tile_w: int, tile_h: int, tiles_x: int,
                      stride: int) -> torch.Tensor:
    """Expand per-segment rows into hit records and run the exact tests.

    Args:
      seg_rows: (S, 27) int32 bit patterns (renderer/segstage.py SegPre).
      counts/excl: (S,) int32 hit counts and their exclusive cumsum.
      total: () or (1,) int32 live hit count, on the device.
      row0: first tile row of the slab.
      cap: hit capacity.

    Returns the (cap, 24) f32 record array (module doc; ``split_fused``
    gives the JAX wrapper's dict of named views).
    """
    if not kernels.on_cuda(seg_rows, counts, excl, total):
        return hit_records_fused_plain(
            seg_rows, counts, excl, total, row0, cap, tile_w=tile_w,
            tile_h=tile_h, tiles_x=tiles_x, stride=stride)
    n_seg = seg_rows.shape[0]
    for name, t, shape in (("seg_rows", seg_rows, (n_seg, SEG_WORDS)),
                           ("counts", counts, (n_seg,)),
                           ("excl", excl, (n_seg,)), ("total", total, None)):
        kernels.check_cuda_tensor(t, torch.int32, name, shape)
    if total.numel() != 1:
        raise ValueError("total must hold one count")
    out = torch.empty((cap, OUT_WORDS), dtype=torch.float32,
                      device=seg_rows.device)
    kernels.launch("hitfuse", "piet_hitfuse", seg_rows.data_ptr(),
                   counts.data_ptr(), excl.data_ptr(), total.data_ptr(),
                   out.data_ptr(), n_seg, cap, tile_w, tile_h, tiles_x,
                   stride, int(row0))
    return out
