"""The coarse pass's dense tail: the sorted entry records -> each tile's
(T, CAP) command list.

The pass (``ops/coarse.py::coarse_rasterize(output="dense")``) calls
:func:`dense_tail`: on CUDA tensors one launch of ``csrc/dense_tail.cu``,
on CPU tensors its plain version :func:`dense_tail_plain` (the JAX pass's
dense tail, in PyTorch); both give the same words.  The kernel reads each
entry's meta word itself (command count, opaque, clearing), finds each
tile's entries as the one run the sort leaves them in, and writes every
output word once: no scratch, no copy, no atomics.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..layout.entry_stream import (ENTRY_WORDS, META_CLEAR_BIT,
                                   META_NCMDS_MASK, META_OPAQUE_BIT,
                                   N_S0_ARGS, N_S1_ARGS, W_META, W_S0_ARG,
                                   W_S0_TAG, W_S1_ARG, W_S1_TAG)
from ..raster.ptcl import ARG_WORDS, CMD_FILL

I32, F32 = torch.int32, torch.float32
_INF = float("inf")


def dense_tail(rows: torch.Tensor, sorted_idx: torch.Tensor,
               e_tile: torch.Tensor, c_color_bits: torch.Tensor, *,
               n_tiles: int, max_hits: int, cmd_capacity: int):
    """The dense PTCL of the sorted records, on the card.

    Args:
      rows: (E, 16) int32 sorted records, dead rows zero, 16-byte aligned.
      sorted_idx: (E,) int32 source row of each record: a hit record below
        ``max_hits``, else candidate ``sorted_idx - max_hits``.
      e_tile: (E,) int32 tile of each record, non-decreasing, the dead
        records last at ``n_tiles``.
      c_color_bits: (max_candidates,) int32 colour bits of the candidates,
        any row stride (a column of the candidate rows).

    Returns ``(tags, args, counts, solid, overflow)``: (T, CAP) int32,
    (T, CAP * 12) f32, and (T,) int32 commands kept, bail colour and
    commands dropped past CAP, as :func:`dense_tail_plain` gives them.
    The live records are those below tile ``n_tiles``.
    """
    kw = dict(n_tiles=n_tiles, max_hits=max_hits, cmd_capacity=cmd_capacity)
    if not kernels.on_cuda(rows, sorted_idx, e_tile, c_color_bits):
        return dense_tail_plain(rows, sorted_idx, e_tile, c_color_bits,
                                e_tile < n_tiles, **kw)
    n_ent = rows.shape[0]
    kernels.check_cuda_tensor(rows, I32, "rows", (n_ent, ENTRY_WORDS))
    kernels.check_cuda_tensor(sorted_idx, I32, "sorted_idx", (n_ent,))
    kernels.check_cuda_tensor(e_tile, I32, "e_tile", (n_ent,))
    if c_color_bits.dtype != I32 or c_color_bits.dim() != 1:
        raise ValueError("c_color_bits: expected a 1-D int32 tensor")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    if n_ent == 0 or cmd_capacity <= 0:
        raise ValueError("dense_tail needs records and a positive capacity")
    dev = rows.device
    tags = torch.empty((n_tiles, cmd_capacity), dtype=I32, device=dev)
    args = torch.empty((n_tiles, cmd_capacity * ARG_WORDS), dtype=I32,
                       device=dev)
    counts, solid, overflow = (torch.empty((n_tiles,), dtype=I32, device=dev)
                               for _ in range(3))
    kernels.launch("dense_tail", "piet_dense_tail", rows.data_ptr(),
                   sorted_idx.data_ptr(), e_tile.data_ptr(),
                   c_color_bits.data_ptr(), tags.data_ptr(), args.data_ptr(),
                   counts.data_ptr(), solid.data_ptr(), overflow.data_ptr(),
                   n_ent, n_tiles, cmd_capacity, max_hits,
                   c_color_bits.stride(0))
    return tags, args.view(F32), counts, solid, overflow


def meta_bits(stream16: torch.Tensor):
    """Each entry's command count, opaque bit and clearing bit, from its
    meta word (an integer-valued f32)."""
    e_meta = stream16[:, W_META].view(F32).to(I32)
    return (e_meta & META_NCMDS_MASK, (e_meta & META_OPAQUE_BIT) != 0,
            (e_meta & META_CLEAR_BIT) != 0)


def _tile_maxima(e_tile, e_is_opaque, e_is_clear, n_tiles: int):
    """Each tile's first, last, last opaque and last clearing entry, as
    index maxima of per-entry values in f32, as the JAX pass computes them
    (entry indices < 2^24 are exact).  An empty tile gives first E + 1 and
    last -(E + 2); no opaque entry -1, no clearing one -2."""
    E = e_tile.shape[0]
    dev = e_tile.device
    seg_tile = torch.clamp(e_tile, max=n_tiles).long()
    eidx_f = torch.arange(E, dtype=F32, device=dev)
    packed = torch.stack(
        [-eidx_f - 1.0, eidx_f,
         e_is_opaque.to(F32) * (eidx_f + 1.0) - 1.0,
         e_is_clear.to(F32) * (eidx_f + 2.0) - 2.0], dim=1)
    red_f = torch.full((n_tiles + 1, 4), -_INF, dtype=F32, device=dev)
    red_f.scatter_reduce_(0, seg_tile[:, None].expand(E, 4), packed, "amax",
                          include_self=False)
    red = torch.clamp(red_f[:n_tiles], min=float(-(E + 2))).to(I32)
    return (-red[:, 0] - 1, red[:, 1], torch.clamp(red[:, 2], min=-1),
            torch.clamp(red[:, 3], min=-2))


def dense_tail_plain(rows, sorted_idx, e_tile, c_color_bits, live, *,
                     n_tiles: int, max_hits: int, cmd_capacity: int):
    """The sorted records -> dense (T, CAP) command lists: a port of the
    dense tail of ``piet_tpu/ops/coarse.py`` (per-tile f32 index maxima,
    command positions, the bail, and the two slot scatters).  The plain
    version of :func:`dense_tail`; returns its ``(tags, args, counts,
    solid, overflow)``.

    ``rows`` are the sorted (E, 16) int32 records with dead rows zeroed.
    A hit record's slot 0 is its FillEdge or Line (operand words 0-6; the
    rest are zero), slot 1 its Fill (words 0-4); a candidate record's
    slot 0 is its tail command with all 12 operand words (word 7 rides in
    the record's slot-1 tag word, the clip rect or second stop in words
    9-12).  Rows are assembled as int32 bit patterns: tags as f32 bits
    would be denormals, and operand words carry NaN payloads."""
    dev = rows.device
    E = rows.shape[0]
    cap = cmd_capacity
    rows_f = rows.view(F32)
    e_ncmds, e_is_opaque, e_is_clear = meta_bits(rows)
    first_raw, last_raw, opq_e, clr_e = _tile_maxima(
        e_tile, e_is_opaque, e_is_clear, n_tiles)
    has_entries = last_raw >= 0
    first_c = torch.clamp(first_raw, 0, E - 1).long()
    last_c = torch.clamp(last_raw, 0, E - 1).long()
    cpos_excl = torch.cumsum(e_ncmds, 0, dtype=e_ncmds.dtype) - e_ncmds
    tile_cmd_base = torch.where(has_entries, cpos_excl[first_c], 0)
    tile_cmd_total = torch.where(
        has_entries, cpos_excl[last_c] + e_ncmds[last_c] - tile_cmd_base, 0)
    best_entry = torch.clamp(opq_e, min=0).long()
    e_tile_c = torch.clamp(e_tile, max=n_tiles - 1).long()
    e_pos = cpos_excl - tile_cmd_base[e_tile_c]

    # ---- the bail and each tile's kept command range -------------------
    bail = clr_e < opq_e
    last_opaque = torch.where(opq_e >= 0, e_pos[best_entry], -1)
    cidx = torch.clamp(sorted_idx - max_hits, min=0).long()
    best_color = c_color_bits[cidx[best_entry]]
    solid = torch.where(bail, torch.where(last_opaque >= 0, best_color, -1),
                        0)
    start = torch.where(bail, 0, torch.where(last_opaque >= 0, last_opaque,
                                             0))
    count_post = torch.where(bail, 0, tile_cmd_total - start)
    overflow = torch.clamp(count_post - cap, min=0)
    counts = torch.clamp(count_post, max=cap)

    # ---- the two slot scatters into (T * CAP + 1, 13) rows -------------
    src_is_hit = sorted_idx < max_hits
    tag0 = rows_f[:, W_S0_TAG].to(I32)
    s0_valid = tag0 != 0
    s1_valid = src_is_hit & (rows_f[:, W_S1_TAG] == float(CMD_FILL))
    zeros = torch.zeros((E, 12 - N_S0_ARGS), dtype=I32, device=dev)
    hit_args = torch.cat([rows[:, W_S0_ARG:W_S0_ARG + N_S0_ARGS], zeros], 1)
    s0_args = torch.where(src_is_hit[:, None], hit_args,
                          rows[:, W_S0_ARG:W_S0_ARG + 12])
    s1_args = torch.cat([rows[:, W_S1_ARG:W_S1_ARG + N_S1_ARGS],
                         torch.zeros((E, 12 - N_S1_ARGS), dtype=I32,
                                     device=dev)], 1)
    rel = e_pos - start[e_tile_c]
    tile_ok = live & ~bail[e_tile_c]
    tile_n = counts[e_tile_c]
    dump = n_tiles * cap
    out_rows = torch.zeros((dump + 1, 13), dtype=I32, device=dev)

    def scatter_slot(slot_off, valid, tag, args):
        pos = rel + slot_off
        ok = valid & tile_ok & (pos >= 0) & (pos < tile_n)
        # Every dead slot writes the dump row, which is dropped; live
        # positions are unique, so which duplicate wins there is moot.
        flat = torch.where(ok, e_tile_c * cap + pos, dump)
        row = torch.cat([torch.where(ok, tag, 0)[:, None],
                         torch.where(ok[:, None], args, 0)], 1)
        out_rows[flat] = row

    # A fill hit without a slot-0 command places its Fill at rel + 0.
    scatter_slot(0, s0_valid | s1_valid,
                 torch.where(s0_valid, tag0, CMD_FILL),
                 torch.where(s0_valid[:, None], s0_args, s1_args))
    scatter_slot(1, s0_valid & s1_valid, torch.full_like(tag0, CMD_FILL),
                 s1_args)
    tags = out_rows[:dump, 0].reshape(n_tiles, cap).contiguous()
    args = out_rows[:dump, 1:].reshape(n_tiles, cap * 12).contiguous()
    return (tags, args.view(F32), counts.to(I32), solid.to(I32),
            overflow.to(I32))
