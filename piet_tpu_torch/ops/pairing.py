"""Entry pairing: two same-class records of one (tile, item) group in one
16-word entry.

Port of ``piet_tpu/ops/pairing.py``.  The two entry classes that fill only
half a record -- a plain Fill (slot 1 only) and a Line (slot 0 only) --
pair up: two ADJACENT same-class entries of the same sort key merge into
one entry, F2 (the first fill moves to slot 0, the second lands in slot 1)
or L2 (the second line lands in slot 1, its words [sx, sy, ex, ey,
inv_denom] = slot-0 words [0, 1, 2, 3, 5] in slot-1 words 0..4).  Kernel D's
paired instantiation (``csrc/fine.cu``) applies slot 0 before slot 1, the
oracle's accumulation order, so the image does not change.  Runs of
pairable entries pair (0, 1), (2, 3), ...: the alternating rule, found
from each entry's parity within its run.  Command counts do not change: a
merged entry carries 2.

Two modes: ``"compact"`` drops the merged seconds stably (the live prefix
shrinks), ``"hole"`` zeroes them in place (an all-zero entry matches no
class in the fine kernel).  On a CUDA device the compaction is one call of
the expand kernel (``csrc/expand.cu``): keeping rows with 0/1 counts is a
ragged expansion.  :func:`compact_rows_plain`, the JAX module's scatter
and gather, is its plain version.

Rows are int32 bit patterns, as in the coarse pass; the merged words are
the JAX module's, bit for bit (tests/test_torch_pairing.py).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..layout.entry_stream import (W_META, W_S0_ARG, W_S0_TAG, W_S1_ARG,
                                   W_S1_TAG)
from ..raster.ptcl import CMD_FILL, CMD_LINE
from .expand import expand_rows

F32, I32 = torch.float32, torch.int32

#: The pairing modes; ``True`` and ``False`` stand for "compact" and "off".
PAIR_MODES = ("off", "compact", "hole")


def pair_mode_from_env(default: str = "off") -> str:
    """The ``PIET_PAIR`` knob: 0 = off, 1 = compact, or a mode by name.
    Read by the renderer and the profiler, so both run the same pass."""
    v = os.environ.get("PIET_PAIR", default)
    return {"0": "off", "1": "compact"}.get(v, v)


def resolve_pair_mode(pair) -> str:
    """``pair`` as one of :data:`PAIR_MODES`; raises for anything else."""
    mode = {True: "compact", False: "off"}.get(pair, pair)
    if mode not in PAIR_MODES:
        raise ValueError(f"unknown pair mode {pair!r}")
    return mode


class PairedEntries(NamedTuple):
    rows: torch.Tensor         # (E, 16) int32 bits, dead slots all-zero
    live: torch.Tensor         # (E,) bool
    e_tile: torch.Tensor       # (E,) int32, dead slots == n_tiles
    e_ncmds: torch.Tensor      # (E,) int32 (merged entries carry 2)
    e_is_opaque: torch.Tensor  # (E,) bool
    e_is_clear: torch.Tensor   # (E,) bool


def _f32_bits(v: float) -> int:
    return int(torch.tensor(v, dtype=F32).view(I32))


def compact_rows_plain(bundle: torch.Tensor,
                       keep: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`compact_rows`: each kept row's position by
    a cumulative sum, a scatter of its index, a gather."""
    E = bundle.shape[0]
    keep_i = keep.to(I32)
    pos = torch.cumsum(keep_i, 0, dtype=I32) - keep_i
    idx = torch.arange(E, dtype=I32, device=bundle.device)
    pos_idx = torch.zeros((E + 1,), dtype=I32, device=bundle.device)
    pos_idx[torch.where(keep, pos, E).long()] = idx
    live = idx < keep_i.sum()
    return torch.where(live[:, None], bundle[pos_idx[:E].long()], 0)


def compact_rows(bundle: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The kept rows of ``bundle`` (E, W) int32 in order, then all-zero
    rows: on a CUDA device one call of the expand kernel with 0/1 counts."""
    if not kernels.on_cuda(bundle, keep):
        return compact_rows_plain(bundle, keep)
    return expand_rows(bundle, keep.to(I32), bundle.shape[0])


def pair_entries(rows: torch.Tensor, keys: Tuple[torch.Tensor, ...],
                 live: torch.Tensor, e_tile: torch.Tensor,
                 e_ncmds: torch.Tensor, e_is_opaque: torch.Tensor,
                 e_is_clear: torch.Tensor, n_tiles: int,
                 mode: str = "compact", taps=None) -> PairedEntries:
    """Merge adjacent pairable entries; compact or hole out the seconds.

    Args:
      rows: (E, 16) int32 bits of the sorted entries (dead rows zero).
      keys: the sort keys, each (E,) f32: equal keys = one (tile, item,
        class) group.
      live, e_tile, e_ncmds, e_is_opaque, e_is_clear: per-entry metadata
        in sorted order.
      n_tiles: the tile count (the dead entries' tile).
      mode: "compact" or "hole" (module doc).
      taps: optional dict; "pairing" receives the compaction's
        (bundle, keep) under "compact".

    Returns :class:`PairedEntries` of the same capacity.
    """
    dev = rows.device
    E, words = rows.shape
    idx = torch.arange(E, dtype=I32, device=dev)
    rf = rows.view(F32)
    tag0 = rf[:, W_S0_TAG]
    tag1 = rf[:, W_S1_TAG]
    pf = live & (tag0 == 0.0) & (tag1 == float(CMD_FILL))
    ln = live & (tag0 == float(CMD_LINE)) & (tag1 == 0.0)
    cls = torch.where(pf, 1, torch.where(ln, 2, 0))

    def prev(x):
        return torch.cat([x[:1], x[:-1]])

    same_key = idx > 0
    for k in keys:
        same_key &= k == prev(k)
    pairable = (cls > 0) & (cls == prev(cls)) & same_key

    # Run-position parity: positions 1, 3, 5, ... of each maximal
    # pairable chain are seconds.
    run_start = (cls > 0) & ~pairable
    start_idx = torch.cummax(torch.where(run_start, idx, -1), 0).values
    pos_in_run = idx - start_idx
    is_second = (cls > 0) & (start_idx >= 0) & (pos_in_run % 2 == 1)
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    has_partner = torch.cat([is_second[1:], no])

    # The partner is always the next entry: a shift, not a gather.
    nxt = torch.cat([rows[1:], torch.zeros((1, words), dtype=I32,
                                           device=dev)])
    mpf = (has_partner & pf)[:, None]
    mln = (has_partner & ln)[:, None]
    s0 = slice(W_S0_ARG, W_S0_ARG + 5)
    s1 = slice(W_S1_ARG, W_S1_ARG + 5)
    # The partner line's slot-0 words 0, 1, 2, 3 and 5 (slices: an index
    # list would be a host copy, which a CUDA graph capture refuses).
    part_ln = torch.cat([nxt[:, W_S0_ARG:W_S0_ARG + 4],
                         nxt[:, W_S0_ARG + 5:W_S0_ARG + 6]], dim=1)
    col0 = torch.where(mpf, rows[:, s1], rows[:, s0])
    col1 = torch.where(mpf, nxt[:, s1], torch.where(mln, part_ln,
                                                    rows[:, s1]))
    fill, line = _f32_bits(float(CMD_FILL)), _f32_bits(float(CMD_LINE))
    t0 = torch.where(mpf[:, 0], fill, rows[:, W_S0_TAG])
    t1 = torch.where(mpf[:, 0], fill,
                     torch.where(mln[:, 0], line, rows[:, W_S1_TAG]))
    # Meta ncmds 1 -> 2 (the pair's other meta bits are equal).
    meta = (rf[:, W_META] + has_partner.to(F32)).view(I32)
    merged = torch.cat([t0[:, None], col0, rows[:, W_S0_ARG + 5:W_S1_TAG],
                        t1[:, None], col1, meta[:, None],
                        rows[:, W_META + 1:]], dim=1)
    mncmds = e_ncmds + has_partner.to(I32)

    if mode == "hole":
        # In place: the second becomes an all-zero entry and keeps its
        # tile, so tile ranges stay contiguous; a pair is never opaque, so
        # the bail does not move across one.
        return PairedEntries(
            rows=torch.where(is_second[:, None], 0, merged), live=live,
            e_tile=e_tile, e_ncmds=torch.where(is_second, 0, mncmds),
            e_is_opaque=e_is_opaque & ~is_second,
            e_is_clear=e_is_clear & ~is_second)
    if mode != "compact":
        raise ValueError(f"unknown pair mode {mode!r}")

    keep = live & ~is_second
    new_live = idx < keep.to(I32).sum()
    bundle = torch.cat([merged, e_tile.to(I32)[:, None], mncmds[:, None],
                        e_is_opaque.to(I32)[:, None],
                        e_is_clear.to(I32)[:, None]], dim=1).contiguous()
    if taps is not None:
        taps["pairing"] = (bundle, keep)
    out = compact_rows(bundle, keep)
    return PairedEntries(
        rows=torch.where(new_live[:, None], out[:, :words], 0),
        live=new_live,
        e_tile=torch.where(new_live, out[:, words], n_tiles),
        e_ncmds=torch.where(new_live, out[:, words + 1], 0),
        e_is_opaque=new_live & (out[:, words + 2] != 0),
        e_is_clear=new_live & (out[:, words + 3] != 0))
