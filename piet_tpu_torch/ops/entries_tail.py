"""The coarse pass's entries tail: the sorted entry stream -> its ``W_RUN``
run words, and each tile's entry range, command count and bail.

The pass (``ops/coarse.py::coarse_rasterize(output="entries")``) calls
:func:`entries_tail`: on CUDA tensors one launch of
``csrc/entries_tail.cu``, on CPU tensors its plain version
:func:`entries_tail_plain` (the JAX pass's entries tail, in PyTorch); both
give the same words.  The kernel reads each entry's tags and meta word
itself, finds each tile's entries as the one run the sort leaves them in,
and writes the run words into the stream in place: no scratch, no global
scan, no atomics.  An unpaired stream gets its run words (``run_words``);
a paired one (ops/pairing.py) keeps its words and takes the per-tile half
alone.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..layout.entry_stream import (ENTRY_WORDS, RUN_CAP, W_BAIL, W_RUN,
                                   W_S0_TAG, W_S1_TAG)
from ..raster.ptcl import CMD_FILL, CMD_LINE
from .dense_tail import meta_bits

I32, F32 = torch.int32, torch.float32


def _check(stream16: torch.Tensor, e_tile: torch.Tensor, n_tiles: int):
    """Raise unless the shapes and ``n_tiles`` are ones the tail takes:
    its run-word keys, class * (n_tiles + 1) + tile in f32, must be exact."""
    if stream16.dtype != I32 or stream16.dim() != 2 or \
            stream16.shape[1] != ENTRY_WORDS:
        raise ValueError(f"stream16: expected (E, {ENTRY_WORDS}) int32, got "
                         f"{tuple(stream16.shape)} {stream16.dtype}")
    if e_tile.dtype != I32 or tuple(e_tile.shape) != stream16.shape[:1]:
        raise ValueError(f"e_tile: expected ({stream16.shape[0]},) int32, "
                         f"got {tuple(e_tile.shape)} {e_tile.dtype}")
    if stream16.shape[0] == 0 or n_tiles <= 0 \
            or 3 * (n_tiles + 1) > 2 ** 24:
        raise ValueError(f"entries_tail needs entries and 0 < n_tiles <= "
                         f"{2 ** 24 // 3 - 1}: {stream16.shape[0]} entries, "
                         f"n_tiles {n_tiles}")


def entries_tail(stream16: torch.Tensor, e_tile: torch.Tensor, *,
                 n_tiles: int, run_words: bool):
    """The entry stream's run words and per-tile ranges, on the card.

    Args:
      stream16: (E, 16) int32 sorted entries, dead rows last.
      e_tile: (E,) int32 tile of each entry, non-decreasing, the dead
        entries at ``n_tiles``.
      run_words: write each entry's ``W_RUN`` word (an unpaired stream);
        False leaves the stream's words as they are (a paired one).

    Returns ``(stream, first, n_entries, counts, solid)``: the (E, 16)
    int32 stream with its run words (on the card ``stream16`` itself,
    written in place), and (T,) int32 first live entry, live entries,
    live commands and bail colour (-1 a bail without one, 0 none), as
    :func:`entries_tail_plain` gives them.
    """
    _check(stream16, e_tile, n_tiles)
    kw = dict(n_tiles=n_tiles, run_words=run_words)
    if not kernels.on_cuda(stream16, e_tile):
        return entries_tail_plain(stream16, e_tile, **kw)
    n_ent = stream16.shape[0]
    kernels.check_cuda_tensor(stream16, I32, "stream16",
                              (n_ent, ENTRY_WORDS))
    kernels.check_cuda_tensor(e_tile, I32, "e_tile", (n_ent,))
    first, n_live, counts, solid = torch.empty(
        (4, n_tiles), dtype=I32, device=stream16.device).unbind(0)
    kernels.launch("entries_tail", "piet_entries_tail", stream16.data_ptr(),
                   e_tile.data_ptr(), first.data_ptr(), n_live.data_ptr(),
                   counts.data_ptr(), solid.data_ptr(), n_ent, n_tiles,
                   int(run_words))
    return stream16, first, n_live, counts, solid


def entries_tail_plain(stream16, e_tile, *, n_tiles: int, run_words: bool):
    """The run words, per-tile ranges, command totals and bail of the JAX
    pass's entries output (``piet_tpu/ops/coarse.py``), in PyTorch: the
    plain version of :func:`entries_tail`; returns its ``(stream, first,
    n_entries, counts, solid)``, the stream a new tensor."""
    dev = stream16.device
    E = stream16.shape[0]
    W = torch.where
    if run_words:
        stream16 = _run_words(stream16, e_tile < n_tiles, e_tile, n_tiles)
    e_ncmds, e_is_opaque, e_is_clear = meta_bits(stream16)

    # ---- per-tile ranges, command totals and the bail ------------------
    c = torch.cumsum(e_ncmds, 0, dtype=e_ncmds.dtype)
    cpos_excl, cpos_incl = c - e_ncmds, c
    eidx = torch.arange(E, dtype=I32, device=dev)
    seg_tile = torch.clamp(e_tile, max=n_tiles).contiguous()
    bnd_t = torch.searchsorted(
        seg_tile, torch.arange(n_tiles + 1, dtype=I32, device=dev),
        side="left").to(I32)
    first_t = bnd_t[:-1]
    n_ent = bnd_t[1:] - first_t
    has_entries = n_ent > 0
    first_raw = W(has_entries, first_t, E + 1)
    last_raw = W(has_entries, first_t + n_ent - 1, -1)
    first_c = torch.clamp(first_raw, 0, E - 1)
    last_c = torch.clamp(last_raw, 0, E - 1).long()
    cpos_ext = torch.cat([cpos_excl, cpos_incl[-1:]])
    cmd_b = cpos_ext[bnd_t[:-1].long()]
    tile_cmd_base = W(has_entries, cmd_b, 0)
    tile_cmd_total = W(has_entries, cpos_ext[bnd_t[1:].long()] - cmd_b, 0)
    gm_opq = torch.cummax(W(e_is_opaque, eidx, -1), 0).values
    gm_clr = torch.cummax(W(e_is_clear, eidx, -2), 0).values
    opq_t = W(has_entries, gm_opq[last_c], -1)
    opq_e = W(opq_t >= first_raw, opq_t, -1)
    clr_t = W(has_entries, gm_clr[last_c], -2)
    clr_e = W(clr_t >= first_raw, clr_t, -2)
    best_entry = torch.clamp(opq_e, min=0)
    last_opaque = W(opq_e >= 0,
                    cpos_excl[best_entry.long()] - tile_cmd_base, -1)

    bail = clr_e < opq_e
    best_color = stream16[best_entry.long(), W_BAIL]
    solid = W(bail, W(last_opaque >= 0, best_color, -1), 0)
    start = W(bail, 0, W(last_opaque >= 0, last_opaque, 0))
    count_post = W(bail, 0, tile_cmd_total - start)

    first_live = W(last_opaque >= 0, best_entry, first_c)
    n_live = W(bail | ~has_entries, 0, last_raw - first_live + 1)
    first_live = W(n_live > 0, first_live, 0)
    return (stream16, first_live.to(I32), n_live.to(I32),
            count_post.to(I32), solid.to(I32))


def _run_words(stream16: torch.Tensor, live: torch.Tensor,
               e_tile: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """``stream16`` with its ``W_RUN`` words: the remaining length of each
    entry's streak of same-class (plain fill or line) entries in its tile,
    + for fills, - for lines, 0 elsewhere."""
    dev = stream16.device
    E = stream16.shape[0]
    W = torch.where
    sf = stream16.view(F32)
    t0w = sf[:, W_S0_TAG]
    t1w = sf[:, W_S1_TAG]
    run_pf = live & (t0w == 0.0) & (t1w == float(CMD_FILL))
    run_ln = live & (t0w == float(CMD_LINE)) & (t1w == 0.0)
    clsf = W(run_pf, 1.0, W(run_ln, 2.0, 0.0))
    tkey = clsf * float(n_tiles + 1) + torch.clamp(e_tile, max=n_tiles).to(
        F32)
    prev = torch.cat([torch.full((1,), -1.0, device=dev), tkey[:-1]])
    eidxf = torch.arange(E, dtype=F32, device=dev)
    bnd = W(tkey != prev, eidxf, float(E))
    nxt = torch.flip(torch.cummin(torch.flip(bnd, [0]), 0).values, [0])
    next_b = torch.cat([nxt[1:], torch.full((1,), float(E), device=dev)])
    run_len = torch.clamp(next_b - eidxf, max=float(RUN_CAP))
    w_run = W(run_pf, run_len, W(run_ln, -run_len, 0.0))
    return torch.cat([stream16[:, :W_RUN], w_run.view(I32)[:, None]], dim=1)
