"""Coarse binning: staged scene -> PTCL (entry stream or dense), in PyTorch.

Port of ``piet_tpu/ops/coarse.py::coarse_rasterize``: the segment stage --
host-staged (``seg_pre``, renderer/segstage.py) or derived on the device
from the scene's points (``seg_pre=None``, the device-animation path:
:func:`derive_seg_stage`) -- then the fused-record route: kernel A (the
item rows and their candidate expansion), kernel B (hit records), keyed
sums, the backdrop prefix, the entry rows and sort keys (the hit records'
words and the candidates' tail commands, ops/cand_rows.py), one stable
sort (kernel C) and the sorted gather.  ``output="entries"`` then adds the
``W_RUN`` run words, per-tile ranges and the bail (``ops/entries_tail.py``);
``output="dense"`` scatters the records into (T, CAP) command lists
(``ops/dense_tail.py``).
Each stage is one call, and each called op picks its kernel or its plain
version from its tensors' device (``kernels.on_cuda``).
Both outputs are word for word the JAX pass's
(tests/test_torch_coarse.py, tests/test_torch_dense.py).

The fused route is taken for every scene: the JAX package gates it on by
a record count measured on the TPU, but the fused and staged routes are
bitwise identical, so the port drops the gate.  The same holds for the
JAX pass's optional engines: the port always takes ``expand_rows``
(ops/expand.py), the keyed sums (ops/keyed.py) and the row gather
(ops/gatherm.py: the endpoint fetch and the backdrop, each one call), in
both branches, and the derived segment stage's rows are one call
(ops/seg_rows.py), as are the entry rows and keys (ops/cand_rows.py).
Where the packed sort key ``tile * 2*(NI+1) + item*2 + class`` would
reach 2^24 (inexact in f32), the sort takes two keys, (tile, item*2 +
class), as the JAX pass does.  Entry pairing
(``pair="compact"`` or ``"hole"``, ``PIET_PAIR`` in the renderer) runs
``ops/pairing.py::pair_entries`` on the sorted entries, as the JAX pass
does.

Bit patterns: candidate rows, segment rows, the bail colour and the entry
rows travel as int32.  Colours are NaN patterns as f32 and several words
are integers or denormal patterns, so they only move through gathers,
selects and concatenations of int32 views, never through float
arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..layout.entry_stream import ENTRY_WORDS
from ..scene.scene import TAG_CLIP, TAG_FILL, TAG_LINE, TAG_POLY
from .cand_rows import cand_rows
from .candfuse import cand_prep_expand
from .dense_tail import dense_tail, meta_bits
from .entries_tail import entries_tail
from .expand import expand_rows
from .gatherm import backdrop_from_csum, gather_endpoints
from .hitfuse import hit_records_fused
from .keyed import record_keyed_sums
from .pairing import pair_entries, resolve_pair_mode
from .seg_rows import seg_rows
from .sort import stable_sort_multi

_INF = float("inf")
F32, I32 = torch.float32, torch.int32

#: The stages of the pass, in order, under the JAX pass's probe names
#: (``piet_tpu/profiling.py::STAGE_ORDER``).  A stage's probe holds its
#: output tensors.  Where one kernel
#: does several JAX stages, the probe stands after the kernel under the
#: group's first name: kernel A is "cand_expand"; kernel B "hit_expand"
#: (JAX's "hit_gather" and "hit_tests" too); the one-call keyed sums
#: "cand_emit" (and "del_scatter"); the segment rows' call (ops/seg_rows.py)
#: "seg_derive" (and "seg_rects", whose probe follows it with no device
#: op between).  "tile_reduce" runs to the end of the
#: pass (the bail, and on the dense route the dense tail).  The entries
#: tail's call (ops/entries_tail.py) writes the run words and the per-tile
#: outputs at once: "runs" stands after it on an unpaired pass, and
#: "tile_reduce" holds it on a paired one.  The
#: segment stages ("seg_expand" .. "seg_rects") run only where the
#: segments are derived on the device; "pairing" only on a paired entries
#: pass, "runs" only on an unpaired one.
PROBE_STAGES = ("cand_expand", "seg_expand", "seg_points", "seg_derive",
                "seg_rects", "hit_expand", "cand_emit", "deltas", "rows",
                "sort", "sorted_gather", "pairing", "runs", "tile_reduce")


class _StopAfter(Exception):
    """Raised by a probe to end the pass right after stage ``upto``."""


class _Probes:
    """The pass's stage probes: off (no probe is kept), or an ordered dict
    name -> the stage's output tensors, the pass ending after ``upto``;
    ``keep``: every stage's probe outlives the pass (``with_probes``)."""

    def __init__(self, on: bool, upto: Optional[str]):
        if upto is not None and upto not in PROBE_STAGES:
            raise ValueError(f"unknown stage {upto!r}; stages: "
                             f"{PROBE_STAGES}")
        self.found = {} if (on or upto is not None) else None
        self.keep = on
        self.upto = upto

    def __call__(self, name: str, *vals: torch.Tensor) -> None:
        tracing.mark(name)
        if self.found is None:
            return
        self.found[name] = vals
        if name == self.upto:
            raise _StopAfter(name)


_NO_PROBES = _Probes(False, None)


class SegPre(NamedTuple):
    """The segment stage on the device: staged from the host
    (renderer/segstage.py) or derived by :func:`derive_seg_stage`.
    ``seg_rows`` holds int32 bit patterns."""
    seg_rows: torch.Tensor    # (S, 27) int32
    hit_counts: torch.Tensor  # (S,) int32
    hit_excl: torch.Tensor    # (S,) int32
    n_segs: torch.Tensor      # (1,) int32
    n_hits: torch.Tensor      # (1,) int32


class DeviceScene(NamedTuple):
    """Capacity-padded scene tensors on one device (see
    renderer/renderer.py::prepare_scene).  ``colors_u32`` and ``flags``
    hold their uint32 bit patterns as int32."""
    tags: torch.Tensor        # (NI,) int32, 0 = padding
    colors_u32: torch.Tensor  # (NI,) int32 bits of logical 0xRRGGBBAA
    colors_lin: torch.Tensor  # (NI, 4) f32 linear r, g, b + alpha
    widths: torch.Tensor      # (NI,) f32
    bboxes: torch.Tensor      # (NI, 4) int32 quantized
    pt_offset: torch.Tensor   # (NI,) int32
    n_pts: torch.Tensor       # (NI,) int32
    points: torch.Tensor      # (NP, 2) f32
    flags: torch.Tensor       # (NI,) int32 bits
    clips: torch.Tensor       # (NI, 4) f32 clip rect
    grads: torch.Tensor       # (NI, 8) f32 gradient payload
    n_items: torch.Tensor     # () int32
    seg_pre: Optional[SegPre] = None


class CoarseOutput(NamedTuple):
    """Dense PTCL: each tile's command list, capacity-padded.  Row ``t`` of
    ``args`` holds ``CAP`` commands of ``ARG_WORDS`` = 12 operand words."""
    tags: torch.Tensor        # (T, CAP) int32
    args: torch.Tensor        # (T, CAP * 12) f32
    counts: torch.Tensor      # (T,) int32 live commands (capped at CAP)
    solid: torch.Tensor       # (T,) int32 bits of the bail colour, 0 = none
    overflow: torch.Tensor    # (T,) int32 commands dropped past CAP
    diag: dict


class CoarseEntries(NamedTuple):
    """Entry-stream PTCL: the sorted records and per-tile ranges.

    ``stream`` is entry-major, one 64-byte record per entry (the JAX pass
    packs 128 entries per (16, 128) block; :func:`stream_to_jax_layout`
    converts)."""
    stream: torch.Tensor      # (E, 16) f32
    first: torch.Tensor       # (T,) int32 first live entry (post bail)
    n_entries: torch.Tensor   # (T,) int32 live entries
    counts: torch.Tensor      # (T,) int32 live commands (diagnostics)
    solid: torch.Tensor       # (T,) int32 bits of the bail colour, 0 = none
    diag: dict


def stream_to_jax_layout(stream: torch.Tensor) -> torch.Tensor:
    """(E, 16) entry-major -> the JAX (E/128, 16, 128) block layout."""
    E = stream.shape[0]
    return stream.reshape(E // 128, 128, ENTRY_WORDS).transpose(1, 2)


def stream_from_jax_layout(blocks: torch.Tensor) -> torch.Tensor:
    """The JAX (E/128, 16, 128) block layout -> (E, 16) entry-major."""
    nb = blocks.shape[0]
    return blocks.transpose(1, 2).reshape(nb * 128, ENTRY_WORDS).contiguous()


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(I32)


def _exclusive_cumsum(x: torch.Tensor):
    c = torch.cumsum(x, 0, dtype=x.dtype)
    return c - x, c


def derive_seg_stage(scene: DeviceScene, item_pack: torch.Tensor, *,
                     tile_w: int, tile_h: int, max_segments: int,
                     taps: Optional[dict] = None,
                     probe: _Probes = _NO_PROBES) -> SegPre:
    """The segment stage derived on the device (``seg_pre=None``): a port
    of ``piet_tpu/ops/coarse.py:379-587``, expression for expression.

    ``item_pack`` is the (NI, 9) int32 item block of the candidate rows
    (tags masked to live items, n_pts, pt_offset, cand_excl, bx0, by0,
    bx1, by1, bw).  Returns the SegPre that ``build_seg_pre`` stages from
    the host: the (S, 27) segment rows as int32 bits, bitwise equal to
    the host's on every live segment, and the hit counts.  (Dead rows,
    which no record reads, keep the JAX device pass's words where the
    host stage writes zeros.)  The item glue, the expansion
    (ops/expand.py) and the endpoint gather (ops/gatherm.py) come first;
    the rows, the hit counts and their scan are one call of
    ops/seg_rows.py.  ``probe``: the pass's stage probes (see
    :func:`coarse_rasterize`).
    """
    dev = item_pack.device
    NI = item_pack.shape[0]
    tags = item_pack[:, 0]
    # Fill items: n wrap-around segments; poly: n-1; line: 1; circle: 0.
    is_fill_item = (tags == TAG_FILL) | (tags == TAG_CLIP)
    seg_counts = torch.where(
        is_fill_item, scene.n_pts,
        torch.where(tags == TAG_POLY, torch.clamp(scene.n_pts - 1, min=0),
                    torch.where(tags == TAG_LINE, 1, 0))).to(I32)
    seg_excl, seg_incl = _exclusive_cumsum(seg_counts)
    n_segs = seg_incl[-1:]
    np_max = scene.points.shape[0] - 1
    # The item's first point rides the expansion row (words 12-13): the
    # fill wrap-around endpoint.
    first_pt = scene.points[torch.clamp(scene.pt_offset, 0, np_max).long()]
    item_ids = torch.arange(NI, dtype=I32, device=dev)
    item_rows = torch.cat(
        [item_pack, _bits(scene.widths)[:, None], seg_excl[:, None],
         item_ids[:, None], _bits(first_pt)], dim=1).contiguous()  # (NI, 14)
    if taps is not None:
        taps["expand"] = (item_rows, seg_counts, max_segments, seg_excl)
    sitem = expand_rows(item_rows, seg_counts, max_segments, seg_excl)
    probe("seg_expand", sitem)
    # Endpoints, one gatherm call: points at i0 = pt_offset + (slot - the
    # item's first slot) and i0 + 1, the fill wrap-around from the carried
    # first point, +0.0 on dead slots.  (The JAX package refuses the
    # expand and gatherm engines in one executable: a workaround for an
    # XLA:TPU miscompile, with no CUDA counterpart.)
    if taps is not None:
        taps.setdefault("gatherm", []).append(
            ("endpoints", (sitem, scene.points, n_segs)))
    p0, p1 = gather_endpoints(sitem, scene.points, n_segs)
    probe("seg_points", p0, p1)
    # The rows, the hit counts, their scan and total: one call of
    # ops/seg_rows.py (one kernel call on the card).  The probes hold views
    # of its rows: the line, the bounds, the counts and offsets.
    seg_kw = dict(tile_w=tile_w, tile_h=tile_h)
    if taps is not None:
        taps["seg_rows"] = ((sitem, p0, p1, n_segs), seg_kw)
    rows, hit_counts, hit_excl, n_hits = seg_rows(sitem, p0, p1, n_segs,
                                                  **seg_kw)
    rows_f = rows.view(F32)
    probe("seg_derive", rows_f[:, 4], rows_f[:, 5], rows_f[:, 6],
          rows_f[:, 7:9], rows_f[:, 9:11])
    probe("seg_rects", hit_counts, hit_excl)
    return SegPre(seg_rows=rows, hit_counts=hit_counts, hit_excl=hit_excl,
                  n_segs=n_segs, n_hits=n_hits)


def sort_key_bounds(n_tiles: int, n_items: int) -> tuple:
    """The bounds of the pass's sort keys for ``n_tiles`` tiles and
    ``n_items`` item slots: the packed key tile * 2*(NI+1) + item*2 +
    class where it stays below 2^24 (exact in f32), else the two unpacked
    keys (tile, item*2 + class), each exact on its own."""
    stride = 2 * (n_items + 1)
    if n_tiles * stride < 2 ** 24:
        return (n_tiles * stride,)
    return (n_tiles, 2 * n_items + 2)


def coarse_rasterize(scene: DeviceScene, *, tiles_x: int, tiles_y: int,
                     tile_w: int, tile_h: int, max_segments: int,
                     max_hits: int, max_candidates: int, row0: int = 0,
                     output: str = "entries",
                     cmd_capacity: Optional[int] = None, pair="off",
                     taps: Optional[dict] = None, with_probes: bool = False,
                     upto: Optional[str] = None):
    """Bin ``scene`` into a ``tiles_y``-row slab starting at tile row
    ``row0``.

    ``output="entries"`` returns the entry stream (:class:`CoarseEntries`);
    ``output="dense"`` scatters the same sorted records into per-tile
    command lists of ``cmd_capacity`` slots (:class:`CoarseOutput`), as
    the JAX pass's dense output does.

    ``pair``: entry pairing of the entries output (ops/pairing.py):
    "off" (or False), "compact" (or True) or "hole"; anything else raises
    ``ValueError``.  The dense output ignores it, as the JAX pass does.

    ``taps``: optional dict that receives each kernel's inputs (keys
    "cand_inputs" -- the scene and the rect keywords of kernel A's item
    rows; "candfuse" -- the rows and the expansion's keywords;
    "hitfuse", "sort" -- the keys tuple, the values and the key bounds;
    "keyed" -- the hit records, their live count and n_out; "gatherm" --
    a list of (site, arguments) of ``gatherm.SITES``, one a call;
    "expand" and "seg_rows" -- the rows' inputs and keywords -- on the
    device-derived segment stage; "pairing" -- the
    compaction's bundle and keep mask; "dense_tail" -- the dense tail's
    tensors, the live mask its plain version reads, and its keywords;
    "entries_tail" -- a copy of the entries tail's stream, its tiles and
    its keywords) -- for tests and chip_smoke.py.

    ``with_probes=True`` adds ``diag["probes"]``: name -> the output
    tensors of each stage that ran (:data:`PROBE_STAGES`), in order.
    ``upto=<stage>`` ends the pass right after that stage and returns
    that dict (the stages so far), so a prefix of the pass is a step of
    its own (piet_tpu_torch/profiling.py times them).  Neither changes
    what the pass computes: without ``upto`` it runs the same device ops.
    """
    probe = _Probes(with_probes, upto)
    try:
        out = _coarse_pass(scene, tiles_x=tiles_x, tiles_y=tiles_y,
                           tile_w=tile_w, tile_h=tile_h,
                           max_segments=max_segments, max_hits=max_hits,
                           max_candidates=max_candidates, row0=row0,
                           output=output, cmd_capacity=cmd_capacity,
                           pair=pair, taps=taps, probe=probe)
    except _StopAfter:
        return probe.found
    if upto is not None:
        raise ValueError(f"stage {upto!r} does not run on this pass")
    if with_probes:
        out.diag["probes"] = probe.found
    return out


def _coarse_pass(scene: DeviceScene, *, tiles_x: int, tiles_y: int,
                 tile_w: int, tile_h: int, max_segments: int, max_hits: int,
                 max_candidates: int, row0: int, output: str,
                 cmd_capacity: Optional[int], pair, taps: Optional[dict],
                 probe: _Probes):
    if output not in ("entries", "dense"):
        raise ValueError(f"unknown coarse output {output!r}")
    if output == "dense" and cmd_capacity is None:
        raise ValueError("output='dense' needs cmd_capacity")
    pair_mode = resolve_pair_mode(pair)
    dev = scene.tags.device
    NI = scene.tags.shape[0]
    n_tiles = tiles_x * tiles_y
    thf = float(tile_h)
    stride = 2 * (NI + 1)
    assert n_tiles < 2 ** 24 and 2 * NI + 2 < 2 ** 24, "f32 key range"
    bounds = sort_key_bounds(n_tiles, NI)
    packed_ok = len(bounds) == 1
    E = max_hits + max_candidates
    assert E % 128 == 0 and E < 2 ** 24, "entry capacity"

    # ---- candidate rows and their expansion (kernel A) -----------------
    rect_kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
                   tile_h=tile_h, row0=row0)
    ci_in, ca, cand_tile, cand_ty = cand_prep_expand(
        scene, cap=max_candidates, **rect_kw)
    probe("cand_expand", ca, cand_tile, cand_ty)
    n_cand = ci_in.total
    if taps is not None:
        taps["cand_inputs"] = (scene, rect_kw)
        taps["candfuse"] = (ci_in, dict(row0=row0, cap=max_candidates,
                                        tiles_x=tiles_x))
    ca_i = _bits(ca)

    # ---- segment stage: host-staged, or derived on the device ----------
    sp = scene.seg_pre
    if sp is None:
        sp = derive_seg_stage(scene, ci_in.cand_pack[:, 15:24],
                              tile_w=tile_w, tile_h=tile_h,
                              max_segments=max_segments, taps=taps,
                              probe=probe)
    seg_rows = sp.seg_rows
    seg_f = seg_rows.view(F32)
    n_segs, n_hits = sp.n_segs, sp.n_hits
    seg_valid = torch.arange(max_segments, dtype=I32, device=dev) < n_segs
    a = seg_f[:, 4]
    xmn_y = seg_f[:, 8]
    xmx_y = seg_f[:, 10]
    is_fill_seg = ((seg_rows[:, 12] & 1) != 0) & seg_valid

    # ---- hit records (kernel B) ----------------------------------------
    hit_kw = dict(tile_w=tile_w, tile_h=tile_h, tiles_x=tiles_x,
                  stride=stride if packed_ok else 0)
    if taps is not None:
        taps["hitfuse"] = ((seg_rows, sp.hit_counts, sp.hit_excl, n_hits),
                           dict(row0=row0, cap=max_hits, **hit_kw))
    hit_rec = hit_records_fused(seg_rows, sp.hit_counts, sp.hit_excl,
                                n_hits, row0, max_hits, **hit_kw)
    probe("hit_expand", hit_rec)

    # ---- per-candidate command counts and winding deltas ---------------
    # Both keyed sums in one call on the records: n_cmds by h_cand, and
    # d_val by d_cand over the live records (zero values skipped).
    if taps is not None:
        taps["keyed"] = (hit_rec, n_hits, max_candidates)
    cand_emit, delta_scatter = record_keyed_sums(hit_rec, n_hits,
                                                 max_candidates)
    probe("cand_emit", cand_emit, delta_scatter)

    # ---- winding deltas -> backdrop ------------------------------------
    # Count-only diagnostic (rows whose top edge lies in [ymin, ymax]).
    d_y_lo = torch.clamp(torch.ceil(xmn_y / thf).to(I32), min=row0)
    d_y_hi = torch.clamp(torch.floor(xmx_y / thf).to(I32),
                         max=row0 + tiles_y - 1)
    n_deltas = torch.where(is_fill_seg & (a != 0),
                           torch.clamp(d_y_hi - d_y_lo + 1, min=0), 0).sum()
    # Per-(item, row) prefix along tx: candidates are row-major per item,
    # so subtract the running total at each row start.
    # One gatherm call: csum less csum at the slot before each
    # candidate's row start.
    csum = torch.cumsum(delta_scatter, 0)
    if taps is not None:
        taps.setdefault("gatherm", []).append(
            ("backdrop", (csum, ca_i, cand_ty)))
    backdrop = backdrop_from_csum(csum, ca_i, cand_ty)
    probe("deltas", backdrop)

    # ---- entry rows and sort keys: the candidates' tail commands ---------
    # Packed key (tile, item, class) or, with stride 0, the two keys; kernel
    # B gave the hit records' keys in the same mode.
    cr_args = (ca_i, cand_emit, backdrop, cand_tile, n_cand, hit_rec)
    cr_kw = dict(stride=stride if packed_ok else 0)
    if taps is not None:
        taps["cand_rows"] = (cr_args, cr_kw)
    all_rows, all_keys = cand_rows(*cr_args, **cr_kw)
    probe("rows", all_rows)

    # ---- global sort: key (tile, item, class), packed or unpacked -------
    order_idx = torch.arange(E, dtype=I32, device=dev)
    if taps is not None:
        taps["sort"] = (all_keys, order_idx, bounds)
    sorted_keys, sorted_idx = stable_sort_multi(all_keys, order_idx,
                                                bounds=bounds)
    live = sorted_keys[0] < _INF
    if packed_ok:
        # Dead keys (+inf) cap to n_tiles * stride, which decodes to tile
        # n_tiles: "no tile".
        key_cap = torch.clamp(sorted_keys[0], max=float(n_tiles * stride))
        e_tile = torch.div(key_cap.to(I32), stride, rounding_mode="floor")
    else:
        e_tile = torch.clamp(sorted_keys[0], max=float(n_tiles)).to(I32)
    probe("sort", e_tile, sorted_idx)
    e_rows = all_rows[sorted_idx.long()]
    W = torch.where
    stream16 = W(live[:, None], e_rows, 0)
    probe("sorted_gather", stream16)
    diag = {
        "n_segments": n_segs[0], "n_hits": n_hits[0],
        "n_candidates": n_cand[0], "n_deltas": n_deltas,
        "seg_overflow": torch.clamp(n_segs[0] - max_segments, min=0),
        "hit_overflow": torch.clamp(n_hits[0] - max_hits, min=0),
        "cand_overflow": torch.clamp(n_cand[0] - max_candidates, min=0),
    }
    if output == "dense":
        c_color_bits = ca_i[:, 9]
        tail = (stream16, sorted_idx, e_tile, c_color_bits)
        kw = dict(n_tiles=n_tiles, max_hits=max_hits,
                  cmd_capacity=cmd_capacity)
        if taps is not None:
            taps["dense_tail"] = (tail, live, kw)
        ptcl = dense_tail(*tail, **kw)
        diag["live_cmds"] = ptcl[2].sum()
        out = CoarseOutput(*ptcl, diag=diag)
        probe("tile_reduce", out.tags, out.args, out.counts)
        return out

    # ---- run words, per-tile ranges, command totals and the bail -------
    # One call (ops/entries_tail.py); on an unpaired stream it also writes
    # the run words: on the card into the sorted gather's stream itself,
    # so into a copy where the probes keep that stream (the plain version
    # on the CPU returns a new stream).
    run_words = pair_mode == "off"
    if not run_words:
        p = pair_entries(stream16, sorted_keys, live, e_tile,
                         *meta_bits(stream16), n_tiles, mode=pair_mode,
                         taps=taps)
        stream16, e_tile = p.rows, p.e_tile
        probe("pairing", stream16)
    tail_kw = dict(n_tiles=n_tiles, run_words=run_words)
    if taps is not None:
        taps["entries_tail"] = ((stream16.clone(), e_tile), tail_kw)
    if run_words and probe.keep and dev.type == "cuda":
        stream16 = stream16.clone()
    stream16, first, n_live, counts, solid = entries_tail(
        stream16, e_tile, **tail_kw)
    if run_words:
        probe("runs", stream16)
    diag["live_entries"] = n_live.sum()
    out = CoarseEntries(stream=stream16.view(F32), first=first,
                        n_entries=n_live, counts=counts, solid=solid,
                        diag=diag)
    probe("tile_reduce", out.first, out.n_entries, out.solid)
    return out
