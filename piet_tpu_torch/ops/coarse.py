"""Coarse binning: staged scene -> PTCL (entry stream or dense), in PyTorch.

Port of ``piet_tpu/ops/coarse.py::coarse_rasterize``: the segment stage --
host-staged (``seg_pre``, renderer/segstage.py) or derived on the device
from the scene's points (``seg_pre=None``, the device-animation path:
:func:`derive_seg_stage`) -- then the fused-record route: kernel A (the
item rows and their candidate expansion), kernel B (hit records), keyed
sums, the backdrop prefix, the candidate tail commands, one stable sort
(kernel C) and the sorted gather.  ``output="entries"`` then adds the
``W_RUN`` run words, per-tile ranges and the bail; ``output="dense"``
scatters the records into (T, CAP) command lists (``ops/dense_tail.py``).
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
both branches.  Where the packed sort key ``tile * 2*(NI+1) + item*2 +
class`` would reach 2^24 (inexact in f32), the sort takes two keys,
(tile, item*2 + class), as the JAX pass does.  Entry pairing
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
from ..layout.entry_stream import (ENTRY_WORDS, META_CLEAR_BIT,
                                   META_OPAQUE_BIT, RUN_CAP, W_BAIL, W_RUN,
                                   W_S0_TAG, W_S1_TAG)
from ..raster.ptcl import (CMD_BEGIN_CLIP, CMD_BEGIN_LAYER, CMD_CIRCLE,
                           CMD_DRAW_FILL, CMD_DRAW_LIN_GRAD,
                           CMD_DRAW_RAD_GRAD, CMD_END_CLIP, CMD_END_LAYER,
                           CMD_FILL, CMD_LINE, CMD_SOLID, CMD_STROKE,
                           CMD_WIND)
from ..scene.scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL,
                           FLAG_FILL_CONT, FLAG_FILL_FINAL, FLAG_IN_GROUP,
                           FLAG_POP_LAYER, TAG_CIRCLE, TAG_CLIP, TAG_FILL,
                           TAG_LAYER, TAG_LINE, TAG_POLY, TAG_POP)
from .candfuse import cand_prep_expand
from .cmd_math import _f, div_det, dot2_det
from .dense_tail import dense_tail, meta_bits
from .expand import expand_rows
from .gatherm import backdrop_from_csum, gather_endpoints
from .hitfuse import hit_records_fused, split_fused
from .keyed import record_keyed_sums
from .pairing import pair_entries, resolve_pair_mode
from .sort import stable_sort_multi

_INF = float("inf")
F32, I32 = torch.float32, torch.int32

#: The stages of the pass, in order, under the JAX pass's probe names
#: (``piet_tpu/profiling.py::STAGE_ORDER``).  A stage's probe holds its
#: output tensors.  Where one kernel
#: does several JAX stages, the probe stands after the kernel under the
#: group's first name: kernel A is "cand_expand"; kernel B "hit_expand"
#: (JAX's "hit_gather" and "hit_tests" too); the one-call keyed sums
#: "cand_emit" (and "del_scatter").  "tile_reduce" runs to the end of the
#: pass (the bail, and on the dense route the dense tail).  The
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
    name -> the stage's output tensors, the pass ending after ``upto``."""

    def __init__(self, on: bool, upto: Optional[str]):
        if upto is not None and upto not in PROBE_STAGES:
            raise ValueError(f"unknown stage {upto!r}; stages: "
                             f"{PROBE_STAGES}")
        self.found = {} if (on or upto is not None) else None
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
    host stage writes zeros.)  Eager PyTorch rounds every product on its
    own, so the JAX pass's contraction barriers (``_bar``) have no
    counterpart here.  ``probe``: the pass's stage probes (see
    :func:`coarse_rasterize`).
    """
    dev = item_pack.device
    NI = item_pack.shape[0]
    twf, thf = float(tile_w), float(tile_h)
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
    sitem_f = sitem.view(F32)
    seg_idx = torch.arange(max_segments, dtype=I32, device=dev)
    seg_valid = seg_idx < n_segs
    seg_item = sitem[:, 11]
    s_tag, s_cand_excl = sitem[:, 0], sitem[:, 3]
    s_bx0, s_by0, s_bx1, s_by1, s_bw = (sitem[:, 4], sitem[:, 5],
                                        sitem[:, 6], sitem[:, 7],
                                        sitem[:, 8])
    s_is_fill_tag = (s_tag == TAG_FILL) | (s_tag == TAG_CLIP)
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
    probe("seg_derive", a, b, c, xmn, xmx)

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
    r_x_hi = W(widen, wcol, r_x_hi)
    r_w = W(widen, 1, r_w)
    hit_counts = W(seg_valid, r_w * r_h, 0)
    hit_excl, hit_incl = _exclusive_cumsum(hit_counts)
    probe("seg_rects", hit_counts, hit_excl)

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
    seg_rows = torch.cat(
        [_bits(torch.stack([sx, sy, ex, ey, a, b, c, xmn[:, 0], xmn[:, 1],
                            xmx[:, 0], xmx[:, 1], s_hw], dim=1)),
         seg_i32,
         _bits(torch.stack([s_invd, s_m, s_K], dim=1)),
         hit_excl[:, None]], dim=1).contiguous()        # (S, 27)
    tracing.mark("seg_rows")
    return SegPre(seg_rows=seg_rows, hit_counts=hit_counts,
                  hit_excl=hit_excl, n_segs=n_segs, n_hits=hit_incl[-1:])


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
    "expand" on the device-derived segment stage; "pairing" -- the
    compaction's bundle and keep mask; "dense_tail" -- the dense tail's
    tensors, the live mask its plain version reads, and its keywords) --
    for tests and chip_smoke.py.

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
    cf = ca[:, :15]
    ci = ca_i[:, 15:24]
    cg = ca[:, 25:32]
    cand_idx = torch.arange(max_candidates, dtype=I32, device=dev)
    cand_valid = cand_idx < n_cand
    cand_item = ca_i[:, 24]

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
    fused = split_fused(hit_rec)
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

    # ---- candidate tail commands ---------------------------------------
    c_tag_item = ci[:, 0]
    c_color_lin = cf[:, 0:4]
    c_color_bits = ca_i[:, 9]
    c_any = cand_emit > 0
    c_backdrop_nz = backdrop != 0.0
    cflags = cf[:, 10].to(I32)
    c_even_odd = (cflags & 1).to(F32)
    c_ingroup = (cflags & FLAG_IN_GROUP) != 0
    c_grad_lin = (cflags & FLAG_BRUSH_LINEAR) != 0
    c_grad_rad = (cflags & FLAG_BRUSH_RADIAL) != 0
    c_is_grad_item = c_grad_lin | c_grad_rad
    c_cont = (cflags & FLAG_FILL_CONT) != 0
    c_final = (cflags & FLAG_FILL_FINAL) != 0

    is_circle = cand_valid & (c_tag_item == TAG_CIRCLE)
    is_fill_cand = cand_valid & (c_tag_item == TAG_FILL)
    is_wind = is_fill_cand & c_cont & c_backdrop_nz
    is_grad = (is_fill_cand & c_is_grad_item & ~c_cont
               & (c_any | c_backdrop_nz | c_final))
    is_drawfill = (is_fill_cand & ~c_is_grad_item & ~c_cont
                   & (c_any | c_final))
    is_solid = (is_fill_cand & ~c_is_grad_item & ~c_cont & ~c_final
                & ~c_any & c_backdrop_nz)
    is_stroke = cand_valid & ((c_tag_item == TAG_POLY)
                              | (c_tag_item == TAG_LINE)) & c_any
    is_clip = cand_valid & (c_tag_item == TAG_CLIP)
    is_layer = cand_valid & (c_tag_item == TAG_LAYER)
    is_pop = cand_valid & (c_tag_item == TAG_POP)
    pop_layer = is_pop & ((cflags & FLAG_POP_LAYER) != 0)
    is_group_cmd = is_clip | is_layer | is_pop

    cand_cmd_valid = (is_circle | is_drawfill | is_solid | is_stroke
                      | is_grad | is_wind | is_group_cmd)
    cand_tag = torch.full_like(c_tag_item, CMD_STROKE)
    for cond, tag in ((is_pop, CMD_END_CLIP), (pop_layer, CMD_END_LAYER),
                      (is_layer, CMD_BEGIN_LAYER), (is_clip, CMD_BEGIN_CLIP),
                      (is_grad, CMD_DRAW_LIN_GRAD),
                      (is_grad & c_grad_rad, CMD_DRAW_RAD_GRAD),
                      (is_wind, CMD_WIND), (is_solid, CMD_SOLID),
                      (is_drawfill, CMD_DRAW_FILL), (is_circle, CMD_CIRCLE)):
        cand_tag = torch.where(cond, tag, cand_tag)

    W = torch.where
    cbb = cf[:, 4:8]
    chw = cf[:, 8]
    a0 = W(is_circle, cbb[:, 0],
           W(is_drawfill, backdrop, W(is_stroke, chw, c_color_lin[:, 0])))
    a1 = W(is_circle, cbb[:, 1],
           W(is_solid, c_color_lin[:, 1], c_color_lin[:, 0]))
    a2 = W(is_circle, cbb[:, 2],
           W(is_solid, c_color_lin[:, 2], c_color_lin[:, 1]))
    a3 = W(is_circle, cbb[:, 3],
           W(is_solid, c_color_lin[:, 3], c_color_lin[:, 2]))
    a4 = W(is_solid | is_circle, 0.0, c_color_lin[:, 3])
    a5 = W(is_drawfill, c_even_odd, 0.0)
    # Group commands: BeginClip [backdrop, even_odd]; EndLayer [alpha].
    a0 = W(is_clip, backdrop,
           W(pop_layer, 2.0 * chw, W(is_layer | is_pop, 0.0, a0)))
    a1 = W(is_clip, c_even_odd, W(is_layer | is_pop, 0.0, a1))
    a2 = W(is_group_cmd, 0.0, a2)
    a3 = W(is_group_cmd, 0.0, a3)
    a4 = W(is_group_cmd, 0.0, a4)
    # Gradient resolves: [backdrop, params3, c0 rgba, c1 rgba].
    a0 = W(is_grad, backdrop, a0)
    a1 = W(is_grad, cg[:, 0], a1)
    a2 = W(is_grad, cg[:, 1], a2)
    a3 = W(is_grad, cg[:, 2], a3)
    a4 = W(is_grad, c_color_lin[:, 0], a4)
    a5 = W(is_grad, c_color_lin[:, 1], a5)
    a6 = W(is_grad, c_color_lin[:, 2], 0.0)
    a7 = W(is_grad, c_color_lin[:, 3], 0.0)
    # Winding carry: [backdrop] only.
    a0 = W(is_wind, backdrop, a0)
    a1, a2, a3, a4, a5, a6, a7 = (W(is_wind, 0.0, v)
                                  for v in (a1, a2, a3, a4, a5, a6, a7))
    # Words 8-11: the draw's clip rect; none for group commands; the second
    # gradient stop for gradient resolves.
    rect = W(is_grad[:, None], cg[:, 3:7],
             W((is_group_cmd | is_wind)[:, None], 0.0, cf[:, 11:15]))

    # A clipped or in-group solid cannot bail the tile.
    c_uncl = ((cf[:, 11] == _f(-1e9)) & (cf[:, 12] == _f(-1e9))
              & (cf[:, 13] == _f(1e9)) & (cf[:, 14] == _f(1e9)))
    is_opaque_solid = (is_solid & ((c_color_bits & 0xFF) == 0xFF) & c_uncl
                       & ~c_ingroup)
    cand_is_clear = (is_circle | is_drawfill | is_stroke | is_grad
                     | (is_solid & ~(c_uncl & ~c_ingroup)) | is_group_cmd)

    # ---- row assembly (int32 bit patterns) -----------------------------
    hit_rows = _bits(fused["rows"])
    cand_tag0 = W(cand_cmd_valid, cand_tag, 0)
    cand_meta = (cand_cmd_valid.to(I32)
                 | is_opaque_solid.to(I32) * META_OPAQUE_BIT
                 | cand_is_clear.to(I32) * META_CLEAR_BIT)
    cand_rows = torch.cat(
        [_bits(torch.stack([cand_tag0.to(F32), a0, a1, a2, a3, a4, a5, a6,
                            a7], dim=1)),              # W_S0_TAG, args 0..7
         _bits(rect),                                  # args 8..11
         W(is_opaque_solid, c_color_bits, 0)[:, None],  # W_BAIL
         _bits(cand_meta.to(F32))[:, None],            # W_META
         torch.zeros((max_candidates, 1), dtype=I32, device=dev)],  # W_RUN
        dim=1)
    all_rows = torch.cat([hit_rows, cand_rows])
    probe("rows", all_rows)

    # ---- global sort: key (tile, item, class), packed or unpacked -------
    # Kernel B gives the hit records' keys in the same mode (stride 0:
    # item * 2 in its key word, the tile in its tile word).
    if packed_ok:
        cand_key = W(cand_cmd_valid,
                     (cand_tile * stride + cand_item * 2 + 1).to(F32), _INF)
        all_keys = (torch.cat([fused["key"], cand_key]),)
    else:
        all_keys = (
            torch.cat([fused["tile"], W(cand_cmd_valid, cand_tile.to(F32),
                                         _INF)]),
            torch.cat([fused["key"], W(cand_cmd_valid,
                                       (cand_item * 2 + 1).to(F32), _INF)]))
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

    e_ncmds, e_is_opaque, e_is_clear = meta_bits(stream16)
    if pair_mode != "off":
        p = pair_entries(stream16, sorted_keys, live, e_tile, e_ncmds,
                         e_is_opaque, e_is_clear, n_tiles, mode=pair_mode,
                         taps=taps)
        stream16, live, e_tile = p.rows, p.live, p.e_tile
        e_ncmds, e_is_opaque, e_is_clear = (p.e_ncmds, p.e_is_opaque,
                                            p.e_is_clear)
        probe("pairing", stream16)
    else:
        stream16 = _run_words(stream16, live, e_tile, n_tiles)
        probe("runs", stream16)

    # ---- per-tile ranges, command totals and the bail ------------------
    cpos_excl, cpos_incl = _exclusive_cumsum(e_ncmds)
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
    diag["live_entries"] = n_live.sum()
    out = CoarseEntries(stream=stream16.view(F32), first=first_live.to(I32),
                        n_entries=n_live.to(I32), counts=count_post.to(I32),
                        solid=solid.to(I32), diag=diag)
    probe("tile_reduce", out.first, out.n_entries, out.solid)
    return out


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
    return torch.cat([stream16[:, :W_RUN], _bits(w_run)[:, None]], dim=1)
