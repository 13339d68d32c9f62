"""Coarse binning: staged scene -> entry-stream PTCL, in PyTorch.

Port of ``piet_tpu/ops/coarse.py::coarse_rasterize(output="entries")`` on
the main path of a static scene: the host-staged segment table
(``seg_pre``, renderer/segstage.py) and the fused-record route -- kernel A
(candidate expansion), kernel B (hit records), keyed sums, the backdrop
prefix, the candidate tail commands, one stable sort (kernel C), the
sorted gather, the ``W_RUN`` run words, per-tile ranges and the bail.
The output is word for word the JAX pass's (tests/test_torch_coarse.py).

The fused route is taken for every scene: the JAX package gates it on by
a record count measured on the TPU, but the fused and staged routes are
bitwise identical, so the port drops the gate.  What the slice does not
cover raises ``NotImplementedError`` naming its ROADMAP.md item: the
device segment derivation (``seg_pre=None``), the unpacked two-key sort,
the dense output and entry pairing.

Bit patterns: candidate rows, the bail colour and the entry rows travel
as int32.  Colours are NaN patterns as f32 and several words are integers
or denormal patterns, so they only move through gathers, selects and
concatenations of int32 views, never through float arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from piet_tpu.layout.entry_stream import (ENTRY_WORDS, META_CLEAR_BIT,
                                          META_NCMDS_MASK, META_OPAQUE_BIT,
                                          RUN_CAP, W_BAIL, W_META, W_RUN,
                                          W_S0_TAG, W_S1_TAG)
from piet_tpu.raster.ptcl import (CMD_BEGIN_CLIP, CMD_BEGIN_LAYER,
                                  CMD_CIRCLE, CMD_DRAW_FILL,
                                  CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD,
                                  CMD_END_CLIP, CMD_END_LAYER, CMD_FILL,
                                  CMD_LINE, CMD_SOLID, CMD_STROKE, CMD_WIND)
from piet_tpu.scene.scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL,
                                  FLAG_FILL_CONT, FLAG_FILL_FINAL,
                                  FLAG_IN_GROUP, FLAG_POP_LAYER, TAG_CIRCLE,
                                  TAG_CLIP, TAG_FILL, TAG_LAYER, TAG_LINE,
                                  TAG_POLY, TAG_POP)

from .candfuse import cand_records_fused
from .cmd_math import _f
from .hitfuse import hit_records_fused, split_fused
from .keyed import keyed_sum
from .sort import stable_sort_multi

_INF = float("inf")
F32, I32 = torch.float32, torch.int32


class SegPre(NamedTuple):
    """Host-precomputed segment stage on the device (renderer/segstage.py):
    ``seg_rows`` stays int32 bit patterns."""
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


def _item_tile_rect(bboxes, tw: int, th: int, tiles_x: int, tiles_y: int,
                    active, row0: int):
    """Quantized item bbox -> inclusive tile rect, windowed to tile rows
    [row0, row0 + tiles_y); empty if offscreen."""
    x0 = torch.clamp(torch.div(bboxes[:, 0], tw, rounding_mode="floor"),
                     min=0)
    y0 = torch.clamp(torch.div(bboxes[:, 1], th, rounding_mode="floor"),
                     min=row0)
    x1 = torch.clamp(torch.div(bboxes[:, 2], tw, rounding_mode="floor"),
                     max=tiles_x - 1)
    y1 = torch.clamp(torch.div(bboxes[:, 3], th, rounding_mode="floor"),
                     max=row0 + tiles_y - 1)
    w = torch.where(active, torch.clamp(x1 - x0 + 1, min=0), 0)
    h = torch.where(active, torch.clamp(y1 - y0 + 1, min=0), 0)
    return x0, y0, x1, y1, w, h


class CandInputs(NamedTuple):
    """Inputs of kernel A, built from the scene (ops/coarse.py cand_pack)."""
    cand_pack: torch.Tensor   # (NI, 32) int32 bit patterns
    counts: torch.Tensor      # (NI,) int32
    excl: torch.Tensor        # (NI,) int32
    total: torch.Tensor       # (1,) int32


def cand_inputs(scene: DeviceScene, *, tiles_x: int, tiles_y: int,
                tile_w: int, tile_h: int, row0: int = 0) -> CandInputs:
    """Per-item candidate rows: colours, bbox, half width, colour bits,
    flags, clip rect, the packed item ints, the item id and the gradient
    payload -- every attribute the tail commands need rides one
    expansion."""
    NI = scene.tags.shape[0]
    dev = scene.tags.device
    item_ids = torch.arange(NI, dtype=I32, device=dev)
    active = (item_ids < scene.n_items) & (scene.tags > 0)
    tags = torch.where(active, scene.tags, 0)
    bx0, by0, bx1, by1, bw, bh = _item_tile_rect(
        scene.bboxes, tile_w, tile_h, tiles_x, tiles_y, active, row0)
    counts = bw * bh
    excl, incl = _exclusive_cumsum(counts)
    item_pack = torch.stack([tags, scene.n_pts, scene.pt_offset, excl,
                             bx0, by0, bx1, by1, bw], dim=1)
    cand_pack = torch.cat(
        [_bits(scene.colors_lin), _bits(scene.bboxes.to(F32)),
         _bits(0.5 * scene.widths)[:, None], scene.colors_u32[:, None],
         _bits(scene.flags.to(F32))[:, None], _bits(scene.clips),
         item_pack, item_ids[:, None], _bits(scene.grads[:, :7])],
        dim=1).contiguous()
    return CandInputs(cand_pack, counts, excl, incl[-1:].clone())


def _not_covered(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md Queue 1, {item!r}")


def coarse_rasterize(scene: DeviceScene, *, tiles_x: int, tiles_y: int,
                     tile_w: int, tile_h: int, max_segments: int,
                     max_hits: int, max_candidates: int, row0: int = 0,
                     output: str = "entries", pair="off",
                     taps: Optional[dict] = None) -> CoarseEntries:
    """Bin ``scene`` into the entry stream of a ``tiles_y``-row slab
    starting at tile row ``row0``.

    ``taps``: optional dict that receives each kernel's inputs (keys
    "candfuse", "hitfuse", "sort") -- for tests and chip_smoke.py.
    """
    if output != "entries":
        _not_covered("the dense coarse output", "dense/portable path")
    if pair not in (False, "off"):
        _not_covered("entry pairing", "pairing")
    sp = scene.seg_pre
    if sp is None:
        _not_covered("the device segment derivation (seg_pre=None)",
                     "device segment derivation")
    dev = scene.tags.device
    NI = scene.tags.shape[0]
    n_tiles = tiles_x * tiles_y
    thf = float(tile_h)
    stride = 2 * (NI + 1)
    if not n_tiles * stride < 2 ** 24:
        _not_covered("the unpacked two-key sort (tiles x items >= 2^24)",
                     "unpacked sort key fallback")
    E = max_hits + max_candidates
    assert E % 128 == 0 and E < 2 ** 24, "entry capacity"

    # ---- candidate expansion (kernel A) --------------------------------
    ci_in = cand_inputs(scene, tiles_x=tiles_x, tiles_y=tiles_y,
                        tile_w=tile_w, tile_h=tile_h, row0=row0)
    n_cand = ci_in.total
    if taps is not None:
        taps["candfuse"] = (ci_in, dict(row0=row0, cap=max_candidates,
                                        tiles_x=tiles_x))
    ca, cand_tile, cand_ty, _ = cand_records_fused(
        ci_in.cand_pack, ci_in.counts, ci_in.excl, n_cand, row0,
        max_candidates, tiles_x=tiles_x)
    ca_i = _bits(ca)
    cf = ca[:, :15]
    ci = ca_i[:, 15:24]
    cg = ca[:, 25:32]
    cand_idx = torch.arange(max_candidates, dtype=I32, device=dev)
    cand_valid = cand_idx < n_cand
    cand_item = ca_i[:, 24]

    # ---- host-staged segment stage -------------------------------------
    seg_rows = sp.seg_rows
    seg_f = seg_rows.view(F32)
    n_segs, n_hits = sp.n_segs, sp.n_hits
    seg_valid = torch.arange(max_segments, dtype=I32, device=dev) < n_segs
    a = seg_f[:, 4]
    xmn_y = seg_f[:, 8]
    xmx_y = seg_f[:, 10]
    is_fill_seg = ((seg_rows[:, 12] & 1) != 0) & seg_valid

    # ---- hit records (kernel B) + per-candidate command counts ---------
    hit_valid = torch.arange(max_hits, dtype=I32, device=dev) < n_hits
    hit_kw = dict(tile_w=tile_w, tile_h=tile_h, tiles_x=tiles_x,
                  stride=stride)
    if taps is not None:
        taps["hitfuse"] = ((seg_rows, sp.hit_counts, sp.hit_excl, n_hits),
                           dict(row0=row0, cap=max_hits, **hit_kw))
    fused = split_fused(hit_records_fused(
        seg_rows, sp.hit_counts, sp.hit_excl, n_hits, row0, max_hits,
        **hit_kw))
    h_cand = fused["h_cand"].to(I32)
    cand_emit = keyed_sum(fused["n_cmds"], h_cand,
                          max_candidates).to(I32)

    # ---- winding deltas -> backdrop ------------------------------------
    # Count-only diagnostic (rows whose top edge lies in [ymin, ymax]).
    d_y_lo = torch.clamp(torch.ceil(xmn_y / thf).to(I32), min=row0)
    d_y_hi = torch.clamp(torch.floor(xmx_y / thf).to(I32),
                         max=row0 + tiles_y - 1)
    n_deltas = torch.where(is_fill_seg & (a != 0),
                           torch.clamp(d_y_hi - d_y_lo + 1, min=0), 0).sum()
    d_val = fused["d_val"]
    dk = torch.where(hit_valid & (d_val != 0.0), fused["d_cand"].to(I32),
                     max_candidates)
    delta_scatter = keyed_sum(d_val, dk, max_candidates)
    # Per-(item, row) prefix along tx: candidates are row-major per item,
    # so subtract the running total at each row start.
    csum = torch.cumsum(delta_scatter, 0)
    cand_row_start = ci[:, 3] + (cand_ty - ci[:, 5]) * torch.clamp(
        ci[:, 8], min=1)
    sb_idx = torch.clamp(cand_row_start - 1, 0, max_candidates - 1)
    start_base = torch.where(cand_row_start > 0, csum[sb_idx.long()], 0.0)
    backdrop = csum - start_base

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

    # ---- global sort: packed key (tile, item, class) -------------------
    cand_key = W(cand_cmd_valid,
                 (cand_tile * stride + cand_item * 2 + 1).to(F32), _INF)
    all_keys = torch.cat([fused["key"], cand_key])
    order_idx = torch.arange(E, dtype=I32, device=dev)
    if taps is not None:
        taps["sort"] = (all_keys, order_idx)
    (sorted_key,), sorted_idx = stable_sort_multi((all_keys,), order_idx)
    live = sorted_key < _INF
    key_cap = torch.clamp(sorted_key, max=float(n_tiles * stride))
    e_tile = torch.div(key_cap.to(I32), stride, rounding_mode="floor")
    e_rows = all_rows[sorted_idx.long()]
    stream16 = W(live[:, None], e_rows, 0)
    e_meta = stream16[:, W_META].view(F32).to(I32)
    e_ncmds = e_meta & META_NCMDS_MASK
    e_is_opaque = (e_meta & META_OPAQUE_BIT) != 0
    e_is_clear = (e_meta & META_CLEAR_BIT) != 0

    # ---- run words: remaining length of each same-class streak ---------
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
    stream16 = torch.cat([stream16[:, :W_RUN], _bits(w_run)[:, None]], dim=1)

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
    diag = {
        "n_segments": n_segs[0], "n_hits": n_hits[0],
        "n_candidates": n_cand[0], "n_deltas": n_deltas,
        "live_entries": n_live.sum(),
        "seg_overflow": torch.clamp(n_segs[0] - max_segments, min=0),
        "hit_overflow": torch.clamp(n_hits[0] - max_hits, min=0),
        "cand_overflow": torch.clamp(n_cand[0] - max_candidates, min=0),
    }
    return CoarseEntries(stream=stream16.view(F32), first=first_live.to(I32),
                         n_entries=n_live.to(I32), counts=count_post.to(I32),
                         solid=solid.to(I32), diag=diag)
