"""The coarse pass's entry rows and sort keys, before the sort: the hit
records' entry words and keys from kernel B, and each candidate's tail
command (tag, operands, clip rect, bail colour, meta word) and key.

``ops/coarse.py::coarse_rasterize`` calls :func:`cand_rows` after the
backdrop: on CUDA tensors one launch of ``csrc/cand_rows.cu``, on CPU
tensors its plain version :func:`cand_rows_plain` (the JAX pass's tail
commands, row assembly and keys, in PyTorch); both give the same words on
every slot, dead slots included.  The key mode follows the pass's sort:
``stride > 0`` packs ``tile * stride + item * 2 + 1`` into one f32 key,
``stride == 0`` gives the two keys (tile, item * 2 + 1), as kernel B
writes its records' keys.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..layout.entry_stream import ENTRY_WORDS, META_CLEAR_BIT, META_OPAQUE_BIT
from ..raster.ptcl import (CMD_BEGIN_CLIP, CMD_BEGIN_LAYER, CMD_CIRCLE,
                           CMD_DRAW_FILL, CMD_DRAW_LIN_GRAD,
                           CMD_DRAW_RAD_GRAD, CMD_END_CLIP, CMD_END_LAYER,
                           CMD_SOLID, CMD_STROKE, CMD_WIND)
from ..scene.scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL,
                           FLAG_FILL_CONT, FLAG_FILL_FINAL, FLAG_IN_GROUP,
                           FLAG_POP_LAYER, TAG_CIRCLE, TAG_CLIP, TAG_FILL,
                           TAG_LAYER, TAG_LINE, TAG_POLY, TAG_POP)
from .candfuse import CAND_WORDS
from .cmd_math import _bits, _f
from .hitfuse import OUT_WORDS, split_fused

I32, F32 = torch.int32, torch.float32
_INF = float("inf")


def cand_rows(ca_i: torch.Tensor, cand_emit: torch.Tensor,
              backdrop: torch.Tensor, cand_tile: torch.Tensor,
              n_cand: torch.Tensor, hit_rec: torch.Tensor, *, stride: int):
    """Every entry slot's row and sort key(s), one launch on the card.

    Args:
      ca_i: (C, 32) int32 candidate records (kernel A, ``cand_prep_expand``,
        as bits).
      cand_emit: (C,) int32 hit commands of each candidate (keyed sums).
      backdrop: (C,) f32 winding backdrop of each candidate.
      cand_tile: (C,) int32 tile of each candidate.
      n_cand: (1,) int32 live candidates, on the device.
      hit_rec: (H, 24) f32 hit records (kernel B, ``hit_records_fused``).
      stride: the packed key's tile stride, 2 * (items + 1); 0 for the
        two unpacked keys.

    Returns ``(rows, keys)``: the (H + C, 16) int32 rows (the hit records'
    words 0-15, then the candidates' tail commands) and a tuple of one
    (packed) or two (tile, item * 2 + class) (H + C,) f32 keys, +inf where
    a slot holds no command, as :func:`cand_rows_plain` gives them.
    """
    if not kernels.on_cuda(ca_i, cand_emit, backdrop, cand_tile, n_cand,
                           hit_rec):
        return cand_rows_plain(ca_i, cand_emit, backdrop, cand_tile, n_cand,
                               hit_rec, stride=stride)
    C, H = ca_i.shape[0], hit_rec.shape[0]
    kernels.check_cuda_tensor(ca_i, I32, "ca_i", (C, CAND_WORDS))
    kernels.check_cuda_tensor(cand_emit, I32, "cand_emit", (C,))
    kernels.check_cuda_tensor(backdrop, F32, "backdrop", (C,))
    kernels.check_cuda_tensor(cand_tile, I32, "cand_tile", (C,))
    kernels.check_cuda_tensor(n_cand, I32, "n_cand", (1,))
    kernels.check_cuda_tensor(hit_rec, F32, "hit_rec", (H, OUT_WORDS))
    if ca_i.data_ptr() % 16 or hit_rec.data_ptr() % 16:
        raise ValueError("ca_i and hit_rec must be 16-byte aligned")
    if stride < 0:
        raise ValueError(f"stride {stride}")
    dev = ca_i.device
    rows = torch.empty((H + C, ENTRY_WORDS), dtype=I32, device=dev)
    keys = tuple(torch.empty((H + C,), dtype=F32, device=dev)
                 for _ in range(1 if stride else 2))
    kernels.launch("cand_rows", "piet_cand_rows", ca_i.data_ptr(),
                   cand_emit.data_ptr(), backdrop.data_ptr(),
                   cand_tile.data_ptr(), n_cand.data_ptr(),
                   hit_rec.data_ptr(), rows.data_ptr(), keys[0].data_ptr(),
                   keys[1].data_ptr() if not stride else None, C, H, stride)
    return rows, keys


def cand_rows_plain(ca_i, cand_emit, backdrop, cand_tile, n_cand, hit_rec, *,
                    stride: int):
    """The candidate tail commands, the row assembly and the sort keys of
    the JAX pass (``piet_tpu/ops/coarse.py``), in PyTorch.  The plain
    version of :func:`cand_rows`; returns its ``(rows, keys)``."""
    dev = ca_i.device
    max_candidates = ca_i.shape[0]
    ca = ca_i.view(F32)
    cf = ca[:, :15]
    ci = ca_i[:, 15:24]
    cg = ca[:, 25:32]
    cand_idx = torch.arange(max_candidates, dtype=I32, device=dev)
    cand_valid = cand_idx < n_cand
    cand_item = ca_i[:, 24]
    fused = split_fused(hit_rec)

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

    # ---- global sort keys: (tile, item, class), packed or unpacked ------
    # Kernel B gives the hit records' keys in the same mode (stride 0:
    # item * 2 in its key word, the tile in its tile word).
    if stride:
        cand_key = W(cand_cmd_valid,
                     (cand_tile * stride + cand_item * 2 + 1).to(F32), _INF)
        all_keys = (torch.cat([fused["key"], cand_key]),)
    else:
        all_keys = (
            torch.cat([fused["tile"], W(cand_cmd_valid, cand_tile.to(F32),
                                         _INF)]),
            torch.cat([fused["key"], W(cand_cmd_valid,
                                       (cand_item * 2 + 1).to(F32), _INF)]))
    return all_rows, all_keys
