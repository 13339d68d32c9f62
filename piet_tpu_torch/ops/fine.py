"""Fine rasterizers: the entry-stream interpreter (kernel D) and the
dense PTCL interpreter.

Port of ``piet_tpu/ops/fine.py``.

``fine_rasterize_entries`` ports ``fine_rasterize_entries``.  Tile t owns
the sorted entries [first[t], first[t] + n[t]) of the entry-major (E, 16)
stream; entries apply in stream order to every pixel of the tile, then the
polynomial sRGB encode packs RGBA8.  An empty tile writes its present
colour (the bail solid's bytes, or white).  The plain version does not
read ``W_RUN``: run dispatch does not change pixels.  The CUDA kernel is
``csrc/fine.cu``.
:func:`fine_rasterize_entries_plain` is its plain PyTorch version: a
tile-vectorized interpreter whose step k applies entry ``first + k`` of
every tile with ``n > k`` -- all classes present in the step are computed
for those tiles and selected by tag.  Tiles are visited in order of
decreasing entry count, so the tiles a step touches are always a prefix of
the state arrays.

``fine_rasterize`` ports ``fine_rasterize`` (the TPU kernel
``_fine_kernel``): tile t interprets commands [0, counts[t]) of its row of
the dense (T, CAP) tags and (T, CAP * 12) operands.  Its CUDA kernel,
``csrc/fine_dense.cu``, also serves ``ops/fine_xla.py`` (the group
instantiation); :func:`dense_plain` is the plain version of both, the same
tile-vectorized scheme over command slots.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..layout.entry_stream import (ENTRY_WORDS, W_S0_ARG, W_S0_TAG, W_S1_ARG,
                                   W_S1_TAG)
from ..raster.ptcl import (ARG_WORDS, CMD_BEGIN_CLIP, CMD_BEGIN_LAYER, CMD_CIRCLE,
                           CMD_DRAW_FILL, CMD_DRAW_LIN_GRAD,
                           CMD_DRAW_RAD_GRAD, CMD_END_CLIP, CMD_END_LAYER,
                           CMD_FILL, CMD_FILL_EDGE, CMD_LINE, CMD_SOLID,
                           CMD_STROKE, CMD_WIND)
from ..scene.scene import MAX_GROUP_DEPTH
from .cmd_math import (DF2_INIT, DF_INIT, clip_alpha, edge_delta, fill_delta,
                       ieee_sqrt, line_field_sq, make_commands,
                       make_grad_commands, pack_rgba8)

F32, I32 = torch.float32, torch.int32
#: Pseudo-tag marking a step that carries a slot-1 fill.
_S1_FILL = -1


def _untile(tiles: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """(T, th, tw) -> (T // tiles_x * th, tiles_x * tw)."""
    T, th, tw = tiles.shape
    ty = T // tiles_x
    return (tiles.reshape(ty, tiles_x, th, tw).permute(0, 2, 1, 3)
            .reshape(ty * th, tiles_x * tw))


def _tile_grid(T: int, tiles_x: int, row0, tile_h: int, tile_w: int,
               order: torch.Tensor, dev):
    """Absolute pixel coordinates X, Y of tiles ``order``, (T, th, tw)."""
    ty = row0 + torch.div(order, tiles_x, rounding_mode="floor")
    tx = order % tiles_x
    X = ((tx * tile_w).to(F32)[:, None, None]
         + torch.arange(tile_w, device=dev, dtype=F32)[None, None, :])
    Y = ((ty * tile_h).to(F32)[:, None, None]
         + torch.arange(tile_h, device=dev, dtype=F32)[None, :, None])
    return X.expand(T, tile_h, tile_w), Y.expand(T, tile_h, tile_w)


def fine_rasterize_entries_plain(first, n_entries, solid, stream, row0=0, *,
                                 tile_h: int, tile_w: int,
                                 tiles_x: int) -> torch.Tensor:
    """Plain PyTorch version of kernel D; see
    :func:`fine_rasterize_entries`."""
    dev = stream.device
    T = first.shape[0]
    n = n_entries.to(torch.int64)
    order = torch.sort(n, descending=True, stable=True).indices
    n_sorted = n[order].tolist()
    first_s = first.to(torch.int64)[order]
    X, Y = _tile_grid(T, tiles_x, row0, tile_h, tile_w, order, dev)
    shp = (T, tile_h, tile_w)
    r = torch.ones(shp, dtype=F32, device=dev)
    g = torch.ones_like(r)
    b = torch.ones_like(r)
    df2 = torch.full(shp, DF2_INIT, dtype=F32, device=dev)
    area = torch.zeros_like(r)
    cov = torch.ones((T, MAX_GROUP_DEPTH + 1, tile_h, tile_w), dtype=F32,
                     device=dev)
    sv = torch.ones((T, MAX_GROUP_DEPTH, 3, tile_h, tile_w), dtype=F32,
                    device=dev)
    dclip = torch.zeros(T, dtype=torch.int64, device=dev)
    dlayer = torch.zeros(T, dtype=torch.int64, device=dev)

    max_n = n_sorted[0] if T else 0
    n_host = torch.tensor(n_sorted, dtype=torch.int64)
    for k in range(max_n):
        A = int((n_host > k).sum())
        ent = stream[first_s[:A] + k]                       # (A, 16)
        tag0 = ent[:, W_S0_TAG].to(I32)
        s1_fill = ent[:, W_S1_TAG] == float(CMD_FILL)
        # One host read per step: which classes occur among its entries.
        codes = torch.unique(tag0 * 2 + s1_fill.to(I32)).tolist()
        present = {c >> 1 for c in codes}
        if any(c & 1 for c in codes):
            present.add(_S1_FILL)
        Xa, Ya = X[:A], Y[:A]
        ar = torch.arange(A, device=dev)

        def arg0(j):
            return ent[:, W_S0_ARG + j].view(A, 1, 1)

        def arg1(j):
            return ent[:, W_S1_ARG + j].view(A, 1, 1)

        def sel(tag):
            return (tag0 == tag).view(A, 1, 1)

        def cur_cov():
            return cov[ar, dclip[:A]]

        if CMD_LINE in present:
            df2[:A] = torch.where(sel(CMD_LINE), torch.minimum(
                df2[:A], line_field_sq(arg0, Xa, Ya)), df2[:A])
        if CMD_FILL_EDGE in present:
            area[:A] = torch.where(sel(CMD_FILL_EDGE),
                                   area[:A] + edge_delta(arg0, Ya), area[:A])
        if _S1_FILL in present:
            m, d = fill_delta(arg1, Xa, Ya)
            area[:A] = torch.where(s1_fill.view(A, 1, 1) & m,
                                   area[:A] + d, area[:A])

        cmds = make_commands(Xa, Ya, cov=cur_cov)
        grad_lin, grad_rad = make_grad_commands(Xa, Ya, cov=cur_cov)
        resolves = {CMD_CIRCLE: cmds[0], CMD_STROKE: cmds[3],
                    CMD_DRAW_FILL: cmds[5], CMD_SOLID: cmds[6],
                    CMD_DRAW_LIN_GRAD: grad_lin, CMD_DRAW_RAD_GRAD: grad_rad}
        for tag, cmd in resolves.items():
            if tag not in present:
                continue
            s = sel(tag)
            df_in = ieee_sqrt(df2[:A]) if tag == CMD_STROKE else df2[:A]
            r2, g2, b2, _, area2 = cmd(arg0, r[:A], g[:A], b[:A], df_in,
                                       area[:A])
            r[:A] = torch.where(s, r2, r[:A])
            g[:A] = torch.where(s, g2, g[:A])
            b[:A] = torch.where(s, b2, b[:A])
            area[:A] = torch.where(s, area2, area[:A])
            if tag == CMD_STROKE:
                df2[:A] = torch.where(s, DF2_INIT, df2[:A])

        if CMD_WIND in present:
            area[:A] = torch.where(sel(CMD_WIND), area[:A] + arg0(0),
                                   area[:A])
        if CMD_BEGIN_CLIP in present:
            s1 = tag0 == CMD_BEGIN_CLIP
            d = dclip[:A]
            ca = clip_alpha(area[:A] + arg0(0), arg0(1))
            nd = torch.clamp(d + 1, max=MAX_GROUP_DEPTH)
            cov[ar, nd] = torch.where(s1.view(A, 1, 1), cov[ar, d] * ca,
                                      cov[ar, nd])
            dclip[:A] = torch.where(s1, nd, d)
            area[:A] = torch.where(s1.view(A, 1, 1), 0.0, area[:A])
        if CMD_END_CLIP in present:
            dclip[:A] = torch.where(tag0 == CMD_END_CLIP,
                                    torch.clamp(dclip[:A] - 1, min=0),
                                    dclip[:A])
        if CMD_BEGIN_LAYER in present:
            s1 = tag0 == CMD_BEGIN_LAYER
            ld = torch.clamp(dlayer[:A], max=MAX_GROUP_DEPTH - 1)
            rgb = torch.stack([r[:A], g[:A], b[:A]], dim=1)
            sv[ar, ld] = torch.where(s1.view(A, 1, 1, 1), rgb, sv[ar, ld])
            dlayer[:A] = torch.where(s1, ld + 1, dlayer[:A])
        if CMD_END_LAYER in present:
            s1 = tag0 == CMD_END_LAYER
            s3 = s1.view(A, 1, 1)
            ld = torch.clamp(dlayer[:A] - 1, min=0)
            saved = sv[ar, ld]
            alpha = arg0(0)
            for c, plane in enumerate((r, g, b)):
                sc = saved[:, c]
                plane[:A] = torch.where(s3, sc + (plane[:A] - sc) * alpha,
                                        plane[:A])
            dlayer[:A] = torch.where(s1, ld, dlayer[:A])

    px = pack_rgba8(r, g, b)
    sol = solid.to(I32)[order]
    empty_px = torch.where(sol == 0, -1, sol)
    px = torch.where((n[order] == 0).view(T, 1, 1), empty_px.view(T, 1, 1),
                     px)
    tiles = torch.empty_like(px)
    tiles[order] = px
    return _untile(tiles, tiles_x)


def fine_rasterize_entries(first, n_entries, solid, stream, row0=0, *,
                           tile_h: int, tile_w: int,
                           tiles_x: int) -> torch.Tensor:
    """Rasterize all tiles of a slab from an entry stream.

    Args:
      first, n_entries: (T,) int32 per-tile entry ranges.
      solid: (T,) int32 bits of the present-format bail colour (0 = none).
      stream: (E, 16) f32 entry-major records (ops/coarse.py).
      row0: first tile row of the slab.

    Returns (T // tiles_x * tile_h, tiles_x * tile_w) int32 holding packed
    RGBA8 (R in the low byte).
    """
    if not kernels.on_cuda(first, n_entries, solid, stream):
        return fine_rasterize_entries_plain(
            first, n_entries, solid, stream, row0, tile_h=tile_h,
            tile_w=tile_w, tiles_x=tiles_x)
    T = first.shape[0]
    if stream.ndim != 2 or stream.shape[1] != ENTRY_WORDS:
        raise ValueError(f"stream shape {tuple(stream.shape)}")
    if T % tiles_x:
        raise ValueError(f"{T} tiles is not a multiple of tiles_x {tiles_x}")
    if tile_w > 1024:
        raise ValueError("tile_w above 1024 is not supported by the kernel")
    for name, t, dt, shape in (
            ("first", first, I32, (T,)), ("n_entries", n_entries, I32, (T,)),
            ("solid", solid, I32, (T,)), ("stream", stream, F32, None)):
        kernels.check_cuda_tensor(t, dt, name, shape)
    if stream.data_ptr() % 16:
        raise ValueError("stream must be 16-byte aligned")
    out = torch.empty((T // tiles_x * tile_h, tiles_x * tile_w), dtype=I32,
                      device=stream.device)
    # Scratch for the kernel's dense-first tile order.
    order = torch.empty((T,), dtype=I32, device=stream.device)
    kernels.launch("fine", "piet_fine_entries", first.data_ptr(),
                   n_entries.data_ptr(), solid.data_ptr(), stream.data_ptr(),
                   order.data_ptr(), out.data_ptr(), T, tiles_x, tile_w,
                   tile_h, int(row0))
    return out


#: Commands per shared-memory chunk of the dense kernel; the capacity
#: must be a multiple of it (as the TPU kernel's DMA chunks required).
CMD_CHUNK = 128


def dense_plain(counts, tags, args, row0=0, *, tile_h: int, tile_w: int,
                cmd_capacity: int, groups: bool) -> torch.Tensor:
    """Plain PyTorch version of the dense interpreter.

    ``groups=False`` is ``_fine_kernel``: branch ``clip(tag - 2, 0, 8)`` of
    the seven ``make_commands`` evaluators, a no-op (tag 9) and debug
    magenta (tags >= 10).  ``groups=True`` is ``fine_rasterize_xla``:
    branch ``clip(tag - 2, 0, 14)`` adds begin/end clip, begin/end layer,
    the two gradients and the winding carry, with the clip-coverage and
    saved-rgb stacks.  Step k applies command k of every tile whose count
    exceeds k; the branches present in the step are computed for those
    tiles and selected per tile.  The distance field is DF_INIT-based and
    each line takes its own sqrt, as ``make_commands`` does."""
    dev = tags.device
    tiles_y, tiles_x = counts.shape
    T = tiles_y * tiles_x
    n = torch.clamp(counts.reshape(-1).to(torch.int64), max=cmd_capacity)
    order = torch.sort(n, descending=True, stable=True).indices
    n_host = n[order].cpu()
    X, Y = _tile_grid(T, tiles_x, row0, tile_h, tile_w, order, dev)
    tag_s = tags[order]
    arg_s = args.reshape(T, cmd_capacity, ARG_WORDS)[order]
    shp = (T, tile_h, tile_w)
    r = torch.ones(shp, dtype=F32, device=dev)
    g = torch.ones_like(r)
    b = torch.ones_like(r)
    df = torch.full(shp, DF_INIT, dtype=F32, device=dev)
    area = torch.zeros_like(r)
    D = MAX_GROUP_DEPTH
    if groups:
        cov = torch.ones((T, D + 1, tile_h, tile_w), dtype=F32, device=dev)
        sv = torch.zeros((T, D, 3, tile_h, tile_w), dtype=F32, device=dev)
        dclip = torch.zeros(T, dtype=torch.int64, device=dev)
        dlayer = torch.zeros(T, dtype=torch.int64, device=dev)
    top = 14 if groups else 8
    max_n = int(n_host[0]) if T else 0
    for k in range(max_n):
        A = int((n_host > k).sum())
        idx = torch.clamp(tag_s[:A, k] - 2, 0, top)
        words = arg_s[:A, k]
        present = torch.unique(idx).tolist()
        Xa, Ya = X[:A], Y[:A]
        ar = torch.arange(A, device=dev)

        def arg(j):
            return words[:, j].view(A, 1, 1)

        def sel(i):
            return (idx == i).view(A, 1, 1)

        cur_cov = (lambda: cov[ar, dclip[:A]]) if groups else None
        state = (r, g, b, df, area)
        cmds = make_commands(Xa, Ya, cov=cur_cov)
        if groups:
            grad_lin, grad_rad = make_grad_commands(Xa, Ya, cov=cur_cov)
            cmds = cmds + (None, None, None, None, None, grad_lin, grad_rad)
        for i in present:
            s = sel(i)
            if i < 7 or i in (12, 13):
                ins = tuple(p[:A] for p in state)
                outs = cmds[i](arg, *ins)
                for plane, p_in, p_out in zip(state, ins, outs):
                    if p_out is not p_in:
                        plane[:A] = torch.where(s, p_out, p_in)
            elif i == 8 and not groups:     # unknown tag: debug magenta
                for plane, v in ((r, 1.0), (g, 0.0), (b, 1.0)):
                    plane[:A] = torch.where(s, v, plane[:A])
            elif i == 8:                    # begin clip
                s1 = idx == 8
                d = dclip[:A]
                ca = clip_alpha(area[:A] + arg(0), arg(1))
                nd = torch.clamp(d + 1, max=D)
                cov[ar, nd] = torch.where(s, cov[ar, d] * ca, cov[ar, nd])
                dclip[:A] = torch.where(s1, nd, d)
                area[:A] = torch.where(s, 0.0, area[:A])
            elif i == 9:                    # end clip
                dclip[:A] = torch.where(idx == 9,
                                        torch.clamp(dclip[:A] - 1, min=0),
                                        dclip[:A])
            elif i == 10:                   # begin layer
                s1 = idx == 10
                ld = torch.clamp(dlayer[:A], max=D - 1)
                rgb = torch.stack([r[:A], g[:A], b[:A]], dim=1)
                sv[ar, ld] = torch.where(s1.view(A, 1, 1, 1), rgb, sv[ar, ld])
                dlayer[:A] = torch.where(s1, torch.clamp(dlayer[:A] + 1,
                                                         max=D), dlayer[:A])
            elif i == 11:                   # end layer
                ld = torch.clamp(dlayer[:A] - 1, min=0)
                saved = sv[ar, ld]
                alpha = arg(0)
                for c, plane in enumerate((r, g, b)):
                    sc = saved[:, c]
                    plane[:A] = torch.where(s, sc + (plane[:A] - sc) * alpha,
                                            plane[:A])
                dlayer[:A] = torch.where(idx == 11, ld, dlayer[:A])
            elif i == 14:                   # winding carry
                area[:A] = torch.where(s, area[:A] + arg(0), area[:A])
    tiles = torch.empty(shp, dtype=I32, device=dev)
    tiles[order] = pack_rgba8(r, g, b)
    return _untile(tiles, tiles_x)


def fine_rasterize_plain(counts, tags, args, row0=0, *, tile_h: int,
                         tile_w: int, cmd_capacity: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fine_rasterize`."""
    return dense_plain(counts, tags, args, row0, tile_h=tile_h,
                       tile_w=tile_w, cmd_capacity=cmd_capacity,
                       groups=False)


def launch_dense(counts, tags, args, row0, *, tile_h: int, tile_w: int,
                 cmd_capacity: int, groups: bool) -> torch.Tensor:
    """Check the dense PTCL and launch ``csrc/fine_dense.cu`` on it."""
    if counts.ndim != 2:
        raise ValueError(f"counts must be (tiles_y, tiles_x), got "
                         f"{tuple(counts.shape)}")
    tiles_y, tiles_x = counts.shape
    T = tiles_y * tiles_x
    if cmd_capacity % CMD_CHUNK:
        raise ValueError(f"cmd_capacity must be a multiple of {CMD_CHUNK}")
    if tile_w > 1024:
        raise ValueError("tile_w above 1024 is not supported by the kernel")
    for name, t, dt, shape in (
            ("counts", counts, I32, (tiles_y, tiles_x)),
            ("tags", tags, I32, (T, cmd_capacity)),
            ("args", args, F32, (T, cmd_capacity * ARG_WORDS))):
        kernels.check_cuda_tensor(t, dt, name, shape)
    if args.data_ptr() % 16:
        raise ValueError("args must be 16-byte aligned")
    out = torch.empty((tiles_y * tile_h, tiles_x * tile_w), dtype=I32,
                      device=args.device)
    kernels.launch("fine_dense", "piet_fine_dense", counts.data_ptr(),
                   tags.data_ptr(), args.data_ptr(), out.data_ptr(), T,
                   tiles_x, tile_w, tile_h, cmd_capacity, int(row0),
                   int(groups))
    return out


def fine_rasterize(counts, tags, args, row0=0, *, tile_h: int, tile_w: int,
                   cmd_capacity: int) -> torch.Tensor:
    """Rasterize all tiles of a slab from the dense PTCL.

    Args:
      counts: (tiles_y, tiles_x) int32 live-command counts.
      tags: (T, CAP) int32 command tags (T = tiles_y * tiles_x, row-major).
      args: (T, CAP * 12) f32 operands (words 8-11: the draw's clip rect).
      row0: first tile row of the slab (pixel coordinates are absolute).

    Tags 2-8 are the seven core commands, tag 9 a no-op, tags >= 10 paint
    debug magenta (the clip/layer extension is ``fine_rasterize_xla``'s).
    Returns (tiles_y * tile_h, tiles_x * tile_w) int32 holding packed
    RGBA8 (R in the low byte).
    """
    if not kernels.on_cuda(counts, tags, args):
        return fine_rasterize_plain(counts, tags, args, row0, tile_h=tile_h,
                                    tile_w=tile_w, cmd_capacity=cmd_capacity)
    return launch_dense(counts, tags, args, row0, tile_h=tile_h,
                        tile_w=tile_w, cmd_capacity=cmd_capacity,
                        groups=False)
