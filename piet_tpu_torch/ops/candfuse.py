"""Candidate-record expansion with exact tile decode (kernel A).

Port of ``piet_tpu/ops/candfuse.py``.  Each item's (NI, 32) attribute row
expands into one record per (item, tile in its bbox rect), and each record
decodes its tile from its rank with the exact f32 divmod of
``ops/coarse.py::_fdivmod``.  Rows travel as int32 bit patterns: several
words are integers or NaN-pattern colours that must not pass through
float arithmetic.

The CUDA kernels are ``csrc/candfuse.cu``: ``cand_prep`` builds the item
rows from the scene's fields (:func:`cand_prep`, the glue of
``ops/coarse.py::cand_inputs``, whose plain version is
``cand_inputs_plain``), ``cand_expand`` expands them
(:func:`cand_records_fused`; plain version
:func:`cand_records_fused_plain`, bit for bit).  :func:`cand_prep_expand`
runs both in one call, as the coarse pass does: the expansion is a
programmatic dependent launch behind the rows.
"""

from __future__ import annotations

import torch

from .. import kernels

#: Words per candidate row (ops/coarse.py::cand_pack).
CAND_WORDS = 32
#: cand_pack word indices of the packed item ints the decode reads.
W_CEXCL, W_BX0, W_BY0, W_BW = 18, 19, 20, 23
#: Constants of csrc/candfuse.cu: items a prep block takes (one a thread)
#: and slots an expansion block takes.
PREP_ITEMS = 512
BLOCK = 128

I32, F32 = torch.int32, torch.float32
#: The DeviceScene fields cand_prep reads in place: name, dtype, shape
#: past the item axis.
SCENE_FIELDS = (("tags", I32, ()), ("colors_u32", I32, ()),
                ("colors_lin", F32, (4,)), ("widths", F32, ()),
                ("bboxes", I32, (4,)), ("pt_offset", I32, ()),
                ("n_pts", I32, ()), ("flags", I32, ()), ("clips", F32, (4,)),
                ("grads", F32, (8,)))


def fdivmod(local: torch.Tensor, w: torch.Tensor):
    """Exact floor-div/mod of small non-negative ints via f32 with residue
    fixup (ops/coarse.py::_fdivmod).  ``w`` >= 1."""
    q = torch.floor(local.to(torch.float32) / w.to(torch.float32)).to(
        torch.int32)
    r = local - q * w
    q = q + (r >= w).to(torch.int32) - (r < 0).to(torch.int32)
    return q, local - q * w


def owner_of(excl: torch.Tensor, counts: torch.Tensor, cap: int):
    """Owning row of every slot in [0, cap): the first row whose inclusive
    cumsum exceeds the slot (clamped to a valid row past the total)."""
    incl = excl + counts
    p = torch.arange(cap, dtype=torch.int32, device=excl.device)
    s = torch.searchsorted(incl, p, right=True)
    return p, s.clamp(max=max(excl.shape[0] - 1, 0))


def cand_records_fused_plain(cand_pack, counts, excl, total, row0: int,
                             cap: int, *, tiles_x: int):
    """Plain PyTorch version of kernel A; see :func:`cand_records_fused`."""
    p, s = owner_of(excl, counts, cap)
    valid = (p < total)[:, None]
    ca = torch.where(valid, cand_pack[s], 0)
    local = p - ca[:, W_CEXCL]
    dy, dx = fdivmod(local, torch.clamp(ca[:, W_BW], min=1))
    cand_ty = ca[:, W_BY0] + dy
    cand_tx = ca[:, W_BX0] + dx
    cand_tile = (cand_ty - row0) * tiles_x + cand_tx
    return ca.view(torch.float32), cand_tile, cand_ty, cand_tx


def cand_records_fused(cand_pack, counts, excl, total, row0: int, cap: int,
                       *, tiles_x: int):
    """Expand per-item rows into candidate records with tile decode.

    Args:
      cand_pack: (NI, 32) int32 bit patterns (ops/coarse.py::cand_pack).
      counts/excl: (NI,) int32 tile-rect areas and their exclusive cumsum.
      total: () or (1,) int32 live candidate count, on the device.
      row0: first tile row of the slab.
      cap: candidate capacity.

    Returns (ca, cand_tile, cand_ty, cand_tx): ``ca`` is (cap, 32) f32
    holding the rows' exact bit patterns, all-zero at and past ``total``;
    the decode is int32, and past ``total`` it is the decode of the zero
    row (ty = slot, tx = 0), as in the staged JAX path.
    """
    if not kernels.on_cuda(cand_pack, counts, excl, total):
        return cand_records_fused_plain(cand_pack, counts, excl, total, row0,
                                        cap, tiles_x=tiles_x)
    ni = cand_pack.shape[0]
    for name, t, shape in (("cand_pack", cand_pack, (ni, CAND_WORDS)),
                           ("counts", counts, (ni,)), ("excl", excl, (ni,)),
                           ("total", total, None)):
        kernels.check_cuda_tensor(t, I32, name, shape)
    if total.numel() != 1:
        raise ValueError("total must hold one count")
    if ni == 0:
        raise ValueError("cand_records_fused needs at least one item")
    _check_aligned(cand_pack)
    out = _records(cap, cand_pack.device, 4)
    kernels.launch("candfuse", "piet_cand_expand", *_ptrs(
        (cand_pack, counts, excl, total) + out), ni, cap, tiles_x, int(row0))
    return (out[0].view(F32),) + out[1:]


def cand_prep(scene, *, tiles_x: int, tiles_y: int, tile_w: int,
              tile_h: int, row0: int = 0):
    """Kernel A's item rows on the card, one call: the glue of
    ``ops/coarse.py::cand_inputs`` (its plain version
    ``cand_inputs_plain``).

    ``scene`` has the DeviceScene fields of :data:`SCENE_FIELDS` and
    ``n_items`` (one int32), contiguous, on one CUDA device.  Returns the
    (NI, 32) int32 rows, the (NI,) counts and exclusive offsets and the
    (1,) live total.
    """
    fields, rows, sums = _prep_args(scene, tile_w, tile_h)
    kernels.launch("candfuse", "piet_cand_prep", *_ptrs(fields + [sums]
                                                        + rows),
                   rows[1].shape[0], tiles_x, tiles_y, tile_w, tile_h,
                   int(row0))
    return tuple(rows)


def cand_prep_expand(scene, *, tiles_x: int, tiles_y: int, tile_w: int,
                     tile_h: int, row0: int, cap: int):
    """Kernel A as the coarse pass calls it, one call on the card:
    :func:`cand_prep`, then :func:`cand_records_fused` of its rows into
    ``cap`` records, without ``cand_tx``, as a programmatic dependent
    launch behind them.  Returns ``(rows, ca, cand_tile, cand_ty)``:
    ``rows`` as :func:`cand_prep` returns them."""
    fields, rows, sums = _prep_args(scene, tile_w, tile_h)
    out = _records(cap, rows[0].device, 3)
    kernels.launch("candfuse", "piet_cand_stage", *_ptrs(
        fields + [sums] + rows + list(out)), rows[1].shape[0], cap, tiles_x,
        tiles_y, tile_w, tile_h, int(row0))
    return (tuple(rows), out[0].view(F32)) + out[1:]


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _check_aligned(t):
    if t.data_ptr() % 16:
        raise ValueError("candidate rows must be 16-byte aligned")


def _records(cap: int, dev, n: int):
    """The expansion's outputs: (cap, 32) rows, then n - 1 (cap,) words."""
    return (torch.empty((cap, CAND_WORDS), dtype=I32, device=dev),) + tuple(
        torch.empty((cap,), dtype=I32, device=dev) for _ in range(n - 1))


def _prep_args(scene, tile_w: int, tile_h: int):
    """The scene's fields (checked) and n_items, cand_prep's outputs and
    its per-block scratch."""
    fields = [getattr(scene, name) for name, _, _ in SCENE_FIELDS]
    if not kernels.on_cuda(*fields, scene.n_items):
        raise ValueError("cand_prep runs on CUDA tensors only")
    ni = scene.tags.shape[0]
    for (name, dtype, tail), t in zip(SCENE_FIELDS, fields):
        kernels.check_cuda_tensor(t, dtype, name, (ni,) + tail)
    kernels.check_cuda_tensor(scene.n_items, I32, "n_items")
    if scene.n_items.numel() != 1:
        raise ValueError("n_items must hold one count")
    if ni == 0:
        raise ValueError("cand_prep needs at least one item")
    if tile_w <= 0 or tile_h <= 0:
        raise ValueError("tile sizes must be positive")
    dev = scene.tags.device
    rows = [torch.empty((ni, CAND_WORDS), dtype=I32, device=dev),
            torch.empty((ni,), dtype=I32, device=dev),
            torch.empty((ni,), dtype=I32, device=dev),
            torch.empty((1,), dtype=I32, device=dev)]
    _check_aligned(rows[0])
    sums = torch.empty((-(-ni // PREP_ITEMS),), dtype=I32, device=dev)
    return fields + [scene.n_items], rows, sums
