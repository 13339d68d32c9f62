"""Device-side affine animation for any scene, in PyTorch.

Port of ``piet_tpu/scene/affine.py``: stage a scene once, then render
frames under per-item affines computed on the device from a scalar ``t``
-- no host encode per frame.  A transform is a per-item row
``[a, b, c, d, e, f]``:

    x' = a*x + b*y + e        y' = c*x + d*y + f

applied to the points, the quantized bboxes (recomputed as the builder
would: min/max over the item's transformed points, strokes inflated by
width/2, floor/ceil clamped to [0, 65535]; point-free items transform
their staged bbox corners), rect clips (the bounding rect of the
transformed corners; the NO_CLIP sentinel stays as it is) and gradient
payloads (a linear brush's plane composes with the inverse affine; a
radial brush's centre maps through it and its 1/r scales by
1/sqrt(|det|)).  Stroke widths are device-space and stay.

The transform is multiplies and adds (and, for gradients, one division
and one sqrt), each rounded on its own in eager PyTorch, so a frame is a
deterministic function of (scene, mats).  The exactness
contract is the JAX package's: pull the device-computed arrays
(:func:`~piet_tpu_torch.renderer.renderer.fetch_scene`) and render them
through the numpy oracle; the device image must equal it bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from .scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL, TAG_CIRCLE,
                    TAG_LINE, TAG_POLY)

F32 = torch.float32
#: Fill of the per-item min/max buffers (jax.ops.segment_min/max over
#: NI + 1 segments); every item that reads them owns points.
_BIG = float(np.float32(3.4e38))
_NO_CLIP_LO, _NO_CLIP_HI = -1e9, 1e9


class AffineBase(NamedTuple):
    """Static staging for affine animation (built once per scene)."""
    point_item: torch.Tensor   # (NP,) int64 point slot -> item (NI = dead)
    has_pts: torch.Tensor      # (NI,) bool item derives its bbox from points
    inflate: torch.Tensor      # (NI,) f32 bbox inflation (width/2, strokes)
    corners: torch.Tensor      # (NI, 4, 2) f32 staged bbox corners
    is_grad_lin: torch.Tensor  # (NI,) bool
    is_grad_rad: torch.Tensor  # (NI,) bool


def identity_mats(n: int) -> np.ndarray:
    m = np.zeros((n, 6), np.float32)
    m[:, 0] = 1.0
    m[:, 3] = 1.0
    return m


def rotation_about(cx: float, cy: float, angle: torch.Tensor, scale=1.0):
    """(6,) affine rotating by ``angle`` (an f32 tensor) about (cx, cy)
    with uniform ``scale`` -- the spin/zoom demo's transform."""
    ca = torch.cos(angle) * scale
    sa = torch.sin(angle) * scale
    e = cx - ca * cx + sa * cy
    f = cy - sa * cx - ca * cy
    return torch.stack([ca, -sa, sa, ca, e, f])


def build_base(scene, config, device="cuda") -> AffineBase:
    """Stage the t-independent affine-animation arrays for ``scene``
    under ``config``'s capacity padding, on ``device``."""
    NI, NP = config.max_items, config.max_points
    ni = scene.n_items
    point_item = np.full(NP, NI, np.int64)
    for i in range(ni):
        o, n = int(scene.pt_offset[i]), int(scene.n_pts[i])
        point_item[o:o + n] = i
    tags = np.zeros(NI, scene.tags.dtype)
    tags[:ni] = scene.tags
    n_pts = np.zeros(NI, np.int32)
    n_pts[:ni] = scene.n_pts
    widths = np.zeros(NI, np.float32)
    widths[:ni] = scene.widths
    flags = np.zeros(NI, np.uint32)
    flags[:ni] = scene.flags
    bb = np.zeros((NI, 4), np.float32)
    bb[:ni] = scene.bboxes.astype(np.float32)
    corners = np.stack([bb[:, [0, 1]], bb[:, [2, 1]],
                        bb[:, [0, 3]], bb[:, [2, 3]]], axis=1)
    is_stroke = (tags == TAG_POLY) | (tags == TAG_LINE)
    inflate = np.where(is_stroke, widths * np.float32(0.5),
                       np.float32(0.0)).astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return AffineBase(
        point_item=put(point_item),
        has_pts=put((n_pts > 0) & (tags != TAG_CIRCLE)),
        inflate=put(inflate),
        corners=put(corners.astype(np.float32)),
        is_grad_lin=put((flags & FLAG_BRUSH_LINEAR) != 0),
        is_grad_rad=put((flags & FLAG_BRUSH_RADIAL) != 0),
    )


def _seg_reduce(vals, seg, n: int, fill: float, how: str):
    """Per-item min/max over point slots (``seg`` = item id, ``n`` for
    dead slots), into n + 1 rows that start at ``fill``."""
    out = torch.full((n + 1,), fill, dtype=F32, device=vals.device)
    return out.scatter_reduce(0, seg, vals, how, include_self=True)[:n]


def transform_device_scene(dev, ab: AffineBase, mats):
    """Apply per-item affines to a staged DeviceScene.

    Args:
      dev: prepare_scene(..., seg_pre=False) output (the staged scene).
      ab: build_base(...) output, on the same device.
      mats: (NI, 6) f32 per-item [a, b, c, d, e, f], or (6,) for every
        item; a tensor or an array.

    Returns the frame's DeviceScene, with ``seg_pre=None``.
    """
    NI = dev.tags.shape[0]
    if not isinstance(mats, torch.Tensor):
        mats = torch.tensor(np.asarray(mats, np.float32))
    mats = mats.to(device=dev.points.device, dtype=F32)
    if mats.ndim == 1:
        mats = mats[None, :].expand(NI, 6)

    # ---- points --------------------------------------------------------
    A = mats[torch.clamp(ab.point_item, max=NI - 1)]       # (NP, 6)
    live = ab.point_item < NI
    x = dev.points[:, 0]
    y = dev.points[:, 1]
    nx = (A[:, 0] * x + A[:, 1] * y) + A[:, 4]
    ny = (A[:, 2] * x + A[:, 3] * y) + A[:, 5]
    points = torch.where(live[:, None], torch.stack([nx, ny], dim=1),
                         dev.points)

    # ---- bboxes --------------------------------------------------------
    seg = ab.point_item
    mnx = _seg_reduce(torch.where(live, nx, _BIG), seg, NI, _BIG, "amin")
    mny = _seg_reduce(torch.where(live, ny, _BIG), seg, NI, _BIG, "amin")
    mxx = _seg_reduce(torch.where(live, nx, -_BIG), seg, NI, -_BIG, "amax")
    mxy = _seg_reduce(torch.where(live, ny, -_BIG), seg, NI, -_BIG, "amax")
    # Point-free items (circles): transform the staged bbox corners.
    cx = (mats[:, 0, None] * ab.corners[:, :, 0]
          + mats[:, 1, None] * ab.corners[:, :, 1]) + mats[:, 4, None]
    cy = (mats[:, 2, None] * ab.corners[:, :, 0]
          + mats[:, 3, None] * ab.corners[:, :, 1]) + mats[:, 5, None]
    mnx = torch.where(ab.has_pts, mnx, cx.amin(dim=1))
    mny = torch.where(ab.has_pts, mny, cy.amin(dim=1))
    mxx = torch.where(ab.has_pts, mxx, cx.amax(dim=1))
    mxy = torch.where(ab.has_pts, mxy, cy.amax(dim=1))
    lo_x = torch.clamp(torch.floor(mnx - ab.inflate), 0.0, 65535.0)
    hi_x = torch.clamp(torch.ceil(mxx + ab.inflate), 0.0, 65535.0)
    lo_y = torch.clamp(torch.floor(mny - ab.inflate), 0.0, 65535.0)
    hi_y = torch.clamp(torch.ceil(mxy + ab.inflate), 0.0, 65535.0)
    bboxes = torch.stack([lo_x, lo_y, hi_x, hi_y], dim=1).to(torch.int32)

    # ---- rect clips (bounding rect of transformed corners) -------------
    ccx0, ccy0 = dev.clips[:, 0], dev.clips[:, 1]
    ccx1, ccy1 = dev.clips[:, 2], dev.clips[:, 3]
    kx = torch.stack([ccx0, ccx1, ccx0, ccx1], dim=1)
    ky = torch.stack([ccy0, ccy0, ccy1, ccy1], dim=1)
    tkx = (mats[:, 0, None] * kx + mats[:, 1, None] * ky) + mats[:, 4, None]
    tky = (mats[:, 2, None] * kx + mats[:, 3, None] * ky) + mats[:, 5, None]
    # The NO_CLIP sentinel rect must stay the sentinel bitwise (its
    # coverage multiply is an exact *1.0): only remap real clip rects.
    has_clip = ((ccx0 > _NO_CLIP_LO) | (ccy0 > _NO_CLIP_LO)
                | (ccx1 < _NO_CLIP_HI) | (ccy1 < _NO_CLIP_HI))
    clips = torch.where(
        has_clip[:, None],
        torch.stack([tkx.amin(1), tky.amin(1), tkx.amax(1), tky.amax(1)],
                    dim=1),
        dev.clips)

    # ---- gradient brushes ----------------------------------------------
    a_, b_, c_, d_ = mats[:, 0], mats[:, 1], mats[:, 2], mats[:, 3]
    e_, f_ = mats[:, 4], mats[:, 5]
    det = a_ * d_ - b_ * c_
    safe = torch.where(det != 0.0, det, 1.0)
    g = dev.grads
    # Linear: compose the plane equation with the inverse affine.
    gx, gy, gofs = g[:, 0], g[:, 1], g[:, 2]
    ngx = (gx * d_ - gy * c_) / safe
    ngy = (gy * a_ - gx * b_) / safe
    ngofs = gofs - (ngx * e_ + ngy * f_)
    # Radial: centre through the affine; 1/r by 1/sqrt(|det|).
    rcx, rcy, rinv = g[:, 0], g[:, 1], g[:, 2]
    nrcx = (a_ * rcx + b_ * rcy) + e_
    nrcy = (c_ * rcx + d_ * rcy) + f_
    nrinv = rinv / torch.sqrt(torch.abs(safe))
    lin, rad = ab.is_grad_lin, ab.is_grad_rad
    g0 = torch.where(lin, ngx, torch.where(rad, nrcx, g[:, 0]))
    g1 = torch.where(lin, ngy, torch.where(rad, nrcy, g[:, 1]))
    g2 = torch.where(lin, ngofs, torch.where(rad, nrinv, g[:, 2]))
    grads = torch.cat([torch.stack([g0, g1, g2], dim=1), g[:, 3:]], dim=1)

    return dev._replace(points=points, bboxes=bboxes, clips=clips,
                        grads=grads, seg_pre=None)


def host_transform_scene(scene, m):
    """Numpy twin of :func:`transform_device_scene` for ONE global affine
    ``m`` (6,): fits capacity envelopes over a ``t`` sweep (record counts
    change with the transform).  Transforms points, recomputes quantized
    bboxes (with stroke inflation); clips and gradient payloads, which
    capacity fitting does not read, stay as they are."""
    m = np.asarray(m, np.float32)
    x, y = scene.points[:, 0], scene.points[:, 1]
    nx = (m[0] * x + m[1] * y) + m[4]
    ny = (m[2] * x + m[3] * y) + m[5]
    points = np.stack([nx, ny], axis=1).astype(np.float32)
    n = scene.n_items
    bboxes = scene.bboxes.copy()
    is_stroke = (scene.tags == TAG_POLY) | (scene.tags == TAG_LINE)
    for i in range(n):
        o, k = int(scene.pt_offset[i]), int(scene.n_pts[i])
        if k > 0 and scene.tags[i] != TAG_CIRCLE:
            mn = points[o:o + k].min(0)
            mx = points[o:o + k].max(0)
        else:
            bb = scene.bboxes[i].astype(np.float32)
            cx = (m[0] * bb[[0, 2, 0, 2]] + m[1] * bb[[1, 1, 3, 3]]) + m[4]
            cy = (m[2] * bb[[0, 2, 0, 2]] + m[3] * bb[[1, 1, 3, 3]]) + m[5]
            mn = np.array([cx.min(), cy.min()])
            mx = np.array([cx.max(), cy.max()])
        infl = 0.5 * float(scene.widths[i]) if is_stroke[i] else 0.0
        bboxes[i] = [
            int(np.clip(np.floor(mn[0] - infl), 0, 65535)),
            int(np.clip(np.floor(mn[1] - infl), 0, 65535)),
            int(np.clip(np.ceil(mx[0] + infl), 0, 65535)),
            int(np.clip(np.ceil(mx[1] + infl), 0, 65535))]
    return dataclasses.replace(scene, points=points, bboxes=bboxes)


def make_affine_render_fn(config, scene, mats_fn: Callable, device="cuda",
                          fine_impl: str = "auto"):
    """``t -> (image, stats)`` rendering ``scene`` under ``mats_fn(t)``
    ((NI, 6) or (6,) affines from a 0-d f32 tensor on the device, torch
    ops only): transform, coarse (segments derived on the device), fine
    and present, the whole frame in ONE step -- one CUDA graph replay on a
    CUDA device, as the JAX package jits it (renderer/renderer.py::
    make_time_render_fn).

    The scene is staged once; a frame is a fill of the step's ``t`` and
    a replay, with no host encode.  ``render_t.scene_at(t)`` returns the
    frame's DeviceScene, computed eagerly (for the oracle contract; see
    the module doc).  ``fine_impl`` picks the frame route.
    """
    from ..renderer.renderer import (check_device, frame_scalar,
                                     make_time_render_fn, prepare_scene)

    dev = check_device(device)
    base = prepare_scene(scene, config, dev, seg_pre=False)
    ab = build_base(scene, config, dev)

    def scene_at(t):
        return transform_device_scene(base, ab,
                                      mats_fn(frame_scalar(t, dev)))

    render_t = make_time_render_fn(config, scene_at, dev, fine_impl)
    render_t.scene_at = scene_at
    return render_t
