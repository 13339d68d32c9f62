"""A scene under one affine, as the port's device animation defines it.

The benchmark's own numpy statement of the transform that
``piet_tpu_torch/scene/affine.py::transform_device_scene`` applies on the
device, for one affine ``m = [a, b, c, d, e, f]`` shared by every item:

    x' = (a*x + b*y) + e        y' = (c*x + d*y) + f

each multiply and add rounded to f32 on its own.  Bboxes are recomputed:
min/max over the item's transformed points (point-free items, circles,
transform their bbox corners), strokes inflated by width/2, floor/ceil
clamped to [0, 65535].  Rect clips become the bounding rect of their
transformed corners (the NO_CLIP sentinel stays); a linear gradient's
plane composes with the inverse affine, a radial one's centre maps
through it and its 1/r scales by 1/sqrt(|det|).  Stroke widths stay.

The rebuild traffic makes its host scenes with it, and the reference
works out each device-animated frame's geometry with it again from the
frame's matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .scene.scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL, TAG_CIRCLE,
                          TAG_LINE, TAG_POLY)

F = np.float32
_BIG = F(3.4e38)
_NO_CLIP_LO, _NO_CLIP_HI = F(-1e9), F(1e9)


def _apply(m, x, y):
    a, b, c, d, e, f = (F(v) for v in m)
    return (a * x + b * y) + e, (c * x + d * y) + f


def transform_scene(scene, m):
    """``scene`` (a Scene) under the affine ``m`` (6 numbers): a new Scene."""
    m = np.asarray(m, F)
    n = scene.n_items
    pts = scene.points.astype(F)
    nx, ny = _apply(m, pts[:, 0], pts[:, 1])
    points = np.stack([nx, ny], axis=1).astype(F)

    # Per-item min/max over the item's points.
    owner = np.full(points.shape[0], -1, np.int64)
    for i in np.nonzero(scene.n_pts > 0)[0]:
        o = int(scene.pt_offset[i])
        owner[o:o + int(scene.n_pts[i])] = i
    live = owner >= 0
    mn = np.full((n, 2), _BIG, F)
    mx = np.full((n, 2), -_BIG, F)
    np.minimum.at(mn, owner[live], points[live])
    np.maximum.at(mx, owner[live], points[live])

    bb = scene.bboxes.astype(F)
    cx, cy = _apply(m, bb[:, [0, 2, 0, 2]], bb[:, [1, 1, 3, 3]])
    has_pts = (scene.n_pts > 0) & (scene.tags != TAG_CIRCLE)
    mnx = np.where(has_pts, mn[:, 0], cx.min(axis=1))
    mny = np.where(has_pts, mn[:, 1], cy.min(axis=1))
    mxx = np.where(has_pts, mx[:, 0], cx.max(axis=1))
    mxy = np.where(has_pts, mx[:, 1], cy.max(axis=1))
    is_stroke = (scene.tags == TAG_POLY) | (scene.tags == TAG_LINE)
    inflate = np.where(is_stroke, scene.widths.astype(F) * F(0.5), F(0.0))

    def q(v, rnd):
        return np.clip(rnd(v.astype(F)), F(0.0), F(65535.0)).astype(np.int32)

    bboxes = np.stack([q(mnx - inflate, np.floor), q(mny - inflate, np.floor),
                       q(mxx + inflate, np.ceil), q(mxy + inflate, np.ceil)],
                      axis=1)

    cl = scene.clips.astype(F)
    kx = cl[:, [0, 2, 0, 2]]
    ky = cl[:, [1, 1, 3, 3]]
    tkx, tky = _apply(m, kx, ky)
    has_clip = ((cl[:, 0] > _NO_CLIP_LO) | (cl[:, 1] > _NO_CLIP_LO)
                | (cl[:, 2] < _NO_CLIP_HI) | (cl[:, 3] < _NO_CLIP_HI))
    clips = np.where(has_clip[:, None],
                     np.stack([tkx.min(1), tky.min(1), tkx.max(1),
                               tky.max(1)], axis=1), cl).astype(F)

    a_, b_, c_, d_, e_, f_ = (F(v) for v in m)
    det = a_ * d_ - b_ * c_
    safe = det if det != 0.0 else F(1.0)
    g = scene.grads.astype(F)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ngx = (g[:, 0] * d_ - g[:, 1] * c_) / safe
        ngy = (g[:, 1] * a_ - g[:, 0] * b_) / safe
        ngofs = g[:, 2] - (ngx * e_ + ngy * f_)
        nrcx = (a_ * g[:, 0] + b_ * g[:, 1]) + e_
        nrcy = (c_ * g[:, 0] + d_ * g[:, 1]) + f_
        nrinv = g[:, 2] / np.sqrt(np.abs(safe))
    lin = (scene.flags & FLAG_BRUSH_LINEAR) != 0
    rad = (scene.flags & FLAG_BRUSH_RADIAL) != 0
    grads = g.copy()
    grads[:, 0] = np.where(lin, ngx, np.where(rad, nrcx, g[:, 0]))
    grads[:, 1] = np.where(lin, ngy, np.where(rad, nrcy, g[:, 1]))
    grads[:, 2] = np.where(lin, ngofs, np.where(rad, nrinv, g[:, 2]))

    return dataclasses.replace(scene, points=points, bboxes=bboxes,
                               clips=clips, grads=grads.astype(F))
