"""Device-side animation of the animated fixture, in PyTorch.

Port of ``piet_tpu/scene/animate.py``.  The animated fixture
(scene/fixtures.py::make_animated_frame) is a pure function of a scalar
``t`` and a few seeded parameters: item i is a 12-gon of radius r/2
orbiting (centers[i], radii[i]) at angular phase
``phases[i] + t * (1 + 0.2*(i%7))``; every third item is a closed stroked
polyline (width 2 + i%5), the rest are fills; alpha is
``int(96 + 96 sin(t + phase))``.  Topology (tags, counts, offsets, flags,
clip and gradient payloads) does not depend on ``t``, so a host-built
template frame is staged once and a frame recomputes only points, bboxes
and colours on the device, then derives its segments there.

Device trig (``torch.cos``/``torch.sin`` on CUDA) differs from the CPU's
and from libm in the last ulp, so frames are not bitwise equal across
devices at the same ``t``.  The exactness contract is the JAX package's:
pull the device-computed arrays
(:func:`~piet_tpu_torch.renderer.renderer.fetch_scene`) and render them
through the numpy oracle; the device image must equal it bitwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

F32, I32 = torch.float32, torch.int32
K_VERTS = 12
_STEP = float(np.float32(2.0 * math.pi / K_VERTS))


class AnimatedParams(NamedTuple):
    """Static (t-independent) animation parameters, staged once."""
    centers: torch.Tensor     # (n, 2) f32
    radii: torch.Tensor       # (n,) f32
    phases: torch.Tensor      # (n,) f32
    speed: torch.Tensor       # (n,) f32: 1 + 0.2*(i % 7)
    color_hi: torch.Tensor    # (n,) int32 bits of the uint32 rgb << 8
    half_width: torch.Tensor  # (n,) f32: bbox inflation (width/2; 0 fills)
    slot_item: torch.Tensor   # (NP_live,) int64: point slot -> item
    slot_vert: torch.Tensor   # (NP_live,) int64: point slot -> vertex
    n_live_points: int        # total live points


def host_params(size: int = 1024, n: int = 200, seed: int = 5,
                device="cuda") -> AnimatedParams:
    """The staged parameter arrays on ``device`` (the same seeded draws,
    in the same numpy call order, as make_animated_frame)."""
    from .fixtures import _animated_params

    centers, radii, phases, color_hi = _animated_params(size, n, seed)
    idx = np.arange(n)
    speed = (1.0 + 0.2 * (idx % 7)).astype(np.float32)
    is_poly = (idx % 3) == 0
    width = np.where(is_poly, 2.0 + (idx % 5), 0.0).astype(np.float32)
    # f32 width * f32 0.5, as SceneBuilder.polyline computes it.
    half_width = width * np.float32(0.5)
    # Flat point layout: item i owns n_pts[i] consecutive slots (polys
    # carry the closing 13th vertex == vertex 0).
    n_pts = np.where(is_poly, K_VERTS + 1, K_VERTS)
    offsets = np.concatenate([[0], np.cumsum(n_pts)[:-1]])
    total = int(n_pts.sum())
    slot_item = np.repeat(idx, n_pts).astype(np.int64)
    slot_vert = (np.arange(total) - offsets[slot_item]) % K_VERTS

    def put(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a).to(device)

    return AnimatedParams(
        centers=put(centers, np.float32), radii=put(radii, np.float32),
        phases=put(phases, np.float32), speed=put(speed),
        color_hi=put(color_hi.view(np.int32)), half_width=put(half_width),
        slot_item=put(slot_item), slot_vert=put(slot_vert, np.int64),
        n_live_points=total)


def alpha_linear(code: torch.Tensor) -> torch.Tensor:
    """Alpha code -> linear alpha, code / 255 correctly rounded, as
    scene/color.py::decode_color_linear computes it.  The divisor is a
    tensor on purpose: PyTorch's CUDA division by a host scalar multiplies
    by the scalar's reciprocal, which is 1 ulp off for some codes."""
    f = code.to(F32)
    return f / torch.full_like(f, 255.0)


def template_scene(size: int = 1024, n: int = 200, seed: int = 5):
    """The t=0 host-built frame: source of every t-independent field."""
    from .fixtures import make_animated_frame
    return make_animated_frame(0.0, size=size, n=n, seed=seed)


def animate_device_scene(base, p: AnimatedParams, t):
    """Recompute the t-dependent fields of a staged DeviceScene.

    ``base`` is prepare_scene(template_scene(...), config, device,
    seg_pre=False); ``t`` is a number or a 0-d f32 tensor."""
    from ..renderer.renderer import frame_scalar
    t = frame_scalar(t, base.points.device)
    n = p.centers.shape[0]
    th = p.phases + t * p.speed                         # (n,)
    r = p.radii
    ox = p.centers[:, 0] + torch.cos(th) * r
    oy = p.centers[:, 1] + torch.sin(th) * r
    j = torch.arange(K_VERTS, dtype=F32, device=th.device) * _STEP
    ang = j[None, :] + th[:, None]                      # (n, 12)
    vx = ox[:, None] + torch.cos(ang) * (r * 0.5)[:, None]
    vy = oy[:, None] + torch.sin(ang) * (r * 0.5)[:, None]
    verts = torch.stack([vx, vy], dim=-1)               # (n, 12, 2)

    pts = verts[p.slot_item, p.slot_vert]               # (NP_live, 2)
    points = torch.cat([pts, base.points[p.n_live_points:]])

    # Bbox: min/max over the item's vertices, polyline inflation, then
    # the u16 quantization of scene.quantize_bbox.
    mn = verts.amin(dim=1) - p.half_width[:, None]
    mx = verts.amax(dim=1) + p.half_width[:, None]

    def q(v, up):
        v = torch.ceil(v) if up else torch.floor(v)
        return torch.clamp(v, 0.0, 65535.0).to(I32)

    bbox = torch.cat([q(mn, False), q(mx, True)], dim=1)
    bboxes = torch.cat([bbox, base.bboxes[n:]])

    # Alpha: int(96 + 96 sin(t + phase)) & 0xFF, in [0, 192], so the
    # truncating int() is floor.  color_hi | alpha sets bit 31 for half
    # the colours: it stays int32 bits.
    alpha = torch.floor(96.0 + 96.0 * torch.sin(t + p.phases)).to(I32) & 0xFF
    colors_u32 = torch.cat([p.color_hi | alpha, base.colors_u32[n:]])
    # Linear decode: rgb is t-independent (already staged); alpha's
    # linear value is code/255 (scene/color.py).
    alpha_lin = alpha_linear(alpha)
    colors_lin = torch.cat([
        torch.cat([base.colors_lin[:n, :3], alpha_lin[:, None]], dim=1),
        base.colors_lin[n:]])

    return base._replace(points=points, bboxes=bboxes, colors_u32=colors_u32,
                         colors_lin=colors_lin, seg_pre=None)


def make_animated_render_fn(config, *, size: int = 1024, n: int = 200,
                            seed: int = 5, device="cuda",
                            fine_impl: str = "auto"):
    """``t -> (image, stats)`` with the whole frame -- geometry, coarse
    (segments derived on the device), fine, present -- in ONE step on
    ``device``: one CUDA graph replay a frame on a CUDA device, as the JAX
    package jits it (renderer/renderer.py::make_time_render_fn).
    Returns (render_t, template scene) so callers can check capacities;
    ``render_t.scene_at(t)`` returns the frame's DeviceScene, computed
    eagerly; ``fine_impl`` picks the frame route."""
    from ..renderer.renderer import (check_device, make_time_render_fn,
                                     prepare_scene)

    dev = check_device(device)
    tmpl = template_scene(size=size, n=n, seed=seed)
    base = prepare_scene(tmpl, config, dev, seg_pre=False)
    params = host_params(size=size, n=n, seed=seed, device=dev)

    def scene_at(t):
        return animate_device_scene(base, params, t)

    render_t = make_time_render_fn(config, scene_at, dev, fine_impl)
    render_t.scene_at = scene_at
    return render_t, tmpl
