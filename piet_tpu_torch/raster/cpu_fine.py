"""CPU golden fine rasterizer: PTCL -> pixels, the image oracle.

Implements exactly the per-pixel command interpreter of the reference's
``renderKernel`` (PietRender.metal:457-566), vectorized over a tile's pixel
block in float32 numpy:

* distance-field strokes  (stroke() :49-55, renderDf :58-60)
* exact trapezoid coverage fills + winding  (:508-528, :535-545)
* left-edge backdrop correction  (CmdFillEdge, :530-534)
* circles  (:481-493, blended black -- color is never encoded, a reference
  quirk), solids, and the in-shader linear->sRGB encode (:563)

Precision policy (applies identically to the Pallas kernel, ops/fine.py):
float32 throughout.  The reference mixes f32 positions with f16 color and
coverage accumulators (``half signedArea``, PietRender.metal:472, with an
acknowledged accuracy TODO at :525); TPU has no f16 and bf16 would band
visibly, so piet-tpu runs the whole pipeline in f32 -- a strict quality
improvement, encoded once here so the oracle and the device kernel agree
bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from ..config import RenderConfig
from ..scene.color import srgb_encode_u8
from .ptcl import (CMD_CIRCLE, CMD_DRAW_FILL, CMD_FILL, CMD_FILL_EDGE,
                   CMD_LINE, CMD_SOLID, CMD_STROKE, Ptcl,
                   CMD_BEGIN_CLIP, CMD_END_CLIP, CMD_BEGIN_LAYER,
                   CMD_END_LAYER, CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD,
                   CMD_WIND)

F = np.float32
DF_INIT = F(1e9)


def _saturate(v: np.ndarray) -> np.ndarray:
    return np.clip(v, F(0.0), F(1.0))


def _clip_cov(av: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Antialiased coverage of the clip rect in args words 8-11 (the piet
    clip extension).  The NO_CLIP bounds give exactly 1.0 everywhere, so
    the alpha multiply is a bitwise no-op for unclipped items."""
    cx0, cy0, cx1, cy1 = (F(v) for v in av[8:12])
    covx = _saturate(np.minimum(cx1, X + F(1.0)) - np.maximum(cx0, X))
    covy = _saturate(np.minimum(cy1, Y + F(1.0)) - np.maximum(cy0, Y))
    return covx * covy


def render_tile(tags: np.ndarray, args: np.ndarray, count: int,
                x0: float, y0: float, th: int, tw: int) -> np.ndarray:
    """Interpret one tile's command list; returns (th, tw, 3) linear f32."""
    xs = (F(x0) + np.arange(tw, dtype=F))[None, :]
    ys = (F(y0) + np.arange(th, dtype=F))[:, None]
    X = np.broadcast_to(xs, (th, tw)).astype(F)
    Y = np.broadcast_to(ys, (th, tw)).astype(F)

    rgb = np.ones((th, tw, 3), F)
    df = np.full((th, tw), DF_INIT, F)
    area = np.zeros((th, tw), F)
    # Clip / layer group stacks (extension commands; scene.MAX_GROUP_DEPTH
    # bounds the depth).  cov[-1] multiplies every draw's alpha; 1.0 when
    # no clip is open (an exact no-op multiply).
    cov_stack = [np.ones((th, tw), F)]
    layer_stack = []

    for i in range(count):
        tag = int(tags[i])
        av = args[i]
        if tag == CMD_CIRCLE:
            bx0, by0, bx1, by1 = (F(v) for v in av[:4])
            cx = bx0 + F(0.5) * (bx1 - bx0)
            cy = by0 + F(0.5) * (by1 - by0)
            r = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2, dtype=F)
            circle_r = min(cx - bx0, cy - by0)
            alpha = _saturate(circle_r - r) * _clip_cov(av, X, Y) \
                * cov_stack[-1]
            rgb = rgb * (F(1.0) - alpha)[..., None]  # mix toward black
        elif tag == CMD_LINE:
            sx, sy, ex, ey = (F(v) for v in av[:4])
            inv_denom = F(av[5])
            lvx, lvy = ex - sx, ey - sy
            dpx, dpy = X - sx, Y - sy
            # Division-free (round 5): word 5 carries the per-command
            # div_det(1, |v|^2); +inf marks a degenerate (zero-length)
            # segment, rendered as a dot (t=0) rather than relying on the
            # reference's NaN-dropping fmin behavior (PietRender.metal:52
            # would produce NaN there).  Mirrors cmd_math.line_field_sq
            # op-for-op.
            t = (_saturate((lvx * dpx + lvy * dpy) * inv_denom)
                 if np.isfinite(inv_denom) else np.zeros_like(X))
            fx = lvx * t - dpx
            fy = lvy * t - dpy
            field = np.sqrt(fx * fx + fy * fy, dtype=F)
            df = np.minimum(df, field)
        elif tag == CMD_STROKE:
            half_width = F(av[0])
            fg = av[1:5].astype(F)
            alpha = _saturate(half_width + F(0.5) - df) \
                * _clip_cov(av, X, Y) * cov_stack[-1]
            w = (fg[3] * alpha)[..., None]
            rgb = rgb + (fg[None, None, :3] - rgb) * w
            df = np.full_like(df, DF_INIT)
        elif tag == CMD_FILL:
            # Division-free trapezoid coverage (round 5): operands are
            # [sx, sy, ey, m, K] with m = div_det(dx, dy) and
            # K = div_det(-dy, |dx|) precomputed per command (ptcl.py).
            # Mirrors cmd_math.fill_delta op-for-op; rationale there.
            sx, sy, ey, m, K = (F(v) for v in av[:5])
            rsy = sy - Y
            rey = ey - Y
            w0 = _saturate(rsy)
            w1 = _saturate(rey)
            mask = w0 != w1
            with np.errstate(invalid="ignore", over="ignore"):
                wa = np.minimum(w0, w1)
                wb = np.maximum(w0, w1)
                rx = sx - X
                ua = rx + m * (wa - rsy)
                ub = rx + m * (wb - rsy)
                umin = np.minimum(ua, ub)
                umax = np.maximum(ua, ub)

                def Fint(u):
                    c = _saturate(u)
                    return np.minimum(u, F(1.0)) - F(0.5) * (c * c)

                delta = ((Fint(umax) - Fint(umin)) * K).astype(F)
                # Degenerate-column guard, WIDER than the reference's 1e-6
                # fudge (PietRender.metal:517-519, acknowledged "might be
                # inadequate"): near-vertical edges would make the
                # reference's quadratic a ratio of two ~1e-6 cancellations.
                # For x-spans below 1e-4 substitute the analytic
                # vertical-edge limit (1 - clamp(u0)) * (w0 - w1); its
                # error is < 5e-5 coverage (invisible at 8 bits).
                u0 = np.where(w0 <= w1, ua, ub)
                deg = ((F(1.0) - _saturate(u0)) * (w0 - w1)).astype(F)
                delta = np.where(umax - umin > F(1e-4), delta, deg)
            area = np.where(mask, area + delta, area)
        elif tag == CMD_FILL_EDGE:
            sgn, ye = F(av[0]), F(av[1])
            area = area + (sgn * _saturate(Y - ye + F(1.0))).astype(F)
        elif tag == CMD_WIND:
            # Winding carry (multi-subpath fill extension): a non-final
            # subpath's interior backdrop, resolved by the group's final
            # DrawFill.
            area = area + F(av[0])
        elif tag == CMD_DRAW_FILL:
            backdrop = F(av[0])
            fg = av[1:5].astype(F)
            x = area + backdrop
            if av[5] != 0:
                # even-odd fill rule (piet FillRule::EvenOdd; the reference
                # carries only this comment formula, PietRender.metal:543).
                # 2*round(x/2) is exact in f32, so this is FMA-immune.
                alpha = np.abs(x - F(2.0) * np.round(F(0.5) * x))
            else:
                alpha = np.minimum(np.abs(x), F(1.0))  # nonzero winding
            alpha = alpha * _clip_cov(av, X, Y) * cov_stack[-1]
            w = (fg[3] * alpha)[..., None]
            rgb = rgb + (fg[None, None, :3] - rgb) * w
            area = np.zeros_like(area)
        elif tag == CMD_SOLID:
            fg = av[:4].astype(F)
            w = (fg[3] * (_clip_cov(av, X, Y) * cov_stack[-1]))[..., None]
            rgb = rgb + (fg[None, None, :3] - rgb) * w
        elif tag in (CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD):
            # Gradient fill resolve (2-stop brush extension): like
            # DrawFill with the color lerped per pixel in LINEAR space.
            # Op order mirrors ops/cmd_math.py::make_grad_commands
            # exactly (each multiply/add rounded separately).
            backdrop = F(av[0])
            if tag == CMD_DRAW_RAD_GRAD:
                dx = X - F(av[1])
                dy = Y - F(av[2])
                t = _saturate(np.sqrt(dx * dx + dy * dy, dtype=F) * F(av[3]))
            else:
                t = _saturate(F(av[1]) * X + F(av[2]) * Y + F(av[3]))
            fr = F(av[4]) + (F(av[8]) - F(av[4])) * t
            fg = F(av[5]) + (F(av[9]) - F(av[5])) * t
            fb = F(av[6]) + (F(av[10]) - F(av[6])) * t
            fa = F(av[7]) + (F(av[11]) - F(av[7])) * t
            x = area + backdrop
            alpha = np.minimum(np.abs(x), F(1.0)) * cov_stack[-1]
            w = (fa * alpha)[..., None]
            fgp = np.stack([fr, fg, fb], axis=-1)
            rgb = rgb + (fgp - rgb) * w
            area = np.zeros_like(area)
        elif tag == CMD_BEGIN_CLIP:
            backdrop = F(av[0])
            x = area + backdrop
            if av[1] != 0:
                c_alpha = np.abs(x - F(2.0) * np.round(F(0.5) * x))
            else:
                c_alpha = np.minimum(np.abs(x), F(1.0))
            cov_stack.append(cov_stack[-1] * c_alpha)
            area = np.zeros_like(area)
        elif tag == CMD_END_CLIP:
            if len(cov_stack) > 1:
                cov_stack.pop()
        elif tag == CMD_BEGIN_LAYER:
            layer_stack.append(rgb.copy())
        elif tag == CMD_END_LAYER:
            alpha_g = F(av[0])
            saved = layer_stack.pop() if layer_stack else np.ones_like(rgb)
            rgb = saved + (rgb - saved) * alpha_g
        else:
            raise ValueError(f"unknown ptcl tag {tag}")
    return rgb


def finish_pixels(rgb_linear: np.ndarray) -> np.ndarray:
    """Linear f32 -> sRGB-encoded RGBA8 (alpha 255).

    Same curve as the reference's in-shader encode (PietRender.metal:563)
    but via the deterministic algorithm (scene/color.py::linear_to_srgb_det)
    so numpy / Pallas / C++ agree bit-for-bit."""
    out = np.empty(rgb_linear.shape[:-1] + (4,), np.uint8)
    out[..., :3] = srgb_encode_u8(rgb_linear)
    out[..., 3] = 255
    return out


def solid_pixels(solid: int, th: int, tw: int) -> np.ndarray:
    """Bail fast path: the raw sRGB color bytes, as the present pass does
    (PietRender.metal:34-44 -- no decode/encode roundtrip)."""
    r = (solid >> 24) & 0xFF
    g = (solid >> 16) & 0xFF
    b = (solid >> 8) & 0xFF
    a = solid & 0xFF
    return np.broadcast_to(
        np.array([r, g, b, a], np.uint8), (th, tw, 4)).copy()


def cpu_render_ptcl(ptcl: Ptcl, config: RenderConfig) -> np.ndarray:
    """Render all tiles; returns (height, width, 4) uint8 RGBA."""
    th, tw = config.tile_height, config.tile_width
    img = np.zeros((config.padded_height, config.padded_width, 4), np.uint8)
    for ty in range(config.tiles_y):
        for tx in range(config.tiles_x):
            t = ty * config.tiles_x + tx
            ys, xs = ty * th, tx * tw
            if ptcl.solid[t]:
                img[ys:ys + th, xs:xs + tw] = solid_pixels(
                    int(ptcl.solid[t]), th, tw)
            else:
                rgb = render_tile(ptcl.tags[t], ptcl.args[t],
                                  int(ptcl.counts[t]), xs, ys, th, tw)
                img[ys:ys + th, xs:xs + tw] = finish_pixels(rgb)
    return img[:config.height, :config.width]


def cpu_render_scene(scene, config: RenderConfig) -> np.ndarray:
    """Full golden path: CPU tiler + CPU fine rasterizer."""
    from .cpu_tiler import cpu_tile_scene
    return cpu_render_ptcl(cpu_tile_scene(scene, config), config)
