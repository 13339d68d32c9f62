"""Per-pixel command math and exact division/sqrt, in PyTorch.

Port of ``piet_tpu/ops/cmd_math.py``.  The CUDA kernels carry the same
expressions in ``csrc/cmd_math.cuh``; the plain PyTorch versions of the
kernels (and so the CPU path) use these.  Operation order follows the
JAX module and the numpy oracle (``piet_tpu/raster/cpu_fine.py``) op for
op.  PyTorch runs eagerly, one rounded operation per call, so no
contraction barrier is needed: every multiply and add rounds on its own.

Two semantic traps of PyTorch against ``jax.numpy`` are handled here:

* ``torch.sign`` maps -0.0 to +0.0 and NaN to 0; ``jnp.sign`` keeps
  both.  :func:`sign` keeps them, because ``sign`` of a sum is written
  into the FillEdge word and compared word for word.
* python float constants are rounded to float32 first (``_f``), so a
  scalar operand is the same number whether an op computes in float32
  or float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.color import SRGB_PE, SRGB_PL


def _f(v) -> float:
    """A python float holding exactly the float32 rounding of ``v``."""
    return float(np.float32(v))


DF_INIT = _f(1e9)
#: Initial SQUARED distance field: its sqrt exceeds every stroke threshold
#: (see line_field_sq), so it resolves to alpha 0 exactly like DF_INIT.
DF2_INIT = _f(1e18)

_INF = float("inf")
_SPLIT = _f(4097.0)          # Dekker split constant (12 + 12 bits)
_SRGB_PL = [_f(c) for c in SRGB_PL]
_SRGB_PE = [_f(c) for c in SRGB_PE]


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +-1, and x itself for +-0 and NaN."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def saturate(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0.0, 1.0)


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _from_bits(u: torch.Tensor) -> torch.Tensor:
    return u.contiguous().view(torch.float32)


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt by exact-residual candidate selection.

    Takes the hardware estimate, steps +-2 ulp and keeps the candidate
    minimizing |s^2 - x| with the residual computed from exact
    Dekker-split products.  The choice does not depend on the estimate,
    so every backend lands on numpy's ``np.sqrt``."""
    s0 = torch.sqrt(x)
    ub = _bits(s0)
    best_s = s0
    best_a = torch.full_like(s0, _INF)
    for delta in (-2, -1, 0, 1, 2):
        s = _from_bits(ub + delta)
        c = s * _SPLIT
        hi = c - (c - s)
        lo = s - hi
        d = ((hi * hi) - x) + (2.0 * (hi * lo)) + (lo * lo)
        a = torch.abs(d)
        take = a < best_a
        best_s = torch.where(take, s, best_s)
        best_a = torch.where(take, a, best_a)
    return torch.where(x > 0.0, best_s, s0)


def div_det(a, b) -> torch.Tensor:
    """Deterministic f32 division, bitwise equal on every backend.

    The quotient's +-3 representation neighbours are ranked by the exact
    residual |a - q*b| (Dekker-split products); exact ties go to the even
    mantissa.  Non-finite and zero-divisor cases keep the raw quotient."""
    if not isinstance(a, torch.Tensor):
        a = _as_tensor(a, b)
    if not isinstance(b, torch.Tensor):
        b = _as_tensor(b, a)
    q0 = a / b
    cb = b * _SPLIT
    bh = cb - (cb - b)
    bl = b - bh
    u0 = _bits(q0)
    best_q = q0
    best_r = torch.full_like(q0, _INF)
    best_ev = torch.zeros_like(q0)
    for delta in (-3, -2, -1, 0, 1, 2, 3):
        uq = u0 + delta
        q = _from_bits(uq)
        cq = q * _SPLIT
        qh = cq - (cq - q)
        ql = q - qh
        r = torch.abs((((a - qh * bh) - qh * bl) - ql * bh) - ql * bl)
        ev = 1.0 - (uq & 1).to(torch.float32)
        take = (r < best_r) | ((r == best_r) & (ev > best_ev))
        best_q = torch.where(take, q, best_q)
        best_ev = torch.where(take, ev, best_ev)
        best_r = torch.where(take, r, best_r)
    ok = (b != 0.0) & (torch.abs(q0) < _INF) & (q0 == q0)
    return torch.where(ok, best_q, q0)


def dot2_det(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x*x + y*y from exact split squares (contraction-immune)."""
    def sq(v):
        c = v * _SPLIT
        h = c - (c - v)
        l = v - h
        return h * h, 2.0 * (h * l), l * l

    xh, xm, xl = sq(x)
    yh, ym, yl = sq(y)
    return ((xh + xm) + xl) + ((yh + ym) + yl)


def line_field_sq(arg, X, Y) -> torch.Tensor:
    """SQUARED distance field of CmdLine; operand words
    [sx, sy, ex, ey, hw, inv_denom] (inv_denom = +inf: a dot)."""
    sx, sy, ex, ey = arg(0), arg(1), arg(2), arg(3)
    inv_denom = arg(5)
    lvx, lvy = ex - sx, ey - sy
    dpx, dpy = X - sx, Y - sy
    dotp = (lvx * dpx) + (lvy * dpy)
    tpar = torch.where(inv_denom < _INF, saturate(dotp * inv_denom), 0.0)
    fx = (lvx * tpar) - dpx
    fy = (lvy * tpar) - dpy
    return (fx * fx) + (fy * fy)


def line_field(arg, X, Y) -> torch.Tensor:
    return ieee_sqrt(line_field_sq(arg, X, Y))


def fill_delta(arg, X, Y):
    """Division-free signed-area delta of CmdFill; operand words
    [sx, sy, ey, m, K].  Returns (mask, delta)."""
    sx, sy, ey, m, K = arg(0), arg(1), arg(2), arg(3), arg(4)
    rsy = sy - Y
    rey = ey - Y
    w0 = saturate(rsy)
    w1 = saturate(rey)
    mask = w0 != w1
    wa = torch.minimum(w0, w1)
    wb = torch.maximum(w0, w1)
    rx = sx - X
    ua = rx + (m * (wa - rsy))
    ub = rx + (m * (wb - rsy))
    umin = torch.minimum(ua, ub)
    umax = torch.maximum(ua, ub)

    def F(u):
        c = saturate(u)
        return torch.clamp(u, max=1.0) - (0.5 * (c * c))

    delta = (F(umax) - F(umin)) * K
    u0 = torch.where(w0 <= w1, ua, ub)
    deg = (1.0 - saturate(u0)) * (w0 - w1)
    return mask, torch.where(umax - umin > _f(1e-4), delta, deg)


def edge_delta(arg, Y) -> torch.Tensor:
    """Winding delta of CmdFillEdge; operand words [sign, y]."""
    sgn, ye = arg(0), arg(1)
    return sgn * saturate(Y - ye + 1.0)


def clip_alpha(x, even_odd) -> torch.Tensor:
    """Winding -> coverage: nonzero min(|x|, 1), even-odd
    |x - 2 round(x/2)| (round half to even, as jnp.round)."""
    eo = torch.abs(x - 2.0 * torch.round(0.5 * x))
    nz = torch.clamp(torch.abs(x), max=1.0)
    return torch.where(even_odd != 0.0, eo, nz)


def make_commands(X, Y, cov=None):
    """The 7 command evaluators over pixel grids X, Y, in reference tag
    order (Circle=2 .. Solid=8).  Each takes ``(arg, r, g, b, df, area)``,
    ``arg(k)`` giving operand word k (broadcastable against X), and returns
    the updated ``(r, g, b, df, area)``.  ``cov``: optional thunk giving the
    clip-stack coverage plane that multiplies every draw's alpha."""
    def apply_cov(arg, alpha):
        alpha = alpha * clip_cov(arg)
        if cov is not None:
            alpha = alpha * cov()
        return alpha

    def clip_cov(arg):
        cx0, cy0, cx1, cy1 = arg(8), arg(9), arg(10), arg(11)
        covx = saturate(torch.minimum(cx1, X + 1.0) - torch.maximum(cx0, X))
        covy = saturate(torch.minimum(cy1, Y + 1.0) - torch.maximum(cy0, Y))
        return covx * covy

    def cmd_circle(arg, r, g, b, df, area):
        bx0, by0, bx1, by1 = arg(0), arg(1), arg(2), arg(3)
        cx = bx0 + 0.5 * (bx1 - bx0)
        cy = by0 + 0.5 * (by1 - by0)
        dx = X - cx
        dy = Y - cy
        rad = ieee_sqrt((dx * dx) + (dy * dy))
        circle_r = torch.minimum(cx - bx0, cy - by0)
        alpha = apply_cov(arg, saturate(circle_r - rad))
        keep = 1.0 - alpha
        return r * keep, g * keep, b * keep, df, area

    def cmd_line(arg, r, g, b, df, area):
        return r, g, b, torch.minimum(df, line_field(arg, X, Y)), area

    def _blend(r, g, b, fr, fg, fb, w):
        return r + (fr - r) * w, g + (fg - g) * w, b + (fb - b) * w

    def cmd_stroke(arg, r, g, b, df, area):
        half_width = arg(0)
        fr, fg, fb, fa = arg(1), arg(2), arg(3), arg(4)
        alpha = apply_cov(arg, saturate(half_width + 0.5 - df))
        w = fa * alpha
        r, g, b = _blend(r, g, b, fr, fg, fb, w)
        return r, g, b, torch.full_like(df, DF_INIT), area

    def cmd_fill(arg, r, g, b, df, area):
        mask, delta = fill_delta(arg, X, Y)
        return r, g, b, df, torch.where(mask, area + delta, area)

    def cmd_fill_edge(arg, r, g, b, df, area):
        return r, g, b, df, area + edge_delta(arg, Y)

    def cmd_draw_fill(arg, r, g, b, df, area):
        backdrop = arg(0)
        fr, fg, fb, fa = arg(1), arg(2), arg(3), arg(4)
        x = area + backdrop
        alpha = apply_cov(arg, clip_alpha(x, arg(5)))
        w = fa * alpha
        r, g, b = _blend(r, g, b, fr, fg, fb, w)
        return r, g, b, df, torch.zeros_like(area)

    def cmd_solid(arg, r, g, b, df, area):
        fr, fg, fb, fa = arg(0), arg(1), arg(2), arg(3)
        one = torch.ones_like(r)
        r, g, b = _blend(r, g, b, fr, fg, fb, fa * apply_cov(arg, one))
        return r, g, b, df, area

    return (cmd_circle, cmd_line, cmd_fill, cmd_stroke, cmd_fill_edge,
            cmd_draw_fill, cmd_solid)


def make_grad_commands(X, Y, cov=None):
    """Linear and radial gradient resolves (2-stop brush); operand words
    [backdrop, g0, g1, g2, c0r, c0g, c0b, c0a, c1r, c1g, c1b, c1a]."""
    def _grad(radial):
        def cmd(arg, r, g, b, df, area):
            if radial:
                dx = X - arg(1)
                dy = Y - arg(2)
                t = saturate(ieee_sqrt((dx * dx) + (dy * dy)) * arg(3))
            else:
                t = saturate((arg(1) * X) + (arg(2) * Y) + arg(3))
            fr = arg(4) + (arg(8) - arg(4)) * t
            fg = arg(5) + (arg(9) - arg(5)) * t
            fb = arg(6) + (arg(10) - arg(6)) * t
            fa = arg(7) + (arg(11) - arg(7)) * t
            x = area + arg(0)
            alpha = torch.clamp(torch.abs(x), max=1.0)
            if cov is not None:
                alpha = alpha * cov()
            w = fa * alpha
            r = r + (fr - r) * w
            g = g + (fg - g) * w
            b = b + (fb - b) * w
            return r, g, b, df, torch.zeros_like(area)
        return cmd

    return _grad(False), _grad(True)


def srgb_encode_u32(ch: torch.Tensor) -> torch.Tensor:
    """Deterministic linear f32 -> u8 code (int32): the mul/add/floor/
    bitcast polynomial chain of scene/color.py::linear_to_srgb_det."""
    ch = torch.clamp(ch, 0.0, 1.0)
    lo = ch * _f(12.92)
    u = _bits(ch)
    e = (((u >> 23) & 0x1FF) - 127).to(torch.float32)
    m = _from_bits((u & 0x007FFFFF) | 0x3F800000)
    acc = torch.full_like(m, _SRGB_PL[0])
    for c in _SRGB_PL[1:]:
        acc = (acc * m) + c
    t = (e + acc) * _f(1.0 / 2.4)
    k = torch.floor(t)
    fr = t - k
    s = _from_bits((k.to(torch.int32) + 127) << 23)
    pe = torch.full_like(fr, _SRGB_PE[0])
    for c in _SRGB_PE[1:]:
        pe = (pe * fr) + c
    hi = (_f(1.055) * (s * pe)) - _f(0.055)
    srgb = torch.where(ch < _f(0.0031308), lo, hi)
    return torch.round(srgb * 255.0).to(torch.int32)


def pack_rgba8(r, g, b) -> torch.Tensor:
    """Encode three linear planes and pack RGBA8 into u32 bits held in
    int32 (R in the low byte, alpha 0xFF)."""
    return (srgb_encode_u32(r) | (srgb_encode_u32(g) << 8)
            | (srgb_encode_u32(b) << 16) | -16777216)   # 0xFF000000
