"""Bezier evaluation and path flattening.

Reimplements the semantics of the reference's flattener
(reference: src/flatten.rs:10-47) including its kurbo-0.5.6 ``to_quads``
subdivision rule.  Key behavioral facts preserved:

* ``MoveTo`` starts a new subpath; ``LineTo`` appends (flatten.rs:16-26).
* ``CurveTo`` is split into ``n`` quadratics at *uniform* parameter steps and
  only each quad's **endpoint** is kept (flatten.rs:27-39) -- so the emitted
  points are exactly the cubic evaluated at t = i/n, i = 1..n.
* The quad count follows kurbo's rule: with accuracy ``a``,
  ``err = |(3*p2 - p3) - (3*p1 - p0)|^2`` and
  ``n = max(1, ceil((err / (432 a^2))^(1/6)))``
  (the 432 = (36/sqrt(3))^2 magic constant from the cubic->quad error bound).
  The reference calls this with ``accuracy = tolerance * 1e-2``
  (flatten.rs:35, the self-described "really hacky" 100x tightening).
* ``QuadTo``/other elements are dropped; ``ClosePath`` is ignored (closure is
  implicit -- the GPU fill wraps last->first, PietRender.metal:262).

This pure-geometry pass is host-side (numpy/f64, like kurbo); a vectorized
variant `flatten_cubics_batch` flattens many cubics at once for large scenes.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .path import BezPath, ClosePath, CurveTo, LineTo, MoveTo, Point, QuadTo


def cubic_eval(p0: Point, p1: Point, p2: Point, p3: Point, t: float) -> Point:
    """De Casteljau-free polynomial evaluation of a cubic Bezier at t."""
    mt = 1.0 - t
    a = mt * mt * mt
    b = 3.0 * mt * mt * t
    c = 3.0 * mt * t * t
    d = t * t * t
    return (
        a * p0[0] + b * p1[0] + c * p2[0] + d * p3[0],
        a * p0[1] + b * p1[1] + c * p2[1] + d * p3[1],
    )


def quad_count(p0: Point, p1: Point, p2: Point, p3: Point,
               accuracy: float) -> int:
    """Number of uniform subdivisions kurbo's ``to_quads`` would use."""
    max_hypot2 = 432.0 * accuracy * accuracy
    p1x2 = (3.0 * p1[0] - p0[0], 3.0 * p1[1] - p0[1])
    p2x2 = (3.0 * p2[0] - p3[0], 3.0 * p2[1] - p3[1])
    dx = p2x2[0] - p1x2[0]
    dy = p2x2[1] - p1x2[1]
    err = dx * dx + dy * dy
    n = int(math.ceil((err / max_hypot2) ** (1.0 / 6.0))) if err > 0 else 1
    return max(n, 1)


def flatten_cubic(p0: Point, p1: Point, p2: Point, p3: Point,
                  accuracy: float) -> List[Point]:
    """Endpoints of the quads ``to_quads`` would emit: the cubic at t=i/n."""
    n = quad_count(p0, p1, p2, p3, accuracy)
    return [cubic_eval(p0, p1, p2, p3, (i + 1) / n) for i in range(n)]


def flatten_path(path: BezPath, tolerance: float) -> List[List[Point]]:
    """Flatten a path to one point-polyline per subpath.

    Matches reference src/flatten.rs:10-47 exactly: cubics use accuracy
    ``tolerance * 1e-2``; quads and other elements are silently dropped;
    subpaths are not explicitly closed.
    """
    result: List[List[Point]] = []
    cur: List[Point] = None  # type: ignore[assignment]
    last_pt: Point = (0.0, 0.0)
    for el in path:
        if isinstance(el, MoveTo):
            if cur is not None:
                result.append(cur)
            cur = [el.p]
            last_pt = el.p
        elif isinstance(el, LineTo):
            cur.append(el.p)
            last_pt = el.p
        elif isinstance(el, CurveTo):
            cur.extend(flatten_cubic(last_pt, el.p1, el.p2, el.p3,
                                     tolerance * 1e-2))
            last_pt = el.p3
        # QuadTo / ClosePath intentionally ignored (flatten.rs:40).
    if cur is not None:
        result.append(cur)
    return result


# ---------------------------------------------------------------------------
# Vectorized batch flattening (TPU-first addition, not in the reference):
# flattening O(10k) curves one Python loop at a time is the kind of host
# bottleneck the reference tolerated (it re-encoded only on resize,
# PietRenderer.m:105-146); our animated-scene configs re-flatten per frame.
# ---------------------------------------------------------------------------

def flatten_cubics_batch(cubics: np.ndarray, accuracy: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten many cubics at once.

    Args:
      cubics: (N, 4, 2) float64 control points.
      accuracy: subdivision accuracy (same rule as `quad_count`).

    Returns:
      (points, counts): ``points`` is (M, 2) float64 -- the concatenated
      per-cubic chord endpoints (t = 1/n .. n/n); ``counts`` is (N,) int32
      giving how many points each cubic contributed.  Identical values to
      looping `flatten_cubic`.
    """
    cubics = np.asarray(cubics, dtype=np.float64)
    if cubics.size == 0:
        return np.zeros((0, 2)), np.zeros((0,), np.int32)
    p0, p1, p2, p3 = (cubics[:, i, :] for i in range(4))
    d = (3.0 * p2 - p3) - (3.0 * p1 - p0)
    err = np.einsum("ij,ij->i", d, d)
    max_hypot2 = 432.0 * accuracy * accuracy
    n = np.maximum(np.ceil((err / max_hypot2) ** (1.0 / 6.0)), 1.0)
    n = np.where(err > 0, n, 1.0).astype(np.int64)

    total = int(n.sum())
    # Ragged t-values: for cubic i, t = (1..n_i)/n_i.
    seg_of = np.repeat(np.arange(len(n)), n)
    offsets = np.concatenate([[0], np.cumsum(n)[:-1]])
    local = np.arange(total) - offsets[seg_of]
    t = (local + 1.0) / n[seg_of]

    mt = 1.0 - t
    a = (mt * mt * mt)[:, None]
    b = (3.0 * mt * mt * t)[:, None]
    c = (3.0 * mt * t * t)[:, None]
    dd = (t * t * t)[:, None]
    pts = a * p0[seg_of] + b * p1[seg_of] + c * p2[seg_of] + dd * p3[seg_of]
    return pts, n.astype(np.int32)
