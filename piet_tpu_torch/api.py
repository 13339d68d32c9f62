"""piet-style RenderContext: the drawing API the reference prototypes.

piet-metal exists to back the piet 2D API (README.md:3 "experiments for
piet"); its Rust scene builders hand kurbo shapes to an encoder
(src/lib.rs:256-328).  This module offers that API shape for piet-tpu:
an immediate-mode context with a save/restore state stack (transform +
clip), shape-based fill/stroke/clip, and solid or gradient brushes --
compiling down to a piet-tpu Scene.

    ctx = RenderContext()
    ctx.transform(Affine.scale(2.0))
    ctx.fill(Rect(10, 10, 200, 120), 0x2040C0FF)
    with ctx.clipped(CirclePath((100, 100), 80)):
        ctx.fill(Rect(0, 0, 500, 500), LinearGradient(...))
    scene = ctx.finish()
    image = Renderer.for_scene(scene, w, h).render(scene)

Geometry is flattened at ``tolerance`` in DEVICE space (after the
current transform), matching the reference's flatten-then-encode
pipeline (src/lib.rs:312-314 applies the affine to the BezPath before
flatten).  Brushes are specified in user space and transformed with the
shape; stroke widths scale by sqrt(|det|).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import TOLERANCE
from .geometry import Affine, BezPath, flatten_path
from .scene.scene import (LinearGradient, RadialGradient, Scene,
                          SceneBuilder)

Brush = Union[int, LinearGradient, RadialGradient]


def _as_path(shape) -> BezPath:
    if isinstance(shape, BezPath):
        return shape
    to_path = getattr(shape, "to_path", None)
    if to_path is not None:
        return to_path()
    if isinstance(shape, (list, tuple)) and shape and \
            isinstance(shape[0], (list, tuple)):
        p = BezPath()
        p.move_to(tuple(shape[0]))
        for pt in shape[1:]:
            p.line_to(tuple(pt))
        p.close_path()
        return p
    raise TypeError(f"not a shape: {type(shape).__name__} "
                    "(want BezPath, .to_path(), or a point list)")


class _ClipToken:
    """Context manager returned by ``clipped``: exits via restore()."""

    def __init__(self, ctx: "RenderContext"):
        self._ctx = ctx

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._ctx.restore()
        return False


class RenderContext:
    """Immediate-mode piet-style drawing context (see module doc)."""

    def __init__(self, tolerance: float = TOLERANCE):
        self._b = SceneBuilder()
        self._tol = float(tolerance)
        self._xform = Affine.identity()
        # Save stack: (transform, #open clip groups at save time).
        self._saves: List[Tuple[Affine, int]] = []
        self._open_clips = 0

    # -- state ----------------------------------------------------------
    def save(self) -> None:
        """Push the current transform + clip state (piet save)."""
        self._saves.append((self._xform, self._open_clips))

    def restore(self) -> None:
        """Pop to the last save: restores the transform and closes any
        clips opened since (piet restore semantics)."""
        if not self._saves:
            raise ValueError("restore() without save()")
        self._xform, depth = self._saves.pop()
        while self._open_clips > depth:
            self._b.pop()
            self._open_clips -= 1

    def transform(self, affine: Affine) -> None:
        """Concatenate ``affine`` onto the current transform."""
        self._xform = self._xform * affine

    # -- brushes --------------------------------------------------------
    def _device_brush(self, brush: Brush) -> Brush:
        """Transform a user-space brush into device space."""
        if isinstance(brush, LinearGradient):
            return LinearGradient(self._xform.apply(brush.p0),
                                  self._xform.apply(brush.p1),
                                  brush.rgba0, brush.rgba1)
        if isinstance(brush, RadialGradient):
            a, b, c, d = self._xform.coeffs[:4]
            s = math.sqrt(abs(a * d - b * c))
            return RadialGradient(self._xform.apply(brush.center),
                                  brush.radius * s,
                                  brush.rgba0, brush.rgba1)
        return brush

    def _flat(self, shape):
        path = _as_path(shape).transform(self._xform)
        return [sp for sp in flatten_path(path, self._tol) if len(sp) >= 2]

    # -- drawing --------------------------------------------------------
    def fill(self, shape, brush: Brush, even_odd: bool = False) -> None:
        """Fill a shape (multi-subpath paths share one winding number, so
        holes render correctly -- the combined-fill extension)."""
        flat = self._flat(shape)
        if flat:
            self._b.fill_path(flat, self._device_brush(brush),
                              even_odd=even_odd, combined=True)

    def stroke(self, shape, brush: Brush, width: float) -> None:
        """Stroke a shape's flattened outline (round caps/joins via the
        reference's min-distance-field semantics).  Gradient strokes are
        not supported (the reference's stroke command carries one
        color)."""
        if isinstance(brush, (LinearGradient, RadialGradient)):
            raise ValueError("gradient strokes unsupported (solid only)")
        a, b, c, d = self._xform.coeffs[:4]
        w = float(np.float32(width) * np.float32(
            math.sqrt(abs(a * d - b * c))))
        flat = self._flat(shape)
        if flat:
            self._b.stroke_path(flat, w, brush)

    def clip(self, shape, even_odd: bool = False) -> None:
        """Intersect the current clip with a shape; undone by the
        matching restore() (piet clip semantics)."""
        flat = self._flat(shape)
        # piet clips until restore even for empty shapes: clip to nothing.
        sub = flat[0] if flat else [(0.0, 0.0), (0.0, 0.0), (0.0, 0.0)]
        if len(flat) > 1:
            # Multi-subpath clip: coverage of the combined path requires
            # one clip item per subpath only under nonzero winding with
            # consistent orientation; reject rather than misrender.
            raise ValueError(
                "multi-subpath clip paths unsupported; clip with the "
                "outer subpath and fill holes separately")
        self._b.clip_path(sub, even_odd=even_odd)
        self._open_clips += 1

    def clipped(self, shape, even_odd: bool = False) -> _ClipToken:
        """``with ctx.clipped(shape): ...`` -- save, clip, auto-restore."""
        self.save()
        self.clip(shape, even_odd=even_odd)
        return _ClipToken(self)

    def push_layer(self, alpha: float) -> None:
        """Group-opacity layer (extension); close with pop_layer()."""
        self._b.push_layer(alpha)

    def pop_layer(self) -> None:
        self._b.pop()

    def clear(self, brush: int) -> None:
        """Paint everything rendered so far over with a solid color
        (piet clear): an unbounded unclipped rect fill, which also
        re-arms the renderer's solid-tile bail fast path."""
        while self._open_clips:
            self._b.pop()
            self._open_clips -= 1
        big = 1e6
        self._b.fill([(-big, -big), (big, -big), (big, big), (-big, big)],
                     int(brush))

    # -- output ---------------------------------------------------------
    def finish(self) -> Scene:
        """Validate balance and build the Scene."""
        if self._saves:
            raise ValueError(f"{len(self._saves)} unmatched save()")
        while self._open_clips:
            self._b.pop()
            self._open_clips -= 1
        return self._b.build()
