"""Struct-of-arrays scene representation and builder.

This is the TPU-native replacement for the reference's flat byte buffer +
bump-allocating ``Encoder`` (reference: src/lib.rs:79-254).  Same item
semantics and the same public surface (begin_group / circle / stroke_line /
fill / polyline / end_group), but the storage is typed packed arrays directly
consumable by XLA gathers instead of a byte-addressed heterogeneous heap.

Item model (tags match reference src/lib.rs:70-77 / GenTypes.h:325-328):
  1 = Circle           : bbox only (color is not encoded; circles render
                         black -- a documented reference quirk,
                         PietRender.metal:488-492)
  2 = Line             : one stroked segment; width, color; 2 points
  3 = Fill             : closed polygon (implicit wrap last->first); color
  4 = StrokePolyLine   : open polyline stroke; width, color

Bounding boxes are quantized exactly like ``ShortBbox::from_rect``
(src/lib.rs:88-97): floor(min)/ceil(max), clamped to [0, 65535].
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

TAG_CIRCLE = 1
TAG_LINE = 2
TAG_FILL = 3
TAG_POLY = 4
# -- extension items (beyond the reference's four; vello-direction clip /
# layer groups).  TAG_CLIP pushes an arbitrary-path clip (points like
# TAG_FILL); TAG_LAYER pushes a group-opacity layer (alpha in ``widths``);
# TAG_POP ends the innermost push (FLAG_POP_LAYER says which kind).
TAG_CLIP = 5
TAG_POP = 6
TAG_LAYER = 7

#: Maximum clip/layer nesting depth (sizes the fine kernels' plane stacks).
MAX_GROUP_DEPTH = 4

from ..config import THIN_LINE


#: Scene item flag bits (extensions beyond the reference wire format).
FLAG_EVEN_ODD = 1
#: Item lies inside an open clip/layer group: disables the opaque-solid
#: tile bail (the group may cut or fade it).
FLAG_IN_GROUP = 2
#: On TAG_POP: the innermost push is a layer (else a clip).
FLAG_POP_LAYER = 4
#: Fill brush kind (gradient extension): linear / radial 2-stop gradient.
#: Zero brush bits = solid color (the reference's only brush).
FLAG_BRUSH_LINEAR = 8
FLAG_BRUSH_RADIAL = 16
#: Multi-subpath fill (hole extension; see SceneBuilder.fill_path
#: combined=True): CONT = non-final subpath, winding carried by CMD_WIND
#: and never resolved; FINAL = resolves the whole group unconditionally
#: over the union bbox.
FLAG_FILL_CONT = 32
FLAG_FILL_FINAL = 64


@dataclasses.dataclass(frozen=True)
class LinearGradient:
    """2-stop linear gradient brush (piet Brush extension; the reference
    encodes only solid colors, src/lib.rs:177-207).

    Color at pixel p is lerp(rgba0, rgba1, t) in LINEAR space with
    t = clamp(dot(p - p0, p1 - p0) / |p1 - p0|^2, 0, 1); a degenerate axis
    (p0 == p1) paints rgba0 everywhere."""
    p0: Tuple[float, float]
    p1: Tuple[float, float]
    rgba0: int
    rgba1: int

    def params3(self) -> Tuple[float, float, float]:
        """Host-precomputed affine form (gx, gy, g0): t = gx*x + gy*y + g0.

        Computed ONCE here in f32 (each op rounded) and consumed verbatim
        by both the CPU oracle and the device kernels, so there is no
        cross-implementation precision concern."""
        x0, y0 = np.float32(self.p0[0]), np.float32(self.p0[1])
        x1, y1 = np.float32(self.p1[0]), np.float32(self.p1[1])
        dx, dy = np.float32(x1 - x0), np.float32(y1 - y0)
        d2 = np.float32(np.float32(dx * dx) + np.float32(dy * dy))
        if d2 <= 0.0:
            return (0.0, 0.0, 0.0)
        gx = np.float32(dx / d2)
        gy = np.float32(dy / d2)
        g0 = np.float32(-(np.float32(gx * x0) + np.float32(gy * y0)))
        return (float(gx), float(gy), float(g0))


@dataclasses.dataclass(frozen=True)
class RadialGradient:
    """2-stop radial gradient brush: color = lerp(rgba0, rgba1, t) with
    t = clamp(|p - center| / radius, 0, 1); radius <= 0 paints rgba0."""
    center: Tuple[float, float]
    radius: float
    rgba0: int
    rgba1: int

    def params3(self) -> Tuple[float, float, float]:
        """(cx, cy, 1/radius) with the division done once on host (f32)."""
        r = np.float32(self.radius)
        inv_r = float(np.float32(1.0) / r) if r > 0 else 0.0
        return (float(np.float32(self.center[0])),
                float(np.float32(self.center[1])), inv_r)


def quantize_bbox(x0: float, y0: float, x1: float, y1: float
                  ) -> Tuple[int, int, int, int]:
    """u16 bbox quantization, identical to ShortBbox::from_rect."""
    def clamp(v):
        return int(min(max(v, 0.0), 65535.0))
    return (clamp(math.floor(x0)), clamp(math.floor(y0)),
            clamp(math.ceil(x1)), clamp(math.ceil(y1)))


@dataclasses.dataclass
class Scene:
    """Immutable SoA scene: the unit handed to the renderer.

    Shapes: ``tags/colors/widths/pt_offset/n_pts`` are (N,); ``bboxes`` is
    (N, 4) int32 in x0,y0,x1,y1 order; ``points`` is (M, 2) float32.  All
    items (including lines) store their geometry in ``points`` -- the wire
    serializer re-inlines line endpoints for byte parity (scene/wire.py).
    """

    tags: np.ndarray
    colors: np.ndarray      # logical 0xRRGGBBAA, uint32
    widths: np.ndarray      # float32; 0 for fills/circles
    bboxes: np.ndarray      # (N, 4) int32, quantized u16 range
    pt_offset: np.ndarray   # int32 index into points
    n_pts: np.ndarray       # int32
    points: np.ndarray      # (M, 2) float32
    #: per-item flag bits; bit 0 = even-odd fill rule (an extension beyond
    #: the reference, which carries even-odd only as a comment formula,
    #: PietRender.metal:543; piet's FillRule has both).  Not part of the
    #: reference wire format (scene/wire.py serializes without it).
    flags: np.ndarray = None  # (N,) uint32
    #: per-item axis-aligned clip rectangle (x0, y0, x1, y1) f32 -- the
    #: piet clip extension; NO_CLIP bounds mean unclipped.  Like flags,
    #: not part of the reference wire format.
    clips: np.ndarray = None  # (N, 4) float32
    #: per-item gradient-brush payload (gradient extension; all-zero for
    #: solid brushes): words 0-2 = host-precomputed geometry params
    #: (LinearGradient/RadialGradient.params3), words 3-6 = the second
    #: stop's LINEAR rgba (first stop rides ``colors``), word 7 = pad.
    grads: np.ndarray = None  # (N, 8) float32

    @property
    def n_items(self) -> int:
        return int(self.tags.shape[0])

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    def save(self, path: str) -> None:
        """Persist as .npz -- scene checkpointing for benchmark
        reproducibility (the reference re-encodes from SVG at every
        resize and has no persistence, PietRenderer.m:105-146)."""
        np.savez_compressed(
            path, tags=self.tags, colors=self.colors, widths=self.widths,
            bboxes=self.bboxes, pt_offset=self.pt_offset, n_pts=self.n_pts,
            points=self.points, flags=self.flags, clips=self.clips,
            grads=self.grads)

    @classmethod
    def load(cls, path: str) -> "Scene":
        z = np.load(path)
        scene = cls(tags=z["tags"], colors=z["colors"], widths=z["widths"],
                    bboxes=z["bboxes"], pt_offset=z["pt_offset"],
                    n_pts=z["n_pts"], points=z["points"],
                    flags=z["flags"] if "flags" in z else None,
                    clips=z["clips"] if "clips" in z else None,
                    grads=z["grads"] if "grads" in z else None)
        scene.validate()
        return scene

    def __post_init__(self):
        n = self.tags.shape[0]
        if self.flags is None:
            object.__setattr__(self, "flags", np.zeros(n, np.uint32))
        if self.clips is None:
            from ..raster.ptcl import NO_CLIP
            object.__setattr__(
                self, "clips",
                np.broadcast_to(np.asarray(NO_CLIP, np.float32),
                                (n, 4)).copy())
        if self.grads is None:
            object.__setattr__(self, "grads", np.zeros((n, 8), np.float32))

    def validate(self) -> None:
        n = self.n_items
        assert self.flags.shape == (n,)
        assert self.clips.shape == (n, 4)
        assert self.grads.shape == (n, 8)
        assert self.colors.shape == (n,)
        assert self.widths.shape == (n,)
        assert self.bboxes.shape == (n, 4)
        assert self.pt_offset.shape == (n,)
        assert self.n_pts.shape == (n,)
        assert self.points.ndim == 2 and self.points.shape[1] == 2
        ends = self.pt_offset + self.n_pts
        assert (ends <= self.n_points).all()


class SceneBuilder:
    """Builds a `Scene`; mirrors the reference Encoder API.

    Unlike the reference (which requires the item count up front --
    ``begin_group(n_items)``, src/lib.rs:132-144), the builder accumulates
    dynamically; ``begin_group``/``end_group`` are kept for API parity and
    as an invariant check when a count is declared.
    """

    def __init__(self) -> None:
        self._tags: List[int] = []
        self._colors: List[int] = []
        self._widths: List[float] = []
        self._bboxes: List[Tuple[int, int, int, int]] = []
        self._pt_offset: List[int] = []
        self._n_pts: List[int] = []
        self._points: List[Tuple[float, float]] = []
        self._flags: List[int] = []
        self._clips: List[Tuple[float, float, float, float]] = []
        self._grads: List[Tuple[float, ...]] = []
        self._clip: Tuple[float, float, float, float] = None
        self._declared: int = -1
        self._group_stack: List[Tuple[str, float]] = []  # (kind, alpha)

    # -- group API (parity with src/lib.rs:132-149) ---------------------
    def begin_group(self, n_items: int = -1) -> None:
        self._declared = n_items

    def end_group(self) -> None:
        if self._declared >= 0 and self._declared != len(self._tags):
            raise ValueError(
                f"group declared {self._declared} items, got {len(self._tags)}")
        self._declared = -1

    # -- clip state (piet clip extension; axis-aligned rects) -------------
    def set_clip(self, x0: float, y0: float, x1: float, y1: float) -> None:
        """Clip subsequently-added items to the rectangle (antialiased)."""
        self._clip = (x0, y0, x1, y1)

    def clear_clip(self) -> None:
        self._clip = None

    # -- item encoders ---------------------------------------------------
    def _add_points(self, points: Sequence[Tuple[float, float]]) -> Tuple[int, Tuple[float, float, float, float]]:
        if len(points) == 0:
            raise ValueError("encoded empty points vector")
        off = len(self._points)
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        self._points.extend((float(x), float(y)) for x, y in points)
        return off, (min(xs), min(ys), max(xs), max(ys))

    def _add_item(self, tag: int, color: int, width: float,
                  off: int, n: int, bbox, flags: int = 0,
                  grad: Tuple[float, ...] = None) -> None:
        from ..raster.ptcl import NO_CLIP
        if self._group_stack:
            flags |= FLAG_IN_GROUP
        self._tags.append(tag)
        self._colors.append(color & 0xFFFFFFFF)
        self._widths.append(float(width))
        self._bboxes.append(quantize_bbox(*bbox))
        self._pt_offset.append(off)
        self._n_pts.append(n)
        self._flags.append(flags & 0xFFFFFFFF)
        self._clips.append(tuple(map(float, self._clip))
                           if self._clip is not None else NO_CLIP)
        self._grads.append(grad if grad is not None else (0.0,) * 8)

    def circle(self, cx: float, cy: float, r: float) -> None:
        """Encode a circle (bbox only, like src/lib.rs:167-174)."""
        off, _ = self._add_points([(cx - r, cy - r), (cx + r, cy + r)])
        self._add_item(TAG_CIRCLE, 0, 0.0, off, 2,
                       (cx - r, cy - r, cx + r, cy + r))

    def stroke_line(self, p0, p1, width: float, rgba: int) -> None:
        """Single stroked line; bbox inflated by width/2 (src/lib.rs:177-192)."""
        off, (x0, y0, x1, y1) = self._add_points([p0, p1])
        hw = float(np.float32(width) * np.float32(0.5))
        self._add_item(TAG_LINE, rgba, width, off, 2,
                       (x0 - hw, y0 - hw, x1 + hw, y1 + hw))

    def fill(self, points: Sequence[Tuple[float, float]], brush,
             even_odd: bool = False) -> None:
        """Filled polygon, implicit closure (src/lib.rs:195-207).

        ``brush`` is a solid 0xRRGGBBAA int (the reference's only brush) or
        a LinearGradient / RadialGradient (gradient extension).
        ``even_odd`` selects piet's even-odd fill rule (default nonzero
        winding, as the reference renders)."""
        off, bbox = self._add_points(points)
        if isinstance(brush, (LinearGradient, RadialGradient)):
            if even_odd:
                raise ValueError(
                    "gradient fills use nonzero winding (even_odd "
                    "unsupported: the PTCL word budget is exhausted)")
            if self._clip is not None:
                raise ValueError(
                    "gradient fills cannot carry a rect clip (payload "
                    "rides the clip words); use clip_path() groups")
            from .color import decode_color_linear
            c1 = decode_color_linear(np.uint32(brush.rgba1 & 0xFFFFFFFF))
            grad = tuple(brush.params3()) + tuple(float(v) for v in c1) \
                + (0.0,)
            flag = (FLAG_BRUSH_RADIAL if isinstance(brush, RadialGradient)
                    else FLAG_BRUSH_LINEAR)
            self._add_item(TAG_FILL, brush.rgba0, 0.0, off, len(points),
                           bbox, flags=flag, grad=grad)
        else:
            self._add_item(TAG_FILL, brush, 0.0, off, len(points), bbox,
                           flags=FLAG_EVEN_ODD if even_odd else 0)

    def polyline(self, points: Sequence[Tuple[float, float]], rgba: int,
                 width: float) -> None:
        """Stroked polyline; bbox inflated by width/2 (src/lib.rs:209-222)."""
        off, (x0, y0, x1, y1) = self._add_points(points)
        hw = float(np.float32(width) * np.float32(0.5))
        self._add_item(TAG_POLY, rgba, width, off, len(points),
                       (x0 - hw, y0 - hw, x1 + hw, y1 + hw))

    def stroke_path(self, subpaths: Sequence[Sequence[Tuple[float, float]]],
                    width: float, rgba: int) -> None:
        """Stroke flattened subpaths with the reference's thin-line fudge.

        Widths below THIN_LINE are clamped to THIN_LINE and alpha is scaled
        by sqrt(width/THIN_LINE) -- truncating to int like Rust's ``as u32``
        (src/lib.rs:353-367).
        """
        width = float(np.float32(width))
        if width < THIN_LINE:
            # All-f32 arithmetic and truncating cast, matching the Rust.
            alpha = np.float32(rgba & 0xFF) * np.sqrt(
                np.float32(width) / np.float32(THIN_LINE), dtype=np.float32)
            rgba = (rgba & ~0xFF) | (int(alpha) & 0xFF)
            width = THIN_LINE
        for sp in subpaths:
            self.polyline(sp, rgba, width)

    def fill_path(self, subpaths: Sequence[Sequence[Tuple[float, float]]],
                  brush, even_odd: bool = False,
                  combined: bool = False) -> None:
        """Fill flattened subpaths, one Fill item each (src/lib.rs:342-347).

        ``brush``: solid rgba int or Linear/RadialGradient (see fill).

        ``combined=True`` (extension) accumulates the winding number
        ACROSS subpaths before resolving once -- real hole support under
        both fill rules (an even-odd ring, a reversed-winding nonzero
        hole).  The reference cannot represent this: it encodes one
        independent Fill per subpath (src/lib.rs:342-347), so a "hole"
        just paints over its surroundings.  Mechanics: non-final subpaths
        carry FLAG_FILL_CONT (their interior winding is carried by a
        CMD_WIND, never resolved); the final subpath carries
        FLAG_FILL_FINAL and the whole group's bbox, and resolves
        unconditionally in every bbox tile (combined fills therefore
        never use the opaque solid-bail fast path)."""
        subpaths = [sp for sp in subpaths if len(sp) >= 2]
        if not combined or len(subpaths) <= 1:
            for sp in subpaths:
                self.fill(sp, brush, even_odd=even_odd)
            return
        union = (min(min(p[0] for p in sp) for sp in subpaths),
                 min(min(p[1] for p in sp) for sp in subpaths),
                 max(max(p[0] for p in sp) for sp in subpaths),
                 max(max(p[1] for p in sp) for sp in subpaths))
        for sp in subpaths[:-1]:
            off, bbox = self._add_points(sp)
            self._add_item(TAG_FILL, 0, 0.0, off, len(sp), bbox,
                           flags=(FLAG_FILL_CONT
                                  | (FLAG_EVEN_ODD if even_odd else 0)))
        # The final subpath resolves with the brush over the UNION bbox
        # (a CONT sibling may protrude past the final subpath's own
        # bbox; every tile any sibling touched must resolve).
        sp = subpaths[-1]
        off, _ = self._add_points(sp)
        if isinstance(brush, (LinearGradient, RadialGradient)):
            if even_odd:
                raise ValueError(
                    "gradient fills use nonzero winding (even_odd "
                    "unsupported: the PTCL word budget is exhausted)")
            if self._clip is not None:
                raise ValueError(
                    "gradient fills cannot carry a rect clip (payload "
                    "rides the clip words); use clip_path() groups")
            from .color import decode_color_linear
            c1 = decode_color_linear(np.uint32(brush.rgba1 & 0xFFFFFFFF))
            grad = tuple(brush.params3()) + tuple(float(v) for v in c1) \
                + (0.0,)
            flag = (FLAG_BRUSH_RADIAL if isinstance(brush, RadialGradient)
                    else FLAG_BRUSH_LINEAR)
            self._add_item(TAG_FILL, brush.rgba0, 0.0, off, len(sp), union,
                           flags=flag | FLAG_FILL_FINAL, grad=grad)
        else:
            self._add_item(TAG_FILL, brush, 0.0, off, len(sp), union,
                           flags=(FLAG_FILL_FINAL
                                  | (FLAG_EVEN_ODD if even_odd else 0)))

    # -- clip / layer groups (extension; vello-style coverage stack) ------
    def clip_path(self, points: Sequence[Tuple[float, float]],
                  even_odd: bool = False) -> None:
        """Push an arbitrary-path clip: subsequent items (until the
        matching ``pop``) are multiplied by the path's antialiased
        coverage, intersected with any enclosing clip."""
        if len(self._group_stack) >= MAX_GROUP_DEPTH:
            raise ValueError(f"group nesting deeper than {MAX_GROUP_DEPTH}")
        off, _ = self._add_points(points)
        # Full-coverage bbox: the push/pop commands must reach EVERY tile
        # later items may touch (outside the path the coverage is 0).
        self._add_item(TAG_CLIP, 0, 0.0, off, len(points),
                       (0.0, 0.0, 65535.0, 65535.0),
                       flags=FLAG_EVEN_ODD if even_odd else 0)
        self._group_stack.append(("clip", 0.0))

    def push_layer(self, alpha: float) -> None:
        """Push a group-opacity layer: items until the matching ``pop``
        are composited as a group with the given opacity."""
        if len(self._group_stack) >= MAX_GROUP_DEPTH:
            raise ValueError(f"group nesting deeper than {MAX_GROUP_DEPTH}")
        off, _ = self._add_points([(0.0, 0.0)])
        self._add_item(TAG_LAYER, 0, float(alpha), off, 1,
                       (0.0, 0.0, 65535.0, 65535.0))
        self._group_stack.append(("layer", float(alpha)))

    def pop(self) -> None:
        """End the innermost clip or layer group."""
        if not self._group_stack:
            raise ValueError("pop() without a matching clip_path/push_layer")
        kind, alpha = self._group_stack.pop()
        # The popped LAYER's alpha rides on the pop item (the fine pass
        # composites at pop time); for clips width is unused.
        off, _ = self._add_points([(0.0, 0.0)])
        self._add_item(TAG_POP, 0, alpha, off, 1,
                       (0.0, 0.0, 65535.0, 65535.0),
                       flags=FLAG_POP_LAYER if kind == "layer" else 0)

    def build(self) -> Scene:
        if self._group_stack:
            raise ValueError(
                f"unclosed clip/layer groups: {self._group_stack}")
        n = len(self._tags)
        scene = Scene(
            tags=np.asarray(self._tags, np.int32),
            colors=np.asarray(self._colors, np.uint32),
            widths=np.asarray(self._widths, np.float32),
            bboxes=np.asarray(self._bboxes, np.int32).reshape(n, 4),
            pt_offset=np.asarray(self._pt_offset, np.int32),
            n_pts=np.asarray(self._n_pts, np.int32),
            points=np.asarray(self._points, np.float32).reshape(-1, 2),
            flags=np.asarray(self._flags, np.uint32),
            clips=np.asarray(self._clips, np.float32).reshape(-1, 4),
            grads=np.asarray(self._grads, np.float32).reshape(-1, 8),
        )
        scene.validate()
        return scene
