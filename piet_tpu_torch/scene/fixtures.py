"""Fixture and benchmark scenes.

The reference keeps three switchable fixtures of increasing complexity
(src/lib.rs:256-284,369-373); we keep those plus the driver BASELINE.json
benchmark configs (1k circles + rounded-rect strokes, 10k random cubic
Beziers, glyph page, animated scenes).
"""

from __future__ import annotations

import math
import numpy as np

from ..config import TOLERANCE
from ..geometry import BezPath, flatten_path
from .scene import Scene, SceneBuilder


def make_path_test() -> Scene:
    """One filled triangle (reference src/lib.rs:272-284)."""
    b = SceneBuilder()
    b.begin_group(1)
    b.fill([(10.0, 10.0), (15.0, 800.0), (300.0, 500.0)], 0x80E0)
    b.end_group()
    return b.build()


def make_cardioid(n: int = 97, center=(1024.0, 768.0), r: float = 750.0
                  ) -> Scene:
    """Circles + chord lines tracing a cardioid (reference src/lib.rs:256-270)."""
    b = SceneBuilder()
    b.begin_group((n - 1) * 2)
    dth = math.pi * 2.0 / n
    for i in range(1, n):
        th0 = i * dth
        th1 = ((i * 2) % n) * dth
        p0 = (center[0] + math.cos(th0) * r, center[1] + math.sin(th0) * r)
        p1 = (center[0] + math.cos(th1) * r, center[1] + math.sin(th1) * r)
        b.circle(p0[0], p0[1], 8.0)
        b.stroke_line(p0, p1, 2.0, 0x000080E0)
    b.end_group()
    return b.build()


def _rounded_rect_path(x: float, y: float, w: float, h: float,
                       r: float) -> BezPath:
    """Rounded rectangle as four lines + four quarter-circle cubics."""
    k = r * (4.0 / 3.0) * (math.sqrt(2.0) - 1.0)
    p = BezPath()
    p.move_to((x + r, y))
    p.line_to((x + w - r, y))
    p.curve_to((x + w - r + k, y), (x + w, y + r - k), (x + w, y + r))
    p.line_to((x + w, y + h - r))
    p.curve_to((x + w, y + h - r + k), (x + w - r + k, y + h), (x + w - r, y + h))
    p.line_to((x + r, y + h))
    p.curve_to((x + r - k, y + h), (x, y + h - r + k), (x, y + h - r))
    p.line_to((x, y + r))
    p.curve_to((x, y + r - k), (x + r - k, y), (x + r, y))
    return p


def make_circles_rects(n_circles: int = 1000, n_rects: int = 1000,
                       size: int = 1024, seed: int = 7) -> Scene:
    """BASELINE config 2: 1k circles + 1k rounded-rect strokes."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.begin_group()
    for _ in range(n_circles):
        cx, cy = rng.uniform(0, size, 2)
        b.circle(float(cx), float(cy), float(rng.uniform(2, 24)))
    for _ in range(n_rects):
        x, y = rng.uniform(0, size * 0.9, 2)
        w, h = rng.uniform(16, size * 0.1, 2)
        r = float(rng.uniform(2, min(w, h) / 2))
        path = _rounded_rect_path(float(x), float(y), float(w), float(h), r)
        color = (int(rng.integers(0, 1 << 24)) << 8) | 0xFF
        b.stroke_path(flatten_path(path, TOLERANCE),
                      float(rng.uniform(0.5, 6.0)), color)
    b.end_group()
    return b.build()


def make_random_beziers(n: int = 10000, size: int = 1024, seed: int = 11,
                        fill_fraction: float = 0.5) -> Scene:
    """BASELINE config 3: 10k random cubic Beziers (stress test for binning).

    Each item is a single flattened cubic; half are filled (implicitly
    closed), half are stroked.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.begin_group()
    for i in range(n):
        base = rng.uniform(0, size, 2)
        ctrl = base + rng.uniform(-size * 0.05, size * 0.05, (3, 2))
        path = BezPath()
        path.move_to((float(base[0]), float(base[1])))
        path.curve_to(tuple(ctrl[0]), tuple(ctrl[1]), tuple(ctrl[2]))
        sub = flatten_path(path, TOLERANCE)
        color = (int(rng.integers(0, 1 << 24)) << 8) | int(rng.integers(64, 256))
        if i % 2 == 0 and fill_fraction > 0:
            b.fill_path(sub, color)
        else:
            b.stroke_path(sub, float(rng.uniform(0.5, 4.0)), color)
    b.end_group()
    return b.build()


# A tiny built-in vector "font": glyph outlines as unit-box (0..1) polygons,
# enough to exercise a text page workload without shipping a font file.
_GLYPH_POLYS = {
    "box": [(0.1, 0.1), (0.9, 0.1), (0.9, 0.9), (0.1, 0.9)],
    "tri": [(0.5, 0.05), (0.95, 0.9), (0.05, 0.9)],
    "dia": [(0.5, 0.02), (0.95, 0.5), (0.5, 0.98), (0.05, 0.5)],
    "chv": [(0.1, 0.1), (0.9, 0.5), (0.1, 0.9), (0.35, 0.5)],
    "bar": [(0.4, 0.05), (0.6, 0.05), (0.6, 0.95), (0.4, 0.95)],
}


def make_glyph_page(n_glyphs: int = 5000, size: int = 1024, seed: int = 3
                    ) -> Scene:
    """BASELINE config 4: a text-page-like field of small filled glyphs."""
    rng = np.random.default_rng(seed)
    glyphs = list(_GLYPH_POLYS.values())
    em = max(4.0, size / math.ceil(math.sqrt(n_glyphs * 1.3)))
    cols = int(size / em)
    b = SceneBuilder()
    b.begin_group()
    for i in range(n_glyphs):
        gx = (i % cols) * em
        gy = (i // cols) * em
        poly = glyphs[int(rng.integers(0, len(glyphs)))]
        pts = [(gx + px * em * 0.9, gy + py * em * 0.9) for px, py in poly]
        b.fill(pts, 0x000000FF)
    b.end_group()
    return b.build()


def _animated_params(size: int, n: int, seed: int):
    """The animated fixture's seeded (t-independent) random draws, in the
    exact numpy call order of the original builder loop.  Shared by the
    Python and native (cc/src/fixtures.cc) per-frame builders."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size * 0.1, size * 0.9, (n, 2))
    radii = rng.uniform(size * 0.02, size * 0.08, n)
    phases = rng.uniform(0, 2 * math.pi, n)
    color_hi = np.array([int(rng.integers(0, 1 << 24)) << 8
                         for _ in range(n)], np.uint32)
    return centers, radii, phases, color_hi


def make_animated_frame_native(t: float, size: int = 1024, n: int = 200,
                               seed: int = 5) -> Scene:
    """Native (C++) per-frame build of the animated fixture -- the frame
    critical path of the re-encode benchmark; ~150x the Python builder.
    Bit-identical to make_animated_frame (tests/test_native.py)."""
    from .. import native
    global _ANIM_PARAMS
    key = (size, n, seed)
    if _ANIM_PARAMS.get("key") != key:
        _ANIM_PARAMS = {"key": key, "params": _animated_params(size, n, seed)}
    return native.animated_frame(t, *_ANIM_PARAMS["params"])


_ANIM_PARAMS: dict = {}


def make_animated_frame(t: float, size: int = 1024, n: int = 200,
                        seed: int = 5) -> Scene:
    """BASELINE config 5: one frame of an animated clip (rotating strokes +
    orbiting filled blobs with varying alpha) -- exercises per-frame
    re-encode + render (the reference only re-encoded on resize,
    PietRenderer.m:105-146)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.begin_group()
    centers = rng.uniform(size * 0.1, size * 0.9, (n, 2))
    radii = rng.uniform(size * 0.02, size * 0.08, n)
    phases = rng.uniform(0, 2 * math.pi, n)
    for i in range(n):
        cx, cy = centers[i]
        th = phases[i] + t * (1.0 + 0.2 * (i % 7))
        r = radii[i]
        ox = cx + math.cos(th) * r
        oy = cy + math.sin(th) * r
        k = 12
        pts = [(ox + math.cos(2 * math.pi * j / k + th) * r * 0.5,
                oy + math.sin(2 * math.pi * j / k + th) * r * 0.5)
               for j in range(k)]
        alpha = int(96 + 96 * math.sin(t + phases[i])) & 0xFF
        color = (int(rng.integers(0, 1 << 24)) << 8) | alpha
        if i % 3 == 0:
            b.polyline(pts + [pts[0]], color, 2.0 + (i % 5))
        else:
            b.fill(pts, color)
    b.end_group()
    return b.build()


def make_star_evenodd(size: int = 256) -> Scene:
    """A five-pointed star rendered twice: nonzero winding (solid) and
    even-odd (hollow center pentagon) -- piet FillRule demo."""
    import math as _m
    b = SceneBuilder()
    b.begin_group(2)
    for k, (cx, even_odd) in enumerate(((size * 0.28, False),
                                        (size * 0.72, True))):
        cy, r = size * 0.5, size * 0.22
        pts = []
        for i in range(5):
            th = -_m.pi / 2 + i * 4 * _m.pi / 5   # connect every 2nd vertex
            pts.append((cx + r * _m.cos(th), cy + r * _m.sin(th)))
        b.fill(pts, 0xCC2200FF if k == 0 else 0x0033CCFF,
               even_odd=even_odd)
    b.end_group()
    return b.build()


def make_clipped_demo(size: int = 256) -> Scene:
    """Clip-rectangle demo (piet clip extension): a big filled disk-ish
    polygon, a stroked polyline and a solid-like fill, each clipped to a
    different rect; one unclipped triangle for contrast."""
    import math as _m
    b = SceneBuilder()
    b.begin_group(4)
    k = 24
    disk = [(size * 0.5 + size * 0.4 * _m.cos(2 * _m.pi * i / k),
             size * 0.5 + size * 0.4 * _m.sin(2 * _m.pi * i / k))
            for i in range(k)]
    b.set_clip(size * 0.15, size * 0.15, size * 0.5, size * 0.5)
    b.fill(disk, 0xCC3300FF)
    b.set_clip(size * 0.55, size * 0.2, size * 0.9, size * 0.8)
    b.polyline([(size * 0.1, size * 0.3), (size * 0.9, size * 0.5),
                (size * 0.1, size * 0.7)], 0x0044CCFF, 6.0)
    b.set_clip(size * 0.2, size * 0.6, size * 0.8, size * 0.9)
    b.fill([(0.0, 0.0), (float(size), 0.0), (float(size), float(size)),
            (0.0, float(size))], 0x22AA22FF)
    b.clear_clip()
    b.fill([(size * 0.4, size * 0.05), (size * 0.6, size * 0.05),
            (size * 0.5, size * 0.2)], 0x000000FF)
    b.end_group()
    return b.build()


def make_clip_star(size: int = 256) -> Scene:
    """Arbitrary-path clip + opacity-layer demo (extension): a star-shaped
    clip over a fill + strokes, a 50% layer'd circle, and an unclipped
    square after the pops."""
    import math

    c = size / 2
    b = SceneBuilder()
    star = []
    for k in range(10):
        ang = -math.pi / 2 + k * math.pi / 5
        r = size * (0.39 if k % 2 == 0 else 0.156)
        # Off tile boundaries (the vertex-on-boundary quirk, PARITY.md).
        star.append((c - 0.5 + r * math.cos(ang), c + r * math.sin(ang)))
    b.clip_path(star)
    b.fill([(1.0, 1.0), (size - 1.0, 1.0), (size - 1.0, size - 1.0),
            (1.0, size - 1.0)], 0x2040C0FF)
    for i in range(8):
        b.stroke_line((1.0, i * size / 8.0), (float(size), i * size / 8.0
                                              + size * 0.12),
                      3.0, 0xFF8000FF)
    b.push_layer(0.5)
    b.circle(c, c, size * 0.23)
    b.pop()
    b.pop()
    b.fill([(size * 0.04, size * 0.04), (size * 0.23, size * 0.04),
            (size * 0.23, size * 0.23), (size * 0.04, size * 0.23)],
           0x00A000FF)
    return b.build()


def make_holes_demo(size: int = 256) -> Scene:
    """Combined multi-subpath fill demo (hole extension): an even-odd
    ring with a square hole, a nonzero ring whose hole is a
    reversed-winding star, and a gradient annulus -- none of which the
    reference can represent (one independent Fill per subpath,
    src/lib.rs:342-347)."""
    import math as _m

    from .scene import RadialGradient

    s = float(size)
    b = SceneBuilder()

    def rect(x0, y0, x1, y1, ccw=False):
        pts = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
        return pts[::-1] if ccw else pts

    def ngon(cx, cy, r, k=24, ccw=False, star=False):
        pts = []
        for i in range(k):
            th = 2 * _m.pi * i / k
            rr = r * (0.55 if star and i % 2 else 1.0)
            pts.append((cx + rr * _m.cos(th), cy + rr * _m.sin(th)))
        return pts[::-1] if ccw else pts

    # Even-odd square ring.
    b.fill_path([rect(0.05 * s, 0.05 * s, 0.45 * s, 0.45 * s),
                 rect(0.15 * s, 0.15 * s, 0.35 * s, 0.35 * s)],
                0x2040C0FF, even_odd=True, combined=True)
    # Nonzero ring with a reversed star-shaped hole.
    b.fill_path([ngon(0.72 * s, 0.25 * s, 0.2 * s),
                 ngon(0.72 * s, 0.25 * s, 0.13 * s, k=10, ccw=True,
                      star=True)],
                0xC04020FF, combined=True)
    # Gradient annulus (nonzero; reversed inner ring).  Center chosen off
    # x = 0.5*s: at tile_width 128 that puts ngon vertices EXACTLY on a
    # tile boundary, where the reference's strict sign tests drop the
    # crossing (the same knife-edge any reference fill has; see the
    # axis-aligned note in make_gradient_demo).
    b.fill_path([ngon(0.47 * s, 0.72 * s, 0.24 * s),
                 ngon(0.47 * s, 0.72 * s, 0.12 * s, ccw=True)],
                RadialGradient((0.47 * s, 0.72 * s), 0.26 * s,
                               0xFFE000FF, 0x0030A0FF),
                combined=True)
    return b.build()


def make_gradient_demo(size: int = 256) -> Scene:
    """Gradient-brush demo (2-stop extension): a linear-gradient sky
    square, a radial-gradient disk, a linear-gradient star (winding
    interior exercises the no-segment gradient tile path), and a solid
    triangle for contrast."""
    import math as _m

    from .scene import LinearGradient, RadialGradient

    b = SceneBuilder()
    s = float(size)
    # Overhang by 1px: an edge EXACTLY on a tile boundary contributes no
    # coverage (faithful reference semantics -- strict sign tests,
    # PietRender.metal:345-353), so axis-aligned demo rects avoid it.
    b.fill([(-1.0, -1.0), (s + 1.0, -1.0), (s + 1.0, s + 1.0),
            (-1.0, s + 1.0)],
           LinearGradient((0.0, 0.0), (0.0, s), 0x1030A0FF, 0xF0D080FF))
    k = 40
    disk = [(s * 0.32 + s * 0.26 * _m.cos(2 * _m.pi * i / k),
             s * 0.62 + s * 0.26 * _m.sin(2 * _m.pi * i / k))
            for i in range(k)]
    b.fill(disk, RadialGradient((s * 0.28, s * 0.56), s * 0.3,
                                0xFFF0C0FF, 0xC03000FF))
    star = []
    for i in range(5):
        th = -_m.pi / 2 + i * 4 * _m.pi / 5
        star.append((s * 0.72 + s * 0.22 * _m.cos(th),
                     s * 0.3 + s * 0.22 * _m.sin(th)))
    b.fill(star, LinearGradient((s * 0.5, s * 0.08), (s * 0.94, s * 0.52),
                                0x00E080FF, 0x6000C0FF))
    b.fill([(s * 0.55, s * 0.92), (s * 0.9, s * 0.7), (s * 0.9, s * 0.92)],
           0x202020FF)
    return b.build()


SCENES = {
    "path_test": make_path_test,
    "cardioid": make_cardioid,
    "circles_rects": make_circles_rects,
    "beziers_10k": make_random_beziers,
    "glyph_page": make_glyph_page,
    "star_evenodd": make_star_evenodd,
    "clipped_demo": make_clipped_demo,
    "clip_star": make_clip_star,
    "gradients": make_gradient_demo,
    "holes": make_holes_demo,
}


def get_scene(name: str, **kwargs) -> Scene:
    if name == "tiger":
        from .svg import make_tiger
        return make_tiger(**kwargs)
    if name == "animated":
        return make_animated_frame(kwargs.pop("t", 0.0), **kwargs)
    return SCENES[name](**kwargs)
