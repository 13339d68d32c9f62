"""The port's copies of the wire format (scene/wire.py), the general SVG
loader (scene/svg_full.py) and the piet-style drawing API (api.py)
against the JAX package's: the same bytes, the same scenes bit for bit,
and a RenderContext scene rendered by the port's Renderer on the CPU
equal to the numpy oracle."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import piet_tpu.api as japi
import piet_tpu.geometry as jgeom
import piet_tpu.geometry.shapes as jshapes
import piet_tpu.scene.fixtures as jfix
import piet_tpu.scene.scene as jscene
import piet_tpu.scene.svg_full as jsvg
import piet_tpu.scene.wire as jwire
import piet_tpu_torch.api as papi
import piet_tpu_torch.geometry as pgeom
import piet_tpu_torch.geometry.shapes as pshapes
import piet_tpu_torch.scene.fixtures as pfix
import piet_tpu_torch.scene.scene as pscene
import piet_tpu_torch.scene.svg_full as psvg
import piet_tpu_torch.scene.wire as pwire
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene
from piet_tpu_torch.renderer.renderer import Renderer

torch.set_num_threads(1)

FIELDS = ("tags", "colors", "widths", "bboxes", "pt_offset", "n_pts",
          "points", "flags", "clips", "grads")
TIGER_FILE = str(Path(__file__).resolve().parent.parent / "assets"
                 / "Ghostscript_Tiger.svg")


def _same_scene(a, b, what=""):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        np.testing.assert_array_equal(np.ascontiguousarray(x).view(np.uint8),
                                      np.ascontiguousarray(y).view(np.uint8),
                                      err_msg=f"{what}: {f}")


FIXTURES = [("path_test", {}), ("cardioid", {}), ("gradients", {}),
            ("clip_star", {}), ("holes", {}), ("clipped_demo", {}),
            ("animated", {"t": 0.4, "size": 256, "n": 24}),
            ("tiger", {"scale": 1.0}), ("tiger", {})]


@pytest.mark.parametrize("name,kw", FIXTURES,
                         ids=[f"{n}{kw or ''}" for n, kw in FIXTURES])
def test_encode_scene_bytes_equal_and_round_trip(name, kw):
    """The same bytes as JAX's encoder; decoding gives JAX's decoded
    scene, which encodes back to the same bytes.  (A decoded scene need
    not equal the source scene field for field: a line item's points,
    for one, are not on the wire.)"""
    scene = pfix.get_scene(name, **kw)
    wire = pwire.encode_scene(scene)
    assert wire == jwire.encode_scene(jfix.get_scene(name, **kw))
    back = pwire.decode_scene(wire)
    _same_scene(back, jwire.decode_scene(wire), name)
    assert pwire.encode_scene(back) == wire
    assert pwire.hexdump_scene(wire) == jwire.hexdump_scene(wire)


def test_tiger_svg_file_loads_bitwise_equal():
    for kw in ({}, {"scale": 2.0}, {"target_width": 1024}):
        _same_scene(psvg.load_svg_file(TIGER_FILE, **kw),
                    jsvg.load_svg_file(TIGER_FILE, **kw), str(kw))


SVG_DOCS = {
    "group_transform": """
      <svg viewBox="0 0 128 128">
        <g fill="#f00" transform="translate(64, 0) rotate(10)">
          <rect x="0.5" y="8.5" width="30" height="30"/>
        </g>
      </svg>""",
    "style_and_opacity": """
      <svg viewBox="0 0 128 128">
        <rect x="8.5" y="8.5" width="40" height="40" fill="#f00"
              style="fill: #0000ff"/>
        <g opacity="0.5">
          <rect x="8.5" y="8.5" width="100" height="100" fill="#000"/>
        </g>
      </svg>""",
    "shapes": """
      <svg viewBox="0 0 128 128">
        <circle cx="32" cy="32" r="20" fill="lime"/>
        <ellipse cx="90" cy="30" rx="20" ry="10" fill="navy"/>
        <polygon points="70,70 120,70 95,120" fill="rgb(0,0,255)"/>
        <polyline points="5,60 30,90 50,60" fill="none" stroke="#0a0"
                  stroke-width="3"/>
        <line x1="8" y1="120" x2="60" y2="120" stroke="#f00"
              stroke-width="6"/>
        <path d="M 10 100 C 20 80, 40 80, 50 100 Z" fill-rule="evenodd"/>
      </svg>""",
}


@pytest.mark.parametrize("doc", sorted(SVG_DOCS))
def test_svg_documents_load_bitwise_equal(doc):
    _same_scene(psvg.load_svg_document(SVG_DOCS[doc]),
                jsvg.load_svg_document(SVG_DOCS[doc]), doc)


# ---- RenderContext: the cases of tests/test_api.py, built by each package


class _Pkg:
    """One package's API surface, so one builder serves both."""

    def __init__(self, api, geom, shapes, scene):
        self.RenderContext = api.RenderContext
        self.Affine = geom.Affine
        self.Rect, self.Line = shapes.Rect, shapes.Line
        self.CirclePath, self.Ellipse = shapes.CirclePath, shapes.Ellipse
        self.RoundedRect = shapes.RoundedRect
        self.LinearGradient = scene.LinearGradient
        self.RadialGradient = scene.RadialGradient


PORT = _Pkg(papi, pgeom, pshapes, pscene)
JAX = _Pkg(japi, jgeom, jshapes, jscene)


def _fill_rect(m):
    ctx = m.RenderContext()
    ctx.fill(m.Rect(8.5, 8.5, 60.5, 60.5), 0xFF0000FF)
    return ctx


def _transform_stack(m):
    ctx = m.RenderContext()
    ctx.save()
    ctx.transform(m.Affine.translate(64.0, 0.0))
    ctx.fill(m.Rect(0.5, 8.5, 30.5, 38.5), 0x00FF00FF)
    ctx.restore()
    ctx.fill(m.Rect(0.5, 64.5, 30.5, 94.5), 0x0000FFFF)
    return ctx


def _clip_until_restore(m):
    ctx = m.RenderContext()
    with ctx.clipped(m.Rect(0.5, 0.5, 64.5, 64.5)):
        ctx.fill(m.Rect(-10.0, -10.0, 200.0, 200.0), 0xFF0000FF)
    ctx.fill(m.Rect(80.5, 80.5, 110.5, 110.5), 0x0000FFFF)
    return ctx


def _fill_with_hole(m):
    ctx = m.RenderContext()
    ring = m.Rect(8.5, 8.5, 119.5, 119.5).to_path()
    ring.elements.extend(m.Rect(40.5, 40.5, 87.5, 87.5).to_path().elements)
    ctx.fill(ring, 0x000000FF, even_odd=True)
    return ctx


def _gradient_brush(m):
    ctx = m.RenderContext()
    ctx.transform(m.Affine.translate(0.0, 64.0) * m.Affine.scale(0.5))
    ctx.fill(m.Rect(-2.0, -2.0, 258.0, 130.0),
             m.LinearGradient((0.0, 0.0), (0.0, 128.0), 0x000000FF,
                              0xFFFFFFFF))
    return ctx


def _stroke_width(m):
    ctx = m.RenderContext()
    ctx.transform(m.Affine.scale(4.0))
    ctx.stroke(m.Line((4.0, 8.0), (28.0, 8.0)), 0x000000FF, 2.0)
    return ctx


def _shapes(m):
    ctx = m.RenderContext()
    ctx.fill(m.CirclePath((32.0, 32.0), 20.0), 0xFF0000FF)
    ctx.fill(m.Ellipse((96.0, 32.0), 24.0, 12.0), 0x00FF00FF)
    ctx.fill(m.RoundedRect(8.5, 72.5, 60.5, 119.5, 10.0), 0x0000FFFF)
    return ctx


def _clear(m):
    ctx = m.RenderContext()
    ctx.fill(m.Rect(8.5, 8.5, 119.5, 119.5), 0xFF0000FF)
    ctx.clear(0x102030FF)
    return ctx


def _mixed(m):
    ctx = m.RenderContext()
    ctx.transform(m.Affine.rotate(math.radians(10.0))
                  * m.Affine.translate(10.0, -10.0))
    with ctx.clipped(m.CirclePath((64.0, 64.0), 56.0)):
        ctx.fill(m.Rect(-50.0, -50.0, 250.0, 250.0),
                 m.RadialGradient((64.0, 64.0), 70.0, 0xFFE000FF,
                                  0x0030A0FF))
        ctx.stroke(m.Line((0.0, 20.0), (128.0, 100.0)), 0x000000FF, 3.0)
    ctx.fill(m.RoundedRect(70.5, 70.5, 120.5, 120.5, 8.0), 0x20C040FF)
    return ctx


CASES = {f.__name__[1:]: f for f in (
    _fill_rect, _transform_stack, _clip_until_restore, _fill_with_hole,
    _gradient_brush, _stroke_width, _shapes, _clear, _mixed)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_context_scene_bitwise_equal(case):
    _same_scene(CASES[case](PORT).finish(), CASES[case](JAX).finish(), case)


def test_render_context_errors_match():
    with pytest.raises(ValueError, match="restore"):
        papi.RenderContext().restore()
    with pytest.raises(ValueError, match="gradient strokes"):
        papi.RenderContext().stroke(pshapes.Line((0, 0), (1, 1)),
                                    pscene.RadialGradient((0, 0), 1, 0, 0),
                                    1.0)


@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_render_context_scene_renders_equal_to_the_oracle(fine_impl):
    """tests/test_api.py's mixed scene through the port's Renderer on the
    CPU: 0 pixels off the oracle (the port's CPU path rounds as the
    oracle does; no FMA tolerance)."""
    cfg = RenderConfig(width=128, height=128, tile_height=16,
                       tile_width=128, cmd_capacity=128)
    scene = _mixed(PORT).finish()
    img = Renderer(cfg, "cpu", fine_impl=fine_impl).render(scene)
    np.testing.assert_array_equal(img, cpu_render_scene(scene, cfg))
