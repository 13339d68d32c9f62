"""The benchmark's text page (``frame_bench/reference/scene/text.py``)
through the port on the CPU: DejaVu Sans glyphs as combined fills, their
counters holes, bitwise equal to the frozen oracle on both segment
stages; the quadratic-to-cubic elevation; the full page's frozen counts;
and ``tracing.COMBINED_FILLS``."""

import numpy as np
import pytest
import torch

from frame_bench.reference.config import RenderConfig as RefConfig
from frame_bench.reference.config import TOLERANCE
from frame_bench.reference.geometry import cubic_eval, flatten_path
from frame_bench.reference.raster.cpu_fine import \
    cpu_render_scene as ref_render
from frame_bench.reference.scene import text
from frame_bench.reference.scene.scene import (FLAG_FILL_CONT,
                                               FLAG_FILL_FINAL, SceneBuilder)
from frame_bench.workload import port_scene
from piet_tpu_torch import tracing
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene
from piet_tpu_torch.renderer.capacity import fit_capacities
from piet_tpu_torch.renderer.renderer import (Renderer, make_render_fn,
                                              prepare_scene)
from piet_tpu_torch.scene import svg

torch.set_num_threads(1)


def _rgba(img: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(img.numpy()).view(np.uint8).reshape(
        *img.shape, 4)


def _cfgs(scene, w, h, tw=128, th=32):
    cfg = fit_capacities(scene, RenderConfig(
        width=w, height=h, tile_width=tw, tile_height=th, cmd_capacity=1024))
    return cfg, RefConfig(width=w, height=h, tile_width=tw, tile_height=th,
                          cmd_capacity=cfg.cmd_capacity)


def _groups(scene):
    return int(np.count_nonzero(scene.flags & FLAG_FILL_FINAL))


@pytest.mark.parametrize("stage", ["host", "device"])
def test_small_page_equals_the_frozen_oracle(stage):
    """A 256^2 page of 200 glyphs: make_render_fn on the host segment
    stage, and Renderer.render_u32 (which derives the segments in the
    step), each bitwise equal to the frozen oracle."""
    ref = text.make_text_page(n_glyphs=200, size=256)
    assert _groups(ref) > 50
    scene = port_scene(ref)
    cfg, rcfg = _cfgs(scene, 256, 256)
    if stage == "host":
        staged = prepare_scene(scene, cfg, "cpu")
        assert staged.seg_pre is not None
        img, stats = make_render_fn(cfg, device="cpu")(staged)
        assert int(stats["overflow_cmds"]) == 0
    else:
        img = Renderer(cfg, device="cpu").render_u32(scene)
    np.testing.assert_array_equal(_rgba(img), ref_render(ref, rcfg))


def _glyph(b, c, x, baseline, px):
    """Draw character ``c`` at ``px``; its contours' boxes in pixels."""
    font = text.load_glyphs()
    path = text.glyph_path(font["glyphs"][c]["contours"], x, baseline,
                           px / font["units_per_em"])
    subs = flatten_path(path, TOLERANCE)
    b.fill_path(subs, text.INK, combined=True)
    return [(min(p[0] for p in s), min(p[1] for p in s),
             max(p[0] for p in s), max(p[1] for p in s)) for s in subs]


def test_counters_are_holes():
    """An ``o`` and a ``d`` at 96 px: the pixel at each counter's centre
    is background and a pixel on each stem (between the counter and the
    outline, at the counter's centre row) is ink, in the port and in the
    oracle."""
    b = SceneBuilder()
    boxes = {"o": _glyph(b, "o", 8.0, 100.0, 96.0),
             "d": _glyph(b, "d", 72.0, 100.0, 96.0)}
    ref = b.build()
    assert ref.n_items == 4 and _groups(ref) == 2
    scene = port_scene(ref)
    cfg, rcfg = _cfgs(scene, 192, 128, tw=64)
    want = ref_render(ref, rcfg)
    got = _rgba(Renderer(cfg, device="cpu").render_u32(scene))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cpu_render_scene(scene, cfg), want)
    ink = np.array([0, 0, 0, 255], np.uint8)
    background = want[0, 0].copy()
    assert not np.array_equal(background, ink)
    for c, contours in boxes.items():
        assert len(contours) == 2
        inner, outer = sorted(contours,
                              key=lambda q: (q[2] - q[0]) * (q[3] - q[1]))
        cx, cy = (inner[0] + inner[2]) / 2, (inner[1] + inner[3]) / 2
        row = int(cy)
        for img in (got, want):
            np.testing.assert_array_equal(img[row, int(cx)], background,
                                          err_msg=c)
            for x in ((outer[0] + inner[0]) / 2, (inner[2] + outer[2]) / 2):
                np.testing.assert_array_equal(img[row, int(x)], ink,
                                              err_msg=c)


def _quad(p0, q, p2, t):
    p0, q, p2 = (np.asarray(v, np.float64) for v in (p0, q, p2))
    return (1 - t) ** 2 * p0 + 2 * (1 - t) * t * q + t * t * p2


@pytest.mark.parametrize("p0, q, p2", [
    ((0.0, 0.0), (5.0, 10.0), (10.0, 0.0)),
    ((627.5, 991.25), (479.0, 991.0), (307.0, 760.0)),
    ((-3.0, 7.0), (-3.0, 7.0), (12.5, -1.0))])
def test_elevated_cubic_equals_the_quadratic(p0, q, p2):
    c1, c2 = text.elevate(p0, q, p2)
    for t in np.linspace(0.0, 1.0, 17):
        np.testing.assert_allclose(cubic_eval(p0, c1, c2, p2, float(t)),
                                   _quad(p0, q, p2, t), rtol=0, atol=1e-12)


def test_full_page_counts_are_frozen():
    """The benchmark's 5,000-glyph page, as the committed generator and
    asset give it: 48 lines, 7,365 items, 89,969 points, 2,365 groups of
    4,730 subpaths."""
    page = text.make_text_page()
    assert (page.n_items, page.n_points, _groups(page)) == (7365, 89969,
                                                            2365)
    assert int(np.count_nonzero(
        page.flags & (FLAG_FILL_CONT | FLAG_FILL_FINAL))) == 4730
    assert len({y for _, _, y in text.layout(5000, 1024, 16, 20, 8)}) == 48
    font = text.load_glyphs()
    assert (font["units_per_em"], font["version"]) == (2048, "Version 2.35")


def test_combined_fills_counts_a_staged_page():
    """prepare_scene adds a page's groups and subpaths to
    tracing.COMBINED_FILLS on either segment stage; the tiger, which has
    no combined fill, adds nothing."""
    ref = text.make_text_page(n_glyphs=40, size=256)
    scene = port_scene(ref)
    groups = _groups(ref)
    subpaths = int(np.count_nonzero(
        ref.flags & (FLAG_FILL_CONT | FLAG_FILL_FINAL)))
    assert 0 < groups < subpaths
    cfg = fit_capacities(scene, RenderConfig(width=256, height=256))
    before = dict(tracing.COMBINED_FILLS)
    prepare_scene(scene, cfg, "cpu")
    prepare_scene(scene, cfg, "cpu", seg_pre=False)
    assert tracing.COMBINED_FILLS == {
        "scenes": before["scenes"] + 2, "groups": before["groups"] + 2 * groups,
        "subpaths": before["subpaths"] + 2 * subpaths}
    after = dict(tracing.COMBINED_FILLS)
    tiger = svg.make_tiger(scale=1.0)
    prepare_scene(tiger, fit_capacities(tiger, RenderConfig(
        width=256, height=256)), "cpu")
    assert tracing.COMBINED_FILLS == after
