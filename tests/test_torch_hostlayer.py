"""The port's copy of the numpy host layer against its ``piet_tpu``
original: scenes field by field, capacities, the host segment stage, the
word-map and flag constants, and the oracle's images -- all bitwise.

The port keeps its own copies (piet_tpu_torch/{config,api,geometry,scene,
layout,raster,renderer,utils}) so that it imports nothing of the JAX
package; these tests catch a copy that drifts from the reference.
"""

import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

#: Copied modules, by path relative to each package.  Every copy's text
#: equals its original's.
COPIES = ["config", "geometry.bezier", "geometry.path", "geometry.shapes",
          "geometry.svg_path", "scene.scene", "scene.color", "scene.svg",
          "scene.fixtures", "scene.wire", "scene.svg_full", "api",
          "layout.entry_stream", "layout.dsl", "layout.packing",
          "layout.emit_cpp", "layout.emit_py", "layout.modules",
          "raster.ptcl", "raster.cpu_tiler",
          "raster.cpu_fine", "renderer.capacity", "renderer.segstage",
          "utils.png"]


def _pair(rel):
    return (importlib.import_module(f"piet_tpu_torch.{rel}"),
            importlib.import_module(f"piet_tpu.{rel}"))


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_source_unchanged(rel):
    path = rel.replace(".", "/") + ".py"
    assert ((ROOT / "piet_tpu_torch" / path).read_text()
            == (ROOT / "piet_tpu" / path).read_text())


@pytest.mark.parametrize("rel", COPIES)
def test_module_constants_equal(rel):
    """Every upper-case constant: the PTCL command tags, the entry word
    map and meta bits, the scene flags and tags, the colour tables."""
    port, ref = _pair(rel)
    consts = sorted(n for n, v in vars(ref).items()
                    if n.isupper() and not n.startswith("_")
                    and not callable(v)
                    and not hasattr(v, "__file__"))
    for name in consts:
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(b):       # REFERENCE_CONFIG
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        elif isinstance(b, dict):   # name -> builder or colour tables
            assert a.keys() == b.keys(), name
            assert all(a[k].__name__ == b[k].__name__ if callable(b[k])
                       else a[k] == b[k] for k in b), name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=name)
        else:
            assert a == b, name


SCENES = [
    ("tiger", "tiger", {}),
    ("tiger_1x", "tiger", {"scale": 1.0}),
    ("path_test", "path_test", {}),
    ("animated", "animated", {}),
    ("animated_512", "animated", {"size": 512}),
    ("animated_t", "animated", {"t": 0.9, "size": 256, "n": 24}),
    ("gradients", "gradients", {}),
    ("holes", "holes", {}),
    ("star_evenodd", "star_evenodd", {}),
    ("clip_star", "clip_star", {}),
    ("clipped_demo", "clipped_demo", {}),
    ("circles_rects", "circles_rects",
     {"n_circles": 200, "n_rects": 200, "size": 512}),
]

_FIELDS = ("tags", "colors", "widths", "bboxes", "pt_offset", "n_pts",
           "points", "flags", "clips", "grads")


def _scenes(name, kw):
    port, ref = _pair("scene.fixtures")
    return port.get_scene(name, **dict(kw)), ref.get_scene(name, **dict(kw))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                  np.ascontiguousarray(b).view(np.uint8),
                                  err_msg=what)


@pytest.mark.parametrize("case,name,kw", SCENES, ids=[s[0] for s in SCENES])
def test_scene_fields_bitwise(case, name, kw):
    got, want = _scenes(name, kw)
    for f in _FIELDS:
        _same(getattr(got, f), getattr(want, f), f"{case}: {f}")


CFG_SCENES = [s for s in SCENES if s[0] in (
    "tiger_1x", "path_test", "animated", "gradients", "holes", "clip_star")]


def _configs(case, name, kw, tile_h=32):
    got, want = _scenes(name, kw)
    pcfg = importlib.import_module("piet_tpu_torch.config")
    rcfg = importlib.import_module("piet_tpu.config")
    size = 512 if case in ("tiger_1x", "animated") else 256
    pc, rc = _pair("renderer.capacity")
    a = pc.fit_capacities(got, pcfg.RenderConfig(
        width=size, height=size, tile_height=tile_h, tile_width=128),
        bucket=True)
    b = rc.fit_capacities(want, rcfg.RenderConfig(
        width=size, height=size, tile_height=tile_h, tile_width=128),
        bucket=True)
    return got, want, a, b


@pytest.mark.parametrize("case,name,kw", CFG_SCENES,
                         ids=[s[0] for s in CFG_SCENES])
def test_fit_capacities_equal(case, name, kw):
    _, _, a, b = _configs(case, name, kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("case,name,kw", CFG_SCENES,
                         ids=[s[0] for s in CFG_SCENES])
def test_build_seg_pre_bitwise(case, name, kw):
    got, want, a, b = _configs(case, name, kw, tile_h=16)
    ps, rs = _pair("renderer.segstage")
    sp, rp = ps.build_seg_pre(got, a), rs.build_seg_pre(want, b)
    for f in rp._fields:
        _same(getattr(sp, f), getattr(rp, f), f"{case}: {f}")


RENDER_SCENES = [s for s in SCENES if s[0] in (
    "path_test", "animated_t", "gradients", "holes", "star_evenodd",
    "clip_star", "clipped_demo")]


@pytest.mark.parametrize("case,name,kw", RENDER_SCENES,
                         ids=[s[0] for s in RENDER_SCENES])
def test_cpu_render_scene_bitwise(case, name, kw):
    got, want = _scenes(name, kw)
    pcfg = importlib.import_module("piet_tpu_torch.config")
    rcfg = importlib.import_module("piet_tpu.config")
    pf, rf = _pair("raster.cpu_fine")
    kw_cfg = dict(width=256, height=256, tile_height=16, tile_width=128)
    a = pf.cpu_render_scene(got, pcfg.RenderConfig(**kw_cfg))
    b = rf.cpu_render_scene(want, rcfg.RenderConfig(**kw_cfg))
    assert a.shape == (256, 256, 4)
    _same(a, b, case)


def test_png_writer_bytes_equal(tmp_path):
    pp, rp = _pair("utils.png")
    img = (np.arange(8 * 8 * 4) % 251).astype(np.uint8).reshape(8, 8, 4)
    pp.write_png(str(tmp_path / "a.png"), img)
    rp.write_png(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (
        tmp_path / "b.png").read_bytes()
