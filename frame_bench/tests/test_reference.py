"""The frozen reference against the port's oracle, and the import rules.

The reference (``frame_bench/reference``) is a copy of the port's numpy
oracle and scene makers; these tests hold it to the port's own oracle on
small scenes (a test may import the port; the reference may not) and
check that nothing under ``frame_bench`` imports JAX or the JAX package.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from frame_bench.reference import band
from frame_bench.reference.affine import transform_scene
from frame_bench.reference.config import RenderConfig as RefConfig
from frame_bench.reference.raster.cpu_fine import \
    cpu_render_scene as ref_render
from frame_bench.reference.scene.fixtures import make_random_beziers
from frame_bench.reference.scene.svg import make_tiger
from frame_bench import scenes
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene
from piet_tpu_torch.scene import fixtures
from piet_tpu_torch.scene import svg as port_svg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("tags", "colors", "widths", "bboxes", "pt_offset", "n_pts",
          "points", "flags", "clips", "grads")


def _same_scene(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _cfgs(w, h, cap=1024, tw=128, th=32):
    return (RenderConfig(width=w, height=h, tile_width=tw, tile_height=th,
                         cmd_capacity=cap),
            RefConfig(width=w, height=h, tile_width=tw, tile_height=th,
                      cmd_capacity=cap))


SCENES = {
    "tiger": lambda: port_svg.make_tiger(scale=1.0),
    "beziers": lambda: fixtures.make_random_beziers(n=120, size=192, seed=4),
    "clipped": lambda: fixtures.make_clipped_demo(size=192),
    "gradient": lambda: fixtures.make_gradient_demo(size=192),
    "holes": lambda: fixtures.make_holes_demo(size=192),
    "star_evenodd": lambda: fixtures.make_star_evenodd(size=192),
    "circles_rects": lambda: fixtures.make_circles_rects(
        n_circles=40, n_rects=40, size=192, seed=2),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frozen_oracle_equals_port_oracle(name):
    scene = SCENES[name]()
    cfg, rcfg = _cfgs(192, 160, tw=64, th=32)
    np.testing.assert_array_equal(ref_render(scene, rcfg),
                                  cpu_render_scene(scene, cfg))


@pytest.mark.parametrize("workers", [1, 2])
def test_bands_equal_the_whole_oracle(workers):
    scene = SCENES["clipped"]()
    _, rcfg = _cfgs(192, 160, tw=64, th=32)
    img, ptcl = band.render(scene, rcfg, workers=workers)
    np.testing.assert_array_equal(img, ref_render(scene, rcfg))
    assert ptcl["solid"].shape == (rcfg.n_tiles,)
    assert len(ptcl["tile"]) == len(ptcl["tag"]) == len(ptcl["args"]) > 0
    assert np.all(np.diff(ptcl["tile"]) >= 0)


def test_bands_leave_no_process_behind():
    from frame_bench.run import child_pids
    scene = SCENES["clipped"]()
    _, rcfg = _cfgs(192, 160, tw=64, th=32)
    before = set(child_pids())
    band.render(scene, rcfg, workers=3)
    assert set(child_pids()) <= before


def test_frozen_scene_makers_equal_the_port():
    _same_scene(make_tiger(scale=19.2), port_svg.make_tiger(scale=19.2))
    _same_scene(make_random_beziers(n=300, size=1024, seed=2**31 + 7),
                fixtures.make_random_beziers(n=300, size=1024,
                                             seed=2**31 + 7))


def test_the_seed_recolours_a_fixed_geometry():
    cfg = {"scene": {"kind": "tiger", "scale": 19.2}}
    a = scenes.make_scene(cfg, 5)
    b = scenes.make_scene(cfg, 5)
    c = scenes.make_scene(cfg, 2**32 + 6)
    _same_scene(a, b)
    base = make_tiger(scale=19.2)
    for f in FIELDS:
        if f != "colors":
            np.testing.assert_array_equal(getattr(c, f), getattr(base, f))
    assert a.n_points == 44914
    assert np.array_equal(a.colors & 0xFF, base.colors & 0xFF)
    assert not np.array_equal(a.colors, c.colors)


@pytest.mark.parametrize("scene_name", ["tiger", "gradient", "clipped"])
def test_affine_equals_the_port_device_transform(scene_name):
    """The reference's transform of a host scene equals what the port's
    device animation computes (on the CPU, where its torch ops round as
    they do on the card), fetched back to the host."""
    from piet_tpu_torch.renderer.capacity import fit_capacities
    from piet_tpu_torch.renderer.renderer import fetch_scene, prepare_scene
    from piet_tpu_torch.scene.affine import build_base, \
        transform_device_scene

    scene = SCENES[scene_name]()
    cfg = fit_capacities(scene, RenderConfig(width=192, height=192),
                         bucket=True)
    dev = prepare_scene(scene, cfg, "cpu", seg_pre=False)
    ab = build_base(scene, cfg, "cpu")
    for k in range(3):
        m = scenes.pose_matrix(k, 7, 0.1, 192, 192)
        got = fetch_scene(transform_device_scene(dev, ab, torch.tensor(m)),
                          scene.n_items, scene.n_points)
        _same_scene(transform_scene(scene, m), got)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_nothing_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "piet_tpu"}
    found = [(p.relative_to(ROOT).as_posix(), m)
             for p in ROOT.rglob("*.py") for m in _imports(p)
             if m.split(".")[0] in bad]
    assert found == []


def test_reference_imports_nothing_of_the_program():
    found = [(p.name, m) for p in (ROOT / "reference").rglob("*.py")
             for m in _imports(p) if m.split(".")[0] == "piet_tpu_torch"]
    assert found == []
