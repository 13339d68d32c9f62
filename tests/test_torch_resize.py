"""The port's ResizableRenderer (piet_tpu_torch/renderer/resize.py) on the
CPU: the three tests of tests/test_resize.py against the port, and one
viewport held against the JAX package's ResizableRenderer and the numpy
oracle.

Tolerances: the port's crops bitwise equal to dedicated per-viewport
port renderers and to the oracle; JAX-on-CPU's within tests/_imgcmp.py's
documented <= 2 codes on <= 0.1% of pixels.
"""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from _imgcmp import assert_images_match  # noqa: E402
from piet_tpu.renderer.resize import (  # noqa: E402
    ResizableRenderer as JaxResizableRenderer)
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu_torch.renderer.renderer import Renderer  # noqa: E402
from piet_tpu_torch.renderer.resize import ResizableRenderer  # noqa: E402
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402


@pytest.fixture(scope="module")
def tiger():
    return make_tiger(scale=1.0)


CAPS = dict(max_items=512, max_points=1 << 15, max_segments=1 << 15,
            max_hits=1 << 17, max_candidates=1 << 14, max_deltas=1 << 15,
            cmd_capacity=2688)


def _config(w, h):
    return RenderConfig(width=w, height=h, tile_height=16, tile_width=128,
                        **CAPS)


@pytest.mark.parametrize("impl", ["dense", "entries"])
def test_resize_one_graph_and_exact(tiger, impl):
    rr = ResizableRenderer(_config(384, 384), device="cpu", fine_impl=impl)
    img_a = rr.render(tiger, 256, 224)
    assert rr.n_compiles() == 1
    img_b = rr.render(tiger, 384, 384)
    assert rr.n_compiles() == 1, "resize must not build a new step"
    img_c = rr.render(tiger, 128, 320)
    assert rr.n_compiles() == 1, "resize must not build a new step"

    # Bit-identical to dedicated per-viewport renderers.
    for img, (w, h) in ((img_a, (256, 224)), (img_b, (384, 384)),
                        (img_c, (128, 320))):
        assert img.shape == (h, w, 4)
        ded = Renderer(_config(w, h), device="cpu",
                       fine_impl=impl).render(tiger)
        np.testing.assert_array_equal(img, ded)


def test_resize_matches_jax_and_oracle(tiger):
    """One viewport of the port's dense route against JAX's "xla" route
    (the route of tests/test_resize.py) and the numpy oracle."""
    rr = ResizableRenderer(_config(384, 384), device="cpu",
                           fine_impl="dense")
    got = rr.render(tiger, 256, 224)
    np.testing.assert_array_equal(got,
                                  cpu_render_scene(tiger, _config(256, 224)))
    want = JaxResizableRenderer(_config(384, 384), fine_impl="xla").render(
        tiger, 256, 224)
    assert_images_match(got, want)
    assert rr.last_stats["overflow_cmds"] == 0


def test_resize_bounds(tiger):
    rr = ResizableRenderer(_config(256, 256), device="cpu",
                           fine_impl="dense")
    with pytest.raises(ValueError):
        rr.render(tiger, 4096, 64)
    with pytest.raises(ValueError):
        rr.render(tiger, 0, 64)
    assert rr.n_compiles() == 0


def test_for_scene_fits(tiger):
    rr = ResizableRenderer.for_scene(tiger, 256, 256, device="cpu",
                                     fine_impl="dense", tile_height=16,
                                     tile_width=128)
    img = rr.render(tiger, 200, 200)
    assert img.shape == (200, 200, 4)
    assert rr.config.width == rr.max_width == 256
    np.testing.assert_array_equal(
        img, cpu_render_scene(tiger, rr.config)[:200, :200])
