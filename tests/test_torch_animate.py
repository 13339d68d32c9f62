"""Device animation of the animated fixture (piet_tpu_torch/scene/animate.py)
against the JAX package's, and its frames against the numpy oracle.

Tolerances against JAX, on the CPU, with JAX run op by op as its own
module runs outside a jit: ``torch.sin``/``torch.cos`` and ``jnp.sin``/
``jnp.cos`` differ by at most 1 ulp, and a vertex is an orbit centre plus
one trig product plus another, so points may differ by up to 2 ulp; the
quantized bboxes by one pixel where a floor or ceil sits within those ulps
of an integer, and the alpha code likewise by one.  Everything that does
not go through trig -- topology, the staged fields, the colour bits above
alpha -- is compared bitwise.  (Under ``jax.jit`` XLA:CPU fuses the trig
into its vertex loop and the points move by up to 12 ulp from the eager
result; the port follows the eager semantics.)

The exactness contract is the JAX package's (tests/test_animate.py): the
frame rendered from the device-computed arrays equals the numpy oracle fed
those arrays, bitwise.
"""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.renderer.renderer import prepare_scene as jax_prepare  # noqa
from piet_tpu.scene import animate as janimate  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    device_scene_from_numpy, fetch_scene, prepare_scene)
from piet_tpu_torch.scene import animate  # noqa: E402
from piet_tpu_torch.scene.color import decode_color_linear  # noqa: E402
from piet_tpu_torch.scene.fixtures import make_animated_frame  # noqa: E402

SIZE, N, SEED = 256, 24, 5


def _cfg(tmpl):
    return fit_capacities(tmpl, RenderConfig(
        width=SIZE, height=SIZE, tile_height=16, tile_width=128),
        bucket=True)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_host_params_match_jax():
    got = animate.host_params(size=SIZE, n=N, seed=SEED, device="cpu")
    want = janimate.host_params(size=SIZE, n=N, seed=SEED)
    for f in ("centers", "radii", "phases", "speed", "half_width",
              "slot_item", "slot_vert"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.color_hi.numpy().view(np.uint32),
                                  np.asarray(want.color_hi))
    assert got.n_live_points == want.n_live_points


@pytest.mark.parametrize("t", [0.0, 0.7, 2.9])
def test_device_scene_matches_jax(t):
    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    cfg = _cfg(tmpl)
    jbase = jax_prepare(tmpl, cfg, seg_pre=False)
    want = janimate.animate_device_scene(
        jbase, janimate.host_params(size=SIZE, n=N, seed=SEED),
        jnp.float32(t))
    base = device_scene_from_numpy(jax.tree.map(np.asarray, jbase), "cpu")
    got = animate.animate_device_scene(
        base, animate.host_params(size=SIZE, n=N, seed=SEED, device="cpu"),
        t)
    assert got.seg_pre is None
    assert _ulps(got.points.numpy(), want.points).max() <= 2
    assert np.abs(got.bboxes.numpy() - np.asarray(want.bboxes)).max() <= 1
    gc = got.colors_u32.numpy().view(np.uint32)
    wc = np.asarray(want.colors_u32)
    np.testing.assert_array_equal(gc >> 8, wc >> 8)
    assert np.abs((gc & 0xFF).astype(int) - (wc & 0xFF).astype(int)).max() \
        <= 1
    # The linear alpha is the code / 255, as the oracle decodes it.
    np.testing.assert_array_equal(
        got.colors_lin[:, 3].numpy(),
        (gc & 0xFF).astype(np.float32) / np.float32(255.0))
    for f in ("tags", "widths", "pt_offset", "n_pts", "flags", "clips",
              "grads"):
        np.testing.assert_array_equal(
            np.ascontiguousarray(getattr(got, f).numpy()).view(np.uint32),
            np.ascontiguousarray(np.asarray(getattr(want, f))).view(
                np.uint32), f)


def test_alpha_linear_matches_host_decode():
    codes = np.arange(256, dtype=np.uint32)
    want = decode_color_linear(codes)[:, 3]
    got = animate.alpha_linear(torch.from_numpy(codes.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_device_frame_tracks_host_fixture():
    """The device frame's geometry against the host-built fixture at the
    same t (trig through torch vs libm)."""
    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    cfg = _cfg(tmpl)
    base = prepare_scene(tmpl, cfg, "cpu", seg_pre=False)
    params = animate.host_params(size=SIZE, n=N, seed=SEED, device="cpu")
    dev = animate.animate_device_scene(base, params, 1.3)
    host = make_animated_frame(1.3, size=SIZE, n=N, seed=SEED)
    np.testing.assert_allclose(dev.points[:tmpl.n_points].numpy(),
                               host.points, rtol=2e-5, atol=2e-3)
    assert (np.abs(dev.bboxes[:N].numpy() - host.bboxes) <= 1).all()


@pytest.mark.parametrize("t", [0.7, 2.2])
def test_frame_bitwise_equals_oracle(t):
    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    cfg = _cfg(tmpl)
    render_t, got_tmpl = animate.make_animated_render_fn(
        cfg, size=SIZE, n=N, seed=SEED, device="cpu", fine_impl="entries")
    assert got_tmpl.n_items == tmpl.n_items
    img, stats = render_t(t)
    assert int(stats["seg_overflow"]) == int(stats["hit_overflow"]) == 0
    got = img.numpy().view(np.uint8).reshape(SIZE, SIZE, 4)
    frame = fetch_scene(render_t.scene_at(t), tmpl.n_items, tmpl.n_points)
    np.testing.assert_array_equal(got, cpu_render_scene(frame, cfg))


def test_frames_deterministic_and_moving():
    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    render_t, _ = animate.make_animated_render_fn(
        _cfg(tmpl), size=SIZE, n=N, seed=SEED, device="cpu",
        fine_impl="entries")
    a1, _ = render_t(2.2)
    a2, _ = render_t(torch.tensor(2.2))
    b, _ = render_t(2.3)
    assert torch.equal(a1, a2)
    assert not torch.equal(a1, b)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    with pytest.raises(RuntimeError, match="CUDA"):
        animate.make_animated_render_fn(_cfg(tmpl), size=SIZE, n=N,
                                        seed=SEED)
