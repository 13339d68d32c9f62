"""The port's compiled frame steps (piet_tpu_torch/renderer/renderer.py::
make_render_fn, make_render_sequence_fn, make_time_render_fn) on the CPU,
against the JAX package's make_render_fn / make_render_sequence_fn and
the numpy oracle, on the same staged inputs.

On the CPU a step runs eagerly (a CUDA device replays a captured graph;
tests/test_torch_kernels.py holds the replays against the eager frames on
the card).  Tolerances: the port's images bitwise equal to the oracle;
JAX-on-CPU's within tests/_imgcmp.py's documented <= 2 codes on <= 0.1%
of pixels (XLA:CPU contracts multiply-adds); stats equal exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from _imgcmp import assert_images_match  # noqa: E402
from piet_tpu.renderer import renderer as jax_renderer  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import (  # noqa: E402
    Renderer, SceneCapacityError, device_scene_from_numpy, make_render_fn,
    make_render_sequence_fn, prepare_scene, stack_scenes)
from piet_tpu_torch.scene import affine, fixtures  # noqa: E402

SIZE = 256
#: (port route, JAX route): the dense route is JAX's "xla", the entries
#: route its "pallas" (run in interpret mode on the CPU).
ROUTES = [("dense", "xla"), ("entries", "pallas")]


def _rgba(img: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(img.numpy()).view(np.uint8).reshape(
        *img.shape, 4)


def _jax_rgba(img) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(img)).view(np.uint8).reshape(
        *np.asarray(img).shape, 4)


def _frames(n=3, seed=3):
    return [fixtures.make_animated_frame(t / 10.0, size=SIZE, n=20,
                                         seed=seed) for t in range(n)]


def _cfg(scene):
    return fit_capacities(scene, RenderConfig(
        width=SIZE, height=SIZE, tile_height=16, tile_width=128),
        bucket=True)


def _assert_stats_equal(got, want, frame=None):
    """Every stat of the port's step equals JAX's (a (1,) array, or one
    element per frame of a sequence)."""
    assert set(got) <= set(want), set(got) - set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        w = w.reshape(-1) if frame is None else w[frame].reshape(-1)
        assert int(v) == int(w[0]), k


@pytest.mark.parametrize("impl,jimpl", ROUTES, ids=[r[0] for r in ROUTES])
@pytest.mark.parametrize("name", ["gradients", "animated seed 3"])
def test_render_fn_matches_jax_and_oracle(name, impl, jimpl):
    scene = (fixtures.get_scene("gradients") if name == "gradients"
             else _frames(1)[0])
    cfg = _cfg(scene)
    jdev = jax_renderer.prepare_scene(scene, cfg)
    want_img, want_stats = jax_renderer.make_render_fn(
        cfg, interpret=True, fine_impl=jimpl)(jdev)
    render = make_render_fn(cfg, device="cpu", fine_impl=impl)
    img, stats = render(device_scene_from_numpy(
        jax.tree.map(np.asarray, jdev), "cpu"))
    assert img.shape == (SIZE, SIZE) and img.dtype == torch.int32
    assert all(v.shape == () for v in stats.values())
    got = _rgba(img)
    np.testing.assert_array_equal(got, cpu_render_scene(scene, cfg))
    assert_images_match(got, _jax_rgba(want_img), err_msg=name)
    _assert_stats_equal(stats, want_stats)
    assert render.n_graphs() == 1


@pytest.mark.parametrize("impl", ["entries", "dense"])
def test_render_fn_outputs_are_fresh_and_inputs_static(impl):
    """A returned frame does not change on the next call; the step's static
    inputs are staged once and reused, with no copy when the caller hands
    them back; a scene without seg_pre is a second signature."""
    a, b = _frames(2)
    cfg = _cfg(a)
    render = make_render_fn(cfg, device="cpu", fine_impl=impl)
    img_a, stats_a = render(prepare_scene(a, cfg, "cpu"))
    keep = img_a.clone(), {k: int(v) for k, v in stats_a.items()}
    staged = render.stage(prepare_scene(b, cfg, "cpu"))
    ptrs = [staged.points.data_ptr(), staged.seg_pre.seg_rows.data_ptr()]
    img_b, _ = render(staged)
    assert torch.equal(img_a, keep[0])
    assert {k: int(v) for k, v in stats_a.items()} == keep[1]
    assert not torch.equal(img_a, img_b)
    again = render.stage(prepare_scene(a, cfg, "cpu"))
    assert again is staged
    assert [again.points.data_ptr(),
            again.seg_pre.seg_rows.data_ptr()] == ptrs
    assert torch.equal(render(again)[0], keep[0])
    assert render.n_graphs() == 1
    derived, _ = render(prepare_scene(a, cfg, "cpu", seg_pre=False))
    assert torch.equal(derived, keep[0])
    assert render.n_graphs() == 2


def test_auto_is_the_dense_route():
    """"auto" resolves as JAX's does off a TPU ("xla", the port's
    "dense"), and is every entry point's default."""
    import inspect

    from piet_tpu_torch import profiling
    from piet_tpu_torch.renderer import renderer as port
    from piet_tpu_torch.renderer.resize import ResizableRenderer
    from piet_tpu_torch.scene import animate
    names = {"xla": "dense", "pallas": "entries"}
    assert port.resolve_fine_impl("auto") == names[
        jax_renderer._resolve_fine_impl("auto")] == "dense"
    for fn in (port.make_render_fn, port.make_render_sequence_fn,
               port.make_time_render_fn, Renderer, Renderer.for_scene,
               ResizableRenderer, ResizableRenderer.for_scene,
               affine.make_affine_render_fn, animate.make_animated_render_fn,
               profiling.profile_render):
        assert inspect.signature(fn).parameters[
            "fine_impl"].default == "auto", fn
    scene = _frames(1)[0]
    cfg = _cfg(scene)
    dev = prepare_scene(scene, cfg, "cpu")
    auto, stats = make_render_fn(cfg, device="cpu", fine_impl="auto")(dev)
    dense, _ = make_render_fn(cfg, device="cpu", fine_impl="dense")(dev)
    default, _ = make_render_fn(cfg, device="cpu")(dev)
    assert torch.equal(auto, dense) and torch.equal(default, dense)
    assert "live_cmds" in stats and "live_entries" not in stats
    assert Renderer(cfg, device="cpu", fine_impl="auto").fine_impl == \
        "dense"
    assert Renderer(cfg, device="cpu").fine_impl == "dense"
    with pytest.raises(ValueError, match="fine_impl"):
        make_render_fn(cfg, device="cpu", fine_impl="pallas")


@pytest.mark.parametrize("impl,jimpl", ROUTES[:1], ids=["dense"])
def test_sequence_fn_matches_frames_and_jax(impl, jimpl):
    """Three frames in one sequence step equal three single-frame steps,
    the oracle, and JAX's one lax.map dispatch (images within the CPU
    policy, stats per frame exactly)."""
    scenes = _frames(3)
    cfg = _cfg(scenes[0])
    want_imgs, want_stats = jax_renderer.make_render_sequence_fn(
        cfg, fine_impl=jimpl)(jax_renderer.stack_scenes(scenes, cfg))
    seq = make_render_sequence_fn(cfg, device="cpu", fine_impl=impl)
    imgs, stats = seq(stack_scenes(scenes, cfg, "cpu"))
    assert imgs.shape == (3, SIZE, SIZE)
    assert all(v.shape == (3,) for v in stats.values())
    one = make_render_fn(cfg, device="cpu", fine_impl=impl)
    for i, s in enumerate(scenes):
        img, st = one(prepare_scene(s, cfg, "cpu"))
        assert torch.equal(imgs[i], img), i
        assert {k: int(v[i]) for k, v in stats.items()} == {
            k: int(v) for k, v in st.items()}, i
        np.testing.assert_array_equal(_rgba(imgs[i]),
                                      cpu_render_scene(s, cfg))
        assert_images_match(_rgba(imgs[i]), _jax_rgba(want_imgs[i]),
                            err_msg=f"frame {i}")
        _assert_stats_equal({k: v[i] for k, v in stats.items()}, want_stats,
                            frame=i)
    assert seq.n_graphs() == 1


@pytest.mark.parametrize("impl", ["entries", "dense"])
def test_render_sequence_matches_render_and_checks_capacity(impl):
    """Renderer.render_sequence (one sequence step) equals render() frame
    by frame; a frame past a record capacity raises, as JAX's does
    (tests/test_renderer.py::test_render_sequence_checks_capacity)."""
    scenes = _frames(3)
    cfg = _cfg(scenes[0])
    r = Renderer(cfg, device="cpu", fine_impl=impl)
    seq = r.render_sequence(scenes)
    assert seq.shape == (3, SIZE, SIZE, 4)
    assert all(len(v) == 3 for v in r.last_stats.values())
    for i, s in enumerate(scenes):
        np.testing.assert_array_equal(seq[i], r.render(s))
    small = dataclasses.replace(cfg, max_segments=16)
    with pytest.raises(SceneCapacityError, match="seg_overflow"):
        Renderer(small, device="cpu", fine_impl=impl).render_sequence(
            scenes[:2])


@pytest.mark.parametrize("impl", ["entries", "dense"])
def test_render_updated_equals_fresh_render(impl):
    """render_updated copies the dirty fields (and the rebuilt segment
    stage) into the step's static inputs: the frame equals a fresh
    render of the updated scene, and the staged tensors stay in place."""
    scene = _frames(1)[0]
    cfg = _cfg(scene)
    r = Renderer(cfg, device="cpu", fine_impl=impl)
    r.render_u32(scene)
    ptr = r._staged.points.data_ptr()
    colors = scene.colors.copy()
    colors[::3] ^= np.uint32(0x00FF0000)
    moved = dataclasses.replace(scene, points=scene.points + 2.0,
                                bboxes=scene.bboxes + 2, colors=colors,
                                widths=scene.widths * np.float32(0.5))
    got = r.render_updated(moved, fields=("points", "bboxes", "colors",
                                          "widths"))
    assert r._staged.points.data_ptr() == ptr
    fresh = Renderer(cfg, device="cpu", fine_impl=impl)
    assert torch.equal(got, fresh.render_u32(moved))
    np.testing.assert_array_equal(r._rgba8(got),
                                  cpu_render_scene(moved, cfg))
    assert r._render.n_graphs() == 1
    with pytest.raises(ValueError, match="restageable"):
        r.render_updated(moved, fields=("tags",))


@pytest.mark.parametrize("impl", ["entries", "dense"])
def test_packed_step_equals_render(impl):
    """packed_render_fn unpacks inside the step; one signature for any
    number of frames."""
    a, b = _frames(2)
    cfg = _cfg(a)
    r = Renderer(cfg, device="cpu", fine_impl=impl)
    for s in (a, b):
        assert torch.equal(r.render_packed_u32(s), r.render_u32(s))
    assert r.packed_render_fn().n_graphs() == 1


@pytest.mark.parametrize("t", [0.5, torch.tensor(1.25)])
def test_time_step_equals_eager_frame(t):
    """make_affine_render_fn's one-step frame equals the eager frame of
    its scene_at(t) and the oracle; t is written into the step's static
    0-d input."""
    scene = fixtures.get_scene("gradients", size=SIZE)
    cfg = fit_capacities(scene, RenderConfig(
        width=SIZE, height=SIZE, tile_height=16, tile_width=128),
        bucket=True)
    cfg = dataclasses.replace(cfg, max_hits=8 * cfg.max_hits,
                              max_candidates=8 * cfg.max_candidates)
    render_t = affine.make_affine_render_fn(
        cfg, scene, lambda tt: affine.rotation_about(128.0, 128.0, tt, 0.9),
        device="cpu")
    img, stats = render_t(t)
    want, want_stats = Renderer(cfg, device="cpu").render_device(
        render_t.scene_at(t))
    assert torch.equal(img, want)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in want_stats.items()}
    assert render_t(0.0)[0].shape == img.shape
    assert render_t.n_graphs() == 1
