"""The port's command line (piet_tpu_torch/cli.py) on the CPU (``--cpu``),
against the JAX package's (piet_tpu/cli.py) and the numpy oracle.

The port's images are held against the oracle bit for bit.  Against the
JAX command's PNG the comparison is ``tests/_imgcmp.py``'s
``assert_images_match``: at most 2 codes on at most ``CPU_FMA_FRAC``
(0.1%) of pixels, the documented effect of XLA:CPU's FMA contraction on
JAX's side; the port's CPU path rounds as the oracle does."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from _imgcmp import assert_images_match
from piet_tpu.cli import main as jmain
from piet_tpu_torch.cli import FINE_IMPL_NAMES, main
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene
from piet_tpu_torch.renderer.capacity import fit_capacities
from piet_tpu_torch.renderer.renderer import fetch_scene
from piet_tpu_torch.scene import animate
from piet_tpu_torch.scene.fixtures import make_animated_frame, make_path_test
from piet_tpu_torch.utils.png import read_png

torch.set_num_threads(1)


def _out(fn, argv):
    """(exit code, stdout) of ``fn(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _oracle(scene, w, h):
    cfg = fit_capacities(scene, RenderConfig(width=w, height=h), bucket=True)
    return cpu_render_scene(scene, cfg)


RENDER = ["render", "--scene", "path_test", "--width", "320", "--height",
          "832"]


def test_render_save_and_load_give_the_oracle_s_png(tmp_path):
    out, npz = str(tmp_path / "t.png"), str(tmp_path / "t.npz")
    assert main(["--cpu"] + RENDER + ["--out", out, "--save-scene", npz]) == 0
    img = read_png(out)
    assert img.shape == (832, 320, 4) and os.path.exists(npz)
    np.testing.assert_array_equal(img, _oracle(make_path_test(), 320, 832))
    out2 = str(tmp_path / "t2.png")
    assert main(["--cpu", "render", "--load", npz, "--width", "320",
                 "--height", "832", "--out", out2]) == 0
    np.testing.assert_array_equal(read_png(out2), img)


def test_render_equals_jax_s_cli(tmp_path):
    """The same arguments, ``--fine-impl xla`` (the port's dense route)."""
    args = RENDER + ["--fine-impl", "xla"]
    ours, theirs = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    assert main(["--cpu"] + args + ["--out", ours]) == 0
    assert jmain(args + ["--out", theirs]) == 0
    img = read_png(ours)
    np.testing.assert_array_equal(img, _oracle(make_path_test(), 320, 832))
    assert_images_match(img, read_png(theirs), "port vs JAX cli render")


def _frames(outdir, n):
    return [read_png(os.path.join(outdir, f"frame_{i:04d}.png"))
            for i in range(n)]


@pytest.mark.parametrize("mode", ["device", "host-encode"])
def test_animate_frames_differ_and_equal_the_oracle(tmp_path, mode):
    """3 frames at 256^2: the device animation (each frame held against
    the oracle on that frame's own arrays, as computed on the device) or
    the host encode (make_animated_frame(t))."""
    outdir = str(tmp_path / "frames")
    argv = ["--cpu", "animate", "--scene", "animated", "--frames", "3",
            "--chunk", "2", "--width", "256", "--height", "256",
            "--outdir", outdir]
    rc, text = _out(main, argv + (["--host-encode"] if mode != "device"
                                  else []))
    assert rc == 0
    card, result = text.strip().splitlines()[-2:]
    assert card == "cpu" and json.loads(result)["frames"] == 3
    imgs = _frames(outdir, 3)
    assert all(im.shape == (256, 256, 4) for im in imgs)
    assert not np.array_equal(imgs[0], imgs[2])
    dt = 1.0 / 60.0
    if mode == "device":
        tmpl = animate.template_scene()
        cfg = fit_capacities(tmpl, RenderConfig(width=256, height=256),
                             bucket=True)
        render_t, _ = animate.make_animated_render_fn(cfg, device="cpu")
        scenes = [fetch_scene(render_t.scene_at(i * dt), tmpl.n_items,
                              tmpl.n_points) for i in range(3)]
    else:
        scenes = [make_animated_frame(i * dt) for i in range(3)]
    for i, (img, scene) in enumerate(zip(imgs, scenes)):
        np.testing.assert_array_equal(img, _oracle(scene, 256, 256),
                                      err_msg=f"frame {i}")


def test_dump_equals_jax_s():
    argv = ["dump", "--scene", "path_test"]
    rc, ours = _out(main, ["--cpu"] + argv)
    jrc, theirs = _out(jmain, argv)
    assert rc == jrc == 0
    assert ours == theirs and "group header" in ours


def test_info():
    rc, text = _out(main, ["--cpu", "info"])
    assert rc == 0
    assert "torch:" in text and "native C++ library: available" in text


def test_without_cpu_and_without_a_card_the_command_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(RENDER + ["--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_fine_impl_names_cover_jax_s():
    """Every --fine-impl of the JAX command line is accepted, as a name
    of one of the port's two routes."""
    assert {"auto", "pallas", "xla"} <= set(FINE_IMPL_NAMES)
    assert set(FINE_IMPL_NAMES.values()) == {"auto", "entries", "dense"}


def test_entry_returns_the_flagship_step():
    """entry(device): the tiger at 1664^2 in 32x128 tiles, capacities
    fitted, staged on the device, and its frame step."""
    from piet_tpu_torch.entry import entry
    from piet_tpu_torch.renderer.renderer import RenderFn
    from piet_tpu_torch.scene.svg import make_tiger
    fn, (dev,) = entry(device="cpu")
    want = fit_capacities(make_tiger(), RenderConfig(
        width=1664, height=1664, tile_height=32, tile_width=128),
        bucket=True)
    assert isinstance(fn, RenderFn) and fn.config == want
    assert dev.tags.device.type == "cpu" and dev.seg_pre is not None
    assert dev.tags.shape[0] == want.max_items
