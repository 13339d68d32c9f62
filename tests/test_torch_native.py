"""The port's bindings to the native cc/ library (piet_tpu_torch/native.py)
against the JAX package's (piet_tpu/native.py) and the numpy oracle:
the same bytes for the scene build, the flattener, the animated frame and
the golden rasterizer.  The port builds its own copy of the library under
build/piet_tpu_torch/, atomically, and never writes under cc/."""

import ctypes
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from piet_tpu import native as jnative
from piet_tpu.scene.fixtures import (
    make_animated_frame_native as j_native_frame)
from piet_tpu_torch import native
from piet_tpu_torch.kernels import run_all as native_run_all
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.geometry import flatten_cubics_batch
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene
from piet_tpu_torch.scene.fixtures import (make_animated_frame,
                                           make_animated_frame_native,
                                           make_path_test)
from piet_tpu_torch.scene.svg import TIGER_PATH, make_tiger
from piet_tpu_torch.scene.wire import decode_scene, encode_scene

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TIGER_SVG = open(TIGER_PATH).read()
FIELDS = ("tags", "colors", "widths", "bboxes", "pt_offset", "n_pts",
          "points", "flags", "clips", "grads")


def _jax_lib():
    """The JAX package's library.  It builds with cc/'s make; other test
    workers may be running that make on a clean tree (ROADMAP queue 3),
    so a load that finds a half-written file is retried."""
    for _ in range(60):
        if jnative.available():
            return jnative
        time.sleep(1.0)
    return jnative.load()


def test_library_lives_under_build():
    path = native.build()
    assert path.parent == ROOT / "build" / "piet_tpu_torch"
    assert path.name.startswith("libpiet_cc_") and path.suffix == ".so"
    assert b"piet-cc" in native.load().pm_version()


def test_build_is_atomic_and_never_writes_under_cc(tmp_path, monkeypatch):
    """Three builds at once into an empty directory: one library, no
    object or temporary file left behind, every compiler output inside
    that directory (none under cc/), and the library loads."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    outputs = []

    def run_all(cmds):
        outputs.extend(Path(c[c.index("-o") + 1]) for c in cmds)
        return native_run_all(cmds)

    monkeypatch.setattr(native, "run_all", run_all)
    paths, errors = [], []

    def one():
        try:
            paths.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert outputs and all(tmp_path in o.parents for o in outputs)
    assert not any(native.CC_DIR in o.parents for o in outputs)
    assert ctypes.CDLL(str(paths[0])).pm_version


def test_unavailable_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-piet")
    assert not native.available()
    with pytest.raises(native.NativeUnavailable):
        native.init_scene_from_svg(TIGER_SVG, 1.0)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("scale", [2.56, 8.0])
def test_tiger_scene_bytes_equal_jax_s_and_python(scale):
    wire = native.init_scene_from_svg(TIGER_SVG, scale)
    assert wire == _jax_lib().init_scene_from_svg(TIGER_SVG, scale)
    assert wire == encode_scene(make_tiger(scale=scale))


def test_flatten_cubics_equal_jax_s_and_python():
    rng = np.random.default_rng(42)
    cubics = rng.uniform(-100, 1700, (64, 4, 2))
    pts, counts = native.flatten_cubics(cubics, 1e-3)
    jpts, jcounts = _jax_lib().flatten_cubics(cubics, 1e-3)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(pts.view(np.uint64), jpts.view(np.uint64))
    ppts, pcounts = flatten_cubics_batch(cubics, 1e-3)
    np.testing.assert_array_equal(counts, pcounts)
    np.testing.assert_array_equal(pts, ppts)


@pytest.mark.parametrize("t", [0.0, 0.5])
def test_animated_frame_equal_jax_s_and_python(t):
    _jax_lib()
    got = make_animated_frame_native(t)
    for want in (j_native_frame(t), make_animated_frame(t)):
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(
                np.ascontiguousarray(a).view(np.uint8),
                np.ascontiguousarray(b).view(np.uint8), err_msg=f"t={t} {f}")


@pytest.mark.parametrize("case", ["tiger_256", "path_test_16x16"])
def test_render_golden_equal_jax_s_and_the_oracle(case):
    if case == "tiger_256":
        wire = native.init_scene_from_svg(TIGER_SVG, 1.28)
        kw = dict(tile_w=128, tile_h=16, cmd_capacity=512)
        size = 256
    else:
        wire = encode_scene(make_path_test())
        kw = dict(tile_w=16, tile_h=16, cmd_capacity=256)
        size = 128
    img, overflow = native.render_golden(wire, size, size, **kw)
    jimg, joverflow = _jax_lib().render_golden(wire, size, size, **kw)
    # The tiger at 256^2 overflows 512 commands in some tiles: both
    # rasterizers and the oracle drop the same ones.
    assert overflow == joverflow
    np.testing.assert_array_equal(img, jimg)
    cfg = RenderConfig(width=size, height=size, tile_width=kw["tile_w"],
                       tile_height=kw["tile_h"],
                       cmd_capacity=kw["cmd_capacity"])
    np.testing.assert_array_equal(img, cpu_render_scene(decode_scene(wire),
                                                        cfg))

