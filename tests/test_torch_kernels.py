"""The port's kernel plumbing (piet_tpu_torch/kernels.py): the dispatch
rule, the build contract and the launch counters; and, on a CUDA card
only, every kernel against its plain version at small shapes.

The CUDA tests carry the ``cuda`` marker and skip where no card is
present.  On a machine with a card and without jax (tests/conftest.py
imports jax), run them with
``python -m pytest --noconftest tests/test_torch_kernels.py -q``.
"""

import dataclasses

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

from piet_tpu.config import RenderConfig
from piet_tpu.raster.cpu_fine import cpu_render_scene
from piet_tpu.renderer.capacity import fit_capacities
from piet_tpu.renderer.segstage import build_seg_pre
from piet_tpu.scene import fixtures
from piet_tpu.scene.svg import make_tiger
from piet_tpu_torch import kernels
from piet_tpu_torch.ops import candfuse, coarse, fine, hitfuse, sort
from piet_tpu_torch.renderer.renderer import (Renderer, _solid_to_present_u32,
                                              prepare_scene, render_slab)


def test_dispatch_rule():
    cpu = torch.zeros(4)
    assert kernels.on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError):
        kernels.on_cuda(torch.zeros(4, device="meta"))


def test_build_flags_keep_ieee_rounding():
    flags = kernels.NVCC_FLAGS
    for f in ("-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "arch=compute_90a,code=sm_90a"):
        assert f in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)


def _no_cuda_toolkit(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "NVCC_FALLBACK_PATHS", ())
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.delenv("CUDA_PATH", raising=False)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler raises; nothing falls back to the CPU."""
    _no_cuda_toolkit(monkeypatch, tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    _no_cuda_toolkit(monkeypatch, tmp_path)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        kernels.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_tracks_sources_and_flags(monkeypatch):
    a = kernels.library_path()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ["-g"])
    assert kernels.library_path() != a
    assert a.parent == kernels.BUILD_DIR


def test_plain_calls_do_not_count_launches():
    kernels.reset_launches()
    scene = fixtures.get_scene("path_test")
    Renderer.for_scene(scene, 256, 256, device="cpu").render(scene)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512),
                         bucket=True)
    dev = prepare_scene(scene, cfg, "cuda")
    taps = {}
    ce = coarse.coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_width,
        tile_h=cfg.tile_height, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates, taps=taps)
    return cfg, taps, ce


def _same_bits(a, b):
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions(cuda_inputs):
    cfg, taps, ce = cuda_inputs
    ci, akw = taps["candfuse"]
    for g, w in zip(candfuse.cand_records_fused(*ci, **akw),
                    candfuse.cand_records_fused_plain(*ci, **akw)):
        assert _same_bits(g, w)
    hargs, bkw = taps["hitfuse"]
    assert _same_bits(hitfuse.hit_records_fused(*hargs, **bkw),
                      hitfuse.hit_records_fused_plain(*hargs, **bkw))
    key, val = taps["sort"]
    (gk,), gv = sort.stable_sort_multi((key,), val)
    (wk,), wv = sort.stable_sort_multi_plain((key,), val)
    assert _same_bits(gk, wk) and torch.equal(gv, wv)
    args = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
            ce.stream)
    kw = dict(tile_h=cfg.tile_height, tile_w=cfg.tile_width,
              tiles_x=cfg.tiles_x)
    assert torch.equal(fine.fine_rasterize_entries(*args, **kw),
                       fine.fine_rasterize_entries_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("row0", [0, 3, 5])
def test_cuda_slab_bitwise_equals_oracle_rows(row0):
    """The four kernels on a tile-row window [row0, row0 + 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = fixtures.get_scene("clip_star")
    r = Renderer.for_scene(scene, 256, 256, device="cuda", tile_height=32,
                           tile_width=128)
    cfg, rows = r.config, 3
    slab = dataclasses.replace(cfg, height=rows * cfg.tile_height)
    sp = build_seg_pre(scene, slab, row0=row0)
    dev = prepare_scene(scene, cfg, "cuda")._replace(seg_pre=coarse.SegPre(*(
        torch.from_numpy(np.ascontiguousarray(getattr(sp, f)).view(np.int32))
        .cuda() for f in coarse.SegPre._fields)))
    img, _ = render_slab(dev, cfg, tiles_y=rows, row0=row0)
    got = img.cpu().numpy().view(np.uint8).reshape(rows * cfg.tile_height,
                                                   -1, 4)
    y0 = row0 * cfg.tile_height
    want = cpu_render_scene(scene, cfg)[y0:y0 + rows * cfg.tile_height]
    np.testing.assert_array_equal(got[:, :cfg.width], want)


CUDA_SCENES = [
    ("tiger_1x", lambda: make_tiger(scale=1.0), 512, 32),
    ("path_test", lambda: fixtures.get_scene("path_test"), 256, 32),
    ("animated", lambda: fixtures.get_scene("animated", size=512), 512, 32),
    ("gradients", lambda: fixtures.get_scene("gradients"), 256, 16),
    ("holes", lambda: fixtures.get_scene("holes"), 256, 16),
    ("star_evenodd", lambda: fixtures.get_scene("star_evenodd"), 256, 32),
    ("clip_star", lambda: fixtures.get_scene("clip_star"), 256, 16),
    ("clipped_demo", lambda: fixtures.get_scene("clipped_demo"), 256, 32),
    ("circles_rects", lambda: fixtures.get_scene(
        "circles_rects", n_circles=200, n_rects=200, size=512), 512, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,size,th", CUDA_SCENES,
                         ids=[s[0] for s in CUDA_SCENES])
def test_cuda_render_bitwise_equals_oracle(name, make, size, th):
    """Every command class through the four kernels on the card: fills,
    strokes, circles, solids, clips, layers, gradients, winding carries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make()
    r = Renderer.for_scene(scene, size, size, device="cuda",
                           tile_height=th, tile_width=128)
    kernels.reset_launches()
    got = r.render(scene)
    assert all(v > 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    np.testing.assert_array_equal(got, cpu_render_scene(scene, r.config),
                                  err_msg=name)
