"""The port's diagnostic tools (piet_tpu_torch/tools/: group_stats,
mesh_balance, the engine bisects, the gradient probes, dispatch_probe,
precompile_cache) on the CPU, where every kernel's plain version runs,
at sizes small enough for here; the JAX tools or the JAX pass where a
tool's output has one to match.  Every tool's ``main`` needs a card.
"""

import contextlib
import importlib
import importlib.util
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from piet_tpu.config import RenderConfig as JaxConfig  # noqa: E402
from piet_tpu.ops.coarse import coarse_rasterize as jax_coarse  # noqa: E402
from piet_tpu.renderer.renderer import (  # noqa: E402
    prepare_scene as jax_prepare)
from piet_tpu.scene.fixtures import make_gradient_demo  # noqa: E402
from piet_tpu.scene.svg import make_tiger as jax_tiger  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.ops.coarse import stream_to_jax_layout  # noqa: E402
from piet_tpu_torch.parallel.sharding import ShardedRenderer  # noqa: E402
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402
from piet_tpu_torch.tools import (dispatch_probe, eng_array_probe,  # noqa: E402
                                  eng_bisect_probe, engine_probe, engines,
                                  grad_exact_probe, grad_tile_probe,
                                  group_stats, mesh_balance)

ROOT = Path(__file__).resolve().parent.parent
#: The tools this file covers; each ``main`` raises without a card.
TOOLS = ("group_stats", "mesh_balance", "engine_probe", "eng_bisect_probe",
         "eng_array_probe", "grad_exact_probe", "grad_tile_probe",
         "dispatch_probe", "precompile_cache")


def _jax_tool(name: str):
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


def test_group_stats_lines_equal_the_jax_tools():
    """One small configuration (the 1.5x tiger at 384^2, 32x128 tiles)
    through both tools: the same lines."""
    tool = _jax_tool("group_stats")
    tool.CONFIGS["small"] = (lambda: jax_tiger(scale=1.5), 384, 384)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tool.analyze("small")
    got = group_stats.analyze(
        "small", "cpu", {"small": (lambda: make_tiger(scale=1.5), 384, 384)})
    assert got == buf.getvalue().splitlines()
    assert len(got) > 10 and got[0].startswith("== small: ")


def test_mesh_balance_slabs_add_up_to_the_one_slab_pass():
    """Two slabs (contiguous, and 2 interleaved blocks): each partition's
    live commands sum to the one-slab frame's, and the images agree
    (the tool asserts it)."""
    out = mesh_balance.balance(0.5, 2, ["cpu"] * 2)
    scene = make_tiger(scale=0.5)
    size = mesh_balance.viewport(scene, 2, 2)
    cfg = fit_capacities(scene, RenderConfig(width=size, height=size),
                         bucket=True)
    one = ShardedRenderer(cfg, ["cpu"], fine_impl="dense")
    one.render(scene)
    total = int(one.last_stats["live_cmds"].sum())
    assert total > 0
    for part in ("contiguous", "interleave2"):
        per = out[part]["live_entries_per_device"]
        assert len(per) == 2 and sum(per) == out[part]["total"] == total
    assert out["contiguous"]["live_entries_per_device"] != \
        out["interleave2"]["live_entries_per_device"]
    lines = mesh_balance.lines(out)
    assert len(lines) == 3 and '"interleave2"' in lines[1]


def test_grad_exact_probe_reports_no_pixel_off():
    n, lines = grad_exact_probe.probe("cpu")
    assert n == 0
    assert lines[1] == "[full demo] mismatched px: 0"


def test_grad_tile_entries_equal_the_jax_pass():
    """Tile (7, 0) of the gradient demo: first, count and every entry
    word of the port's pass (in the JAX block layout) equal the JAX
    pass's (eager, staged records, XLA sort)."""
    cfg = JaxConfig(**grad_exact_probe.CFG)
    out = jax_coarse(
        jax_prepare(make_gradient_demo(256), cfg), tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y, tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        cmd_capacity=cfg.cmd_capacity, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates,
        max_deltas=cfg.max_deltas, output="entries", sort_impl="xla",
        pair="off", hitfuse="off")
    stream, first, n_ent = (np.asarray(x) for x in out[:3])
    _, port = grad_tile_probe.coarse_pass("cpu")
    blocks = stream_to_jax_layout(port.stream).numpy()
    t = 7 * cfg.tiles_x
    fe, ne = int(first[t]), int(n_ent[t])
    assert (int(port.first[t]), int(port.n_entries[t])) == (fe, ne)
    assert ne > 0
    for i in range(ne):
        e = fe + i
        np.testing.assert_array_equal(
            blocks[e // 128, :, e % 128].view(np.uint32),
            stream[e // 128, :, e % 128].view(np.uint32))
    lines = grad_tile_probe.entry_lines(7, 0, "cpu")
    assert lines[0] == f"tile (7,0) t={t}: first={fe} n={ne} solid=0x0"
    assert len(lines) == ne + 1
    oracle = grad_tile_probe.oracle_lines(7, 0)
    assert oracle[0].startswith(f"oracle tile t={t}: ")


def test_engine_compare_names_a_flipped_word():
    a = {"stream": np.zeros((4, 16), np.float32),
         "first": np.arange(6, dtype=np.int32)}
    b = {k: v.copy() for k, v in a.items()}
    ok, lines = engines.compare(a, b)
    assert ok and lines == []
    b["stream"].view(np.uint32)[2, 5] ^= 1
    ok, lines = engines.compare(a, b)
    assert not ok
    assert lines[0] == ("    leaf stream: 1/64 words differ, first at "
                        "flat index 37")
    assert lines[1] == "      [37] 0x00000000 vs 0x00000001"
    assert engines.diff(a["first"], b["first"]).size == 0


def test_engine_bisect_and_probes_on_the_cpu(tmp_path):
    """engine_probe's CPU setting at a small size (leaves and taps saved),
    each kernel alone on its saved taps (the plain versions here: 0 words
    off), and the stage reports of the two bisect tools."""
    size = (0.5, 128, 128)
    engine_probe.run_child("cpu", str(tmp_path), size)
    leaves = dict(np.load(tmp_path / "cpu.npz"))
    assert set(leaves) == set(engines.LEAVES)
    taps = torch.load(tmp_path / "taps.pt", weights_only=False)
    res = engines.bisect(taps, "cpu")
    assert set(res) == set(engines.KERNELS)
    assert all(r["words_off"] == 0 and r["words"] > 0 and r["first"] is None
               for r in res.values()), res
    assert all("IDENTICAL" in line for line in engines.bisect_lines(res))

    scene, cfg = engine_probe.config(*size)
    stages, lv = eng_bisect_probe.run("cpu", "cpu", cfg=cfg, scene=scene)
    assert list(lv) == list(engines.LEAVES)
    assert next(iter(stages)) == "cand_expand[0]"
    assert eng_bisect_probe.report((stages, lv), (stages, lv)) == [
        "[cuda] first-div-stage=None leaf-mismatches=[0, 0, 0, 0, 0]"]
    flipped = dict(stages)
    k = list(stages)[3]
    flipped[k] = stages[k].clone()
    flipped[k].view(-1)[0] += 1
    assert eng_bisect_probe.first_divergence(stages, flipped) == k
    lines = eng_array_probe.report(stages, flipped)
    assert lines[3].startswith(f"{k:24s} shape=") and \
        lines[3].endswith("mismatched=1")
    assert lines[4].startswith("    at (0") and len(lines) == 5


def test_dispatch_probe_steps_run_on_the_cpu():
    scene = make_tiger(scale=0.5)
    cfg = fit_capacities(scene, RenderConfig(width=128, height=128))
    dev = torch.device("cpu")
    shapes = {n: tuple(f().shape) for n, f in
              dispatch_probe.null_probes(scene, cfg, dev).items()}
    assert shapes == {"null_12leaf": (1,), "null_1small": (1,),
                      "null_1big": (1,), "null_0in": (1,),
                      "out_1": (128,), "out_12": (12, 128), "out_0d": (),
                      "out_1d1": (1,), "out_12x0d": (12,)}
    probes = dispatch_probe.render_probes(scene, cfg, dev, chains=(2,))
    assert list(probes) == ["render", "render_img", "chain2_per_frame"]
    img = probes["render_img"][0]()
    assert tuple(img.shape) == (128, 128)
    flat = probes["chain2_per_frame"][0]()
    assert flat.shape[0] == 2 and probes["chain2_per_frame"][1] == 2
    np.testing.assert_array_equal(flat[0].numpy(),
                                  probes["render"][0]().numpy())


@pytest.mark.parametrize("name", TOOLS)
def test_main_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"piet_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
