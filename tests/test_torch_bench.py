"""The port's benchmark (piet_tpu_torch/bench.py) and its time_config tool
on the CPU, against the JAX package's root ``bench.py`` and
``tools/time_config.py``.

The JAX script is loaded from its file in the tests only (the port never
imports it); its config tables and its headline's keys are read with
``ast``.  ``FRAMES`` and ``SAMPLES`` are set to 1 on both modules, so a
config costs a few eager frames here.  The off-card headline (the 512^2
tiger, ~15 s a frame here) is tests/test_torch_bench_cpu.py's."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from piet_tpu_torch import bench
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene
from piet_tpu_torch.roofline import frame_roofline
from piet_tpu_torch.scene import fixtures as tfixtures
from piet_tpu_torch.tools import time_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def one_frame(monkeypatch):
    """FRAMES = SAMPLES = 1 on the port's bench."""
    monkeypatch.setattr(bench, "FRAMES", 1)
    monkeypatch.setattr(bench, "SAMPLES", 1)


@pytest.fixture
def jax_bench(monkeypatch, tmp_path):
    """The JAX package's root bench.py as a module, FRAMES = SAMPLES = 1
    (its compile-cache variable set here, so the test's own environment
    is restored after it)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "FRAMES", 1)
    monkeypatch.setattr(mod, "SAMPLES", 1)
    return mod


def _out(fn, argv, **kw):
    """(exit code, stdout lines) of ``fn(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv, **kw)
    return rc, buf.getvalue().splitlines()


def _function(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _table(node) -> dict:
    """name -> (maker's body as source, width, height) from a list of
    (name, lambda, w, h) tuples or a dict of name -> (lambda, w, h)."""
    if isinstance(node, ast.Dict):
        rows = [(k, *v.elts) for k, v in zip(node.keys, node.values)]
    else:
        rows = [t.elts for t in (node.elts if isinstance(node, ast.List)
                                 else [node])]
    return {ast.literal_eval(n): (ast.unparse(m.body), ast.literal_eval(w),
                                  ast.literal_eval(h))
            for n, m, w, h in rows}


def _jax_bench_tables():
    """The JAX main's on-device configs, headline and off-device headline
    (``bench.py:156-173``), and its headline dict's keys."""
    fn = _function(ROOT / "bench.py", "main")
    assigns = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            assigns.setdefault(node.targets[0].id, []).append(node.value)
    keys = next(set(map(ast.literal_eval, v.keys)) for v in assigns["out"]
                if isinstance(v, ast.Dict))
    configs, cpu_configs = assigns["configs"]
    head, cpu_head = assigns["headline"]
    assert _table(cpu_configs) == {}
    return _table(configs), _table(head), _table(cpu_head), keys


def _port_tables():
    tree = ast.parse((ROOT / "piet_tpu_torch" / "bench.py").read_text())
    return {t.id: node.value for node in tree.body
            if isinstance(node, (ast.Assign, ast.AnnAssign))
            for t in ([node.target] if isinstance(node, ast.AnnAssign)
                      else node.targets)}


def test_config_tables_are_the_jax_scripts():
    """Names, viewports and scene makers of the port's tables against
    ``bench.py:156-173`` and ``tools/time_config.py:29-40``."""
    configs, head, cpu_head, _ = _jax_bench_tables()
    port = _port_tables()
    assert _table(port["CONFIGS"]) == configs
    assert list(_table(port["CONFIGS"])) == list(configs)
    assert _table(port["HEADLINE"]) == head
    assert _table(port["CPU_HEADLINE"]) == cpu_head
    assert _table(port["CPU_CONFIGS"]) == {}
    # The runtime tables are the parsed ones.
    assert [(n, w, h) for n, _, w, h in bench.CONFIGS] == [
        (n, w, h) for n, (_, w, h) in configs.items()]
    tc = _function(ROOT / "tools" / "time_config.py", "main")
    jtable = next(_table(n.value) for n in ast.walk(tc)
                  if isinstance(n, ast.Assign)
                  and n.targets[0].id == "configs")
    assert list(time_config.TABLE) == list(jtable)
    both = {**configs, **head}
    assert {n: (w, h) for n, (_, w, h) in time_config.TABLE.items()} == {
        n: (w, h) for n, (_, w, h) in jtable.items()}
    assert {n: m for n, (m, _, _) in jtable.items()} == {
        n: m for n, (m, _, _) in both.items()}


@pytest.mark.parametrize("fixture,size", [("path_test", 128),
                                          ("clip_star", 256)])
def test_bench_config_equals_the_jax_scripts(fixture, size, one_frame,
                                             jax_bench):
    """The same fit, the same counts: every RenderConfig field, and the
    frame's n_segments and max_tile_cmds exactly."""
    from piet_tpu.scene import fixtures as jfixtures
    ms, cfg, stats = bench.bench_config(
        fixture, tfixtures.get_scene(fixture), size, size, device="cpu")
    jms, jcfg, jstats = jax_bench._bench_config(
        fixture, jfixtures.get_scene(fixture), size, size)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert stats["n_segments"] == int(np.asarray(jstats["n_segments"]).sum())
    assert stats["max_tile_cmds"] == int(
        np.asarray(jstats["max_tile_cmds"]).max())
    assert np.isfinite(ms) and ms > 0


def test_record_holds_the_oracle_s_frame(one_frame):
    scene = tfixtures.get_scene("clip_star")
    rec = {}
    _, cfg, stats = bench.bench_config("clip_star", scene, 256, 256,
                                       device="cpu", fine_impl="entries",
                                       record=rec)
    assert rec["config"] == cfg and rec["scene"] is scene
    np.testing.assert_array_equal(rec["image"], cpu_render_scene(scene, cfg))
    assert stats["live_entries"] > 0


def test_failed_config_prints_an_error_and_the_headline(one_frame,
                                                        monkeypatch):
    """A config whose scene maker raises: its error line, the headline
    still printed last, and exit 1."""
    def boom():
        raise ValueError("no scene")

    monkeypatch.setattr(bench, "CPU_CONFIGS", [
        ("boom", boom, 64, 64),
        ("path_test", lambda: tfixtures.get_scene("path_test"), 128, 128)])
    monkeypatch.setattr(bench, "CPU_HEADLINE", (
        "clip_star", lambda: tfixtures.get_scene("clip_star"), 256, 256))
    rc, lines = _out(bench.main, ["--cpu"])
    assert rc == 1
    assert lines[0] == "cpu"
    err, ok, head = map(json.loads, lines[1:])
    assert err == {"config": "boom", "error": "ValueError: no scene"}
    assert set(ok) == {"config", "ms_per_frame", "viewport"}
    assert ok["viewport"] == "128x128"
    assert head["metric"] == "clip_star_ms_per_frame"
    assert head["configs"] == {"boom": None,
                               "path_test": ok["ms_per_frame"]}


def test_no_card_raises_check_device_s_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        time_config.main([])


def test_roofline_split_times_the_benched_route(one_frame):
    """The headline's roofline: frame_roofline's stages, the measured
    total the frame's, the coarse and fine times measured."""
    scene = tfixtures.get_scene("clip_star")
    for impl in ("auto", "entries"):
        ms, cfg, stats = bench.bench_config("clip_star", scene, 256, 256,
                                            device="cpu", fine_impl=impl)
        roof = bench.roofline_split(scene, cfg, stats, ms, device="cpu",
                                    fine_impl=impl)
        model = frame_roofline(stats, cfg, None, None, ms)
        assert set(roof) == set(model) == {"fine", "coarse", "frame"}
        assert roof["frame"] == model["frame"]
        for stage in ("fine", "coarse"):
            assert roof[stage]["measured_ms"] > 0
            assert {k: roof[stage][k] for k in model[stage]} == model[stage]


def test_time_config_prints_its_json(one_frame, monkeypatch):
    """``tools/time_config.py``'s line: config, ms_per_frame, viewport and
    the PIET_* variables set."""
    monkeypatch.setenv("PIET_PAIR", "off")
    rc, lines = _out(time_config.main,
                     ["--cpu", "animated_clips", "--fine-impl", "entries"])
    assert rc == 0 and lines[0] == "cpu"
    out = json.loads(lines[-1])
    assert set(out) == {"config", "ms_per_frame", "viewport", "env"}
    assert out["config"] == "animated_clips"
    assert out["viewport"] == "1024x1024"
    assert out["ms_per_frame"] > 0
    assert out["env"]["PIET_PAIR"] == "off"
