"""``python -m piet_tpu_torch.bench --cpu``: the JAX script's off-device
configuration (the 2.56x tiger at 512^2) on the CPU, FRAMES = SAMPLES =
1.  Its headline line has the keys of ``bench.py:200-216``'s dict
literal (read with ``ast``; no roofline off the card, as there), the
frame is the numpy oracle's bit for bit, and the run exits 0.  A file of
its own: the eager 512^2 tiger takes ~15 s a frame here."""

import ast
import contextlib
import io
import json
from pathlib import Path

import numpy as np
import torch

from piet_tpu_torch import bench
from piet_tpu_torch.raster.cpu_fine import cpu_render_scene

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _jax_headline_keys() -> set:
    tree = ast.parse((ROOT / "bench.py").read_text())
    return next({ast.literal_eval(k) for k in node.value.keys}
                for node in ast.walk(tree)
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "out"
                and isinstance(node.value, ast.Dict))


def test_cpu_fallback_headline(monkeypatch):
    monkeypatch.setattr(bench, "FRAMES", 1)
    monkeypatch.setattr(bench, "SAMPLES", 1)
    rec = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--cpu"], record=rec)
    lines = buf.getvalue().splitlines()
    assert rc == 0
    assert lines[0] == "cpu" and len(lines) == 2
    out = json.loads(lines[-1])
    assert set(out) == _jax_headline_keys()
    assert out["metric"] == "tiger_512_ms_per_frame_cpu_fallback"
    assert out["vs_baseline"] is None and out["backend"] == "cpu"
    assert out["viewport"] == "512x512" and out["configs"] == {}
    assert (out["frames"], out["samples"]) == (1, 1)
    r = rec["tiger_512_cpu_fallback"]
    assert out["n_segments"] > 0 and out["max_tile_cmds"] > 0
    assert out["max_tile_cmds"] <= r["config"].cmd_capacity
    np.testing.assert_array_equal(r["image"],
                                  cpu_render_scene(r["scene"], r["config"]))
