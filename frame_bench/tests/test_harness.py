"""The harness on the CPU: loading by name, the contract's form, the exit
without a card, the metric arithmetic on a synthetic trace and the tail."""

import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from frame_bench import check, loop, run, spec, workload
from frame_bench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_cells_configs_traffic_and_metrics_load_by_name():
    for w in BENCH["workloads"]:
        c = spec.cell(BENCH, w["name"])
        assert c["config"]["name"] == w["config"]
        assert issubclass(workload.entry_class(c["traffic"]["entry"]),
                          workload.Workload)
        assert callable(spec.find_module(
            "scenes", c["config"]["scene"]["kind"]).make)
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"]
    for m in BENCH["per_layer"]:
        mod = spec.metric_module(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == \
            (m["unit"], m["layer"], m["source"], m["moves"])
    for c in BENCH["configs"]:
        assert spec.load_config(c["name"])["reduced"] == c["reduced"]
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("stem", ["", "a.b", "../x", "a-b", "1x", "a b"])
def test_modules_are_found_only_by_a_plain_name(stem):
    with pytest.raises(ValueError):
        spec.find_module("entries", stem)


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w[k] for w in BENCH["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    for n in names:
        spec.check_name(n)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        spec.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(set(names[:len(BENCH["configs"])])) == len(BENCH["configs"])
    with pytest.raises(ValueError):
        spec.check_name("bad name")
    with pytest.raises(ValueError):
        spec.check_unit("ms per frame")


def test_benchmark_keys_follow_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            # Each cell that reads the metric reports what it moves.
            assert m["moves"] in {e["name"] for e in
                                  spec.cell(BENCH, w)["end_to_end"]}
    for w in BENCH["workloads"]:
        c = spec.cell(BENCH, w["name"])
        assert {e["name"].split(".")[0] for e in c["end_to_end"]} == \
            {"frame_ms", "frame_p95_ms", "setup_s"}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "frame_bench.run",
                        "--workload", "tiger_4k.replay", "--seed",
                        str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_stop_children_stops_and_waits_for_a_leftover():
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        assert child.pid in run.child_pids()
        left = run.stop_children(grace_s=5.0)
        assert any("time.sleep(60)" in c for c in left)
        assert child.pid not in run.child_pids()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def _fake_result(trace):
    res = {"correct": True, "attempted": 10, "failed": 0,
           "metrics": {"frame_ms": {"value": 1.5, "unit": "ms"}},
           "memory_peak_bytes": 123, "power_limit_w": 700.0,
           "checks": {"pose0.pixels_off": {"value": 0, "limit": 0}}}
    if trace:
        res.update(busy_s=0.5, window_s=0.7,
                   breakdown={"device_ops": [["k", 0.1]],
                              "idle_gaps": [["cudaGraphLaunch", 0.2]]})
    return res


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_is_built_in_the_contract_form(monkeypatch, trace):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: _fake_result(trace))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "tiger_4k.replay", "--seed",
                       str(2**31 + 9), "--seconds", "1", "--trace",
                       str(trace)])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == "NVIDIA H100 80GB HBM3"
    assert dev["memory_peak_bytes"] == 123 and dev["power_limit_w"] == 700.0
    if trace:
        assert dev["busy_s"] == 0.5 and dev["window_s"] == 0.7
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert err.getvalue().strip().splitlines()[-1] == \
        "check pose0.pixels_off 0 limit 0"


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: _fake_result(0))
    monkeypatch.setitem(sys.modules, "jax", object())
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "tiger_4k.replay", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    assert "piet_tpu" not in run.forbidden_modules()


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_share_and_device_ms_on_a_synthetic_trace():
    # Two frames of 1000 us; device work 0-300 (fine 100-300) and 250-900
    # overlapping, then 1200-1700; one copy 1700-1800.  Idle: 900-1200
    # (its middle in the second frame's graph launch) and 1800-2000.
    events = [
        _ev("frame_bench.frame", "user_annotation", 0, 1000),
        _ev("frame_bench.frame", "user_annotation", 1000, 1000),
        _ev("cudaGraphLaunch", "cuda_runtime", 0, 50),
        _ev("cudaGraphLaunch", "cuda_runtime", 1000, 150),
        _ev("coarse_a", "kernel", 0, 100),
        _ev("void (anonymous namespace)::fine_dense_kernel<true, 8>(int)",
            "kernel", 100, 200),
        _ev("coarse_b", "kernel", 250, 650),
        _ev("coarse_c", "kernel", 1200, 500),
        _ev("Memcpy DtoH", "gpu_memcpy", 1700, 100),
        _ev("outside", "kernel", 5000, 100),
    ]
    r = tr.reduce(events)
    assert r["frames"] == 2
    assert r["window_s"] == pytest.approx(2000e-6)
    assert r["busy_s"] == pytest.approx((900 + 600) * 1e-6)
    labels = dict(tr.top(r["gaps"]))
    assert labels == pytest.approx({"cudaGraphLaunch": 300e-6,
                                    "frame_bench.frame": 200e-6})
    ctx = dict(r, host_call_s=[1e-4, 3e-4], untraced_frame_s=1000e-6,
               ptcl=None, peaks=None)
    read = {m["name"]: spec.metric_module(m["name"]).read(ctx)
            for m in BENCH["per_layer"]}
    assert read["device.idle_share"] == pytest.approx(25.0)
    assert read["frame_step.device_ops"] == pytest.approx(2.5)
    assert read["fine.device_ms"] == pytest.approx(0.1)
    assert read["coarse.device_ms"] == pytest.approx(0.675)
    assert read["frame_step.host_ms"] == pytest.approx(0.2)
    assert read["fine_roofline"] is None


class _Stall:
    """A fake workload: 2 ms frames, one frame of 60 ms."""

    device = torch.device("cpu")
    n_poses = 1

    def frame(self, i):
        time.sleep(0.06 if i == 7 else 0.002)
        return i

    def finish(self, out):
        return False

    def pose(self, i):
        return 0


def test_p95_is_over_every_frame_of_the_window():
    res = loop.window(_Stall(), 0.12, loop.Keeper(None))
    lat = res["latency_ms"]
    assert len(lat) == res["attempted"] == res["completed"] > 8
    assert max(lat) >= 60.0
    assert loop.p95(lat) == pytest.approx(np.percentile(lat, 95))
    # Frames of a 20-frame window with one 60 ms stall: the stall sits
    # above the 95th percentile's rank and pulls it by a twentieth of
    # its excess, where a median of chunks would not move.
    window = [2.0] * 19 + [60.0]
    assert loop.p95(window) == pytest.approx(2.0 + 0.05 * 58.0)
    assert res["window_s"] * 1e3 / res["completed"] > 2.0


def test_compared_poses_come_from_the_seed():
    assert check.compare_poses(1, 5) is None
    a = check.compare_poses(64, 2**31 + 11)
    assert a == check.compare_poses(64, 2**31 + 11)
    assert len(a) == 2 and all(0 <= p < 64 for p in a)
