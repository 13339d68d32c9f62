"""The readers of the program's tracing tables on synthetic traces: the
stage readers (``metrics/_stages.py``) against a handmade stage map,
``staging.host_ms.rebuild`` against synthetic spans, and
``setup.capture_s``; each reads None from a program without them."""

import sys

import pytest

import piet_tpu_torch
from piet_tpu_torch import tracing

from frame_bench import spec
from frame_bench.metrics import _stages

#: The handmade map: (stage, device nodes), in capture order.
MAP = [("animate", 2), ("cand_expand", 1), ("seg_expand", 1),
       ("hit_expand", 2), ("rows", 1), ("sort", 2), ("sorted_gather", 1),
       ("tile_reduce", 3), ("fine", 2), ("present", 1)]
#: Each stage's duration of one node in frame f, in us: (f + 1) times this.
BASE_US = {"animate": 5.0, "cand_expand": 7.0, "seg_expand": 11.0,
           "hit_expand": 13.0, "rows": 17.0, "sort": 19.0,
           "sorted_gather": 23.0, "tile_reduce": 29.0, "fine": 31.0,
           "present": 37.0}
GROUPS = {name: spec.metric_module(name).STAGES for name in (
    "animation.device_ms", "coarse.binning_device_ms",
    "coarse.sort_device_ms", "coarse.tail_device_ms", "present.device_ms")}


def _frames(n, drop=()):
    """``n`` frames of records (name, start_s, dur_s) as an anim frame
    makes them: the fill of t, the replay's nodes by the map, the clone,
    the stats copy.  ``drop``: (frame, record index in its replay) the
    profiler lost."""
    recs, t = [], 0.0

    def add(name, us):
        nonlocal t
        recs.append((name, t * 1e-6, us * 1e-6))
        t += us + 1.0

    for f in range(n):
        add("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::FillFunctor<float>>", 1.0)
        j = 0
        for stage, k in MAP:
            for _ in range(k):
                if (f, j) not in drop:
                    add(f"kernel_of_{stage}", (f + 1) * BASE_US[stage])
                j += 1
        add("Memcpy DtoD (Device -> Device)", 3.0)
        add("Memcpy DtoH (Device -> Pageable)", 2.0)
        t += 100.0
    return recs


def _want_ms(stages, frames):
    """The group's ms per frame over ``frames`` (frame indices)."""
    nodes = dict(MAP)
    us = sum((f + 1) * BASE_US[s] * nodes[s] for s in stages if s in nodes
             for f in frames)
    return 1e-3 * us / len(frames)


@pytest.fixture
def tables(monkeypatch):
    monkeypatch.setattr(tracing, "GRAPHS", [[("old", 1)], list(MAP)])
    monkeypatch.setattr(tracing, "SPANS", {})
    monkeypatch.setattr(tracing, "graph_captures", 0)
    monkeypatch.setattr(tracing, "capture_s", 0.0)


def _read(name, ctx):
    return spec.metric_module(name).read(ctx)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_stage_metrics_are_exact_on_three_frames(tables, name):
    ctx = {"frames": 3, "device": _frames(3)}
    assert _read(name, ctx) == pytest.approx(
        _want_ms(GROUPS[name], range(3)), rel=1e-12)


def test_a_frame_with_a_dropped_record_is_left_out(tables):
    ctx = {"frames": 12, "device": _frames(12, drop={(5, 8)})}
    sec, aligned = _stages.stage_seconds(ctx["device"], MAP)
    assert aligned == 11
    kept = [f for f in range(12) if f != 5]
    for name, stages in GROUPS.items():
        assert _read(name, ctx) == pytest.approx(_want_ms(stages, kept),
                                                 rel=1e-12)


def test_no_reading_below_nine_tenths_aligned(tables):
    ctx = {"frames": 12, "device": _frames(12, drop={(2, 0), (9, 14)})}
    assert _stages.stage_seconds(ctx["device"], MAP)[1] == 10
    for name in GROUPS:
        assert _read(name, ctx) is None


def test_a_window_that_reaches_a_host_copy_is_refused(tables):
    # Frame 4's fill is an upload instead, and a node of its replay is
    # lost: it holds the usual count, but its window reaches the upload.
    recs = _frames(12, drop={(4, 3)})
    at = 4 * (len(recs) + 1) // 12
    assert "FillFunctor" in recs[at][0]
    recs[at] = ("Memcpy HtoD (Pageable -> Device)",) + recs[at][1:]
    recs.insert(at, ("kernel_before_the_replay", recs[at][1] - 1e-7, 0.0))
    assert _stages.stage_seconds(recs, MAP)[1] == 11


def test_stage_metrics_read_none_without_a_map_or_its_stages(tables,
                                                             monkeypatch):
    ctx = {"frames": 3, "device": _frames(3)}
    static = [(s, k) for s, k in MAP if s not in ("animate", "seg_expand")]
    monkeypatch.setattr(tracing, "GRAPHS", [static])
    assert _read("animation.device_ms", ctx) is None
    monkeypatch.setattr(tracing, "GRAPHS", [])
    for name in GROUPS:
        assert _read(name, ctx) is None


def test_staging_host_ms_from_the_spans(tables, monkeypatch):
    ctx = {"frames": 20, "device": []}
    assert _read("staging.host_ms.rebuild", ctx) is None
    monkeypatch.setattr(tracing, "SPANS", {
        "piet.render_u32": [1.2, 20], "piet.prepare": [0.8, 20],
        "piet.prepare.seg_pre": [0.6, 20], "piet.upload": [0.2, 40],
        "piet.stats_read": [0.01, 20]})
    assert _read("staging.host_ms.rebuild", ctx) == pytest.approx(50.0)


def test_capture_seconds_from_the_counters(tables, monkeypatch):
    ctx = {"frames": 1, "device": []}
    assert _read("setup.capture_s", ctx) is None
    monkeypatch.setattr(tracing, "graph_captures", 1)
    monkeypatch.setattr(tracing, "capture_s", 0.42)
    assert _read("setup.capture_s", ctx) == pytest.approx(0.42)


def test_a_program_without_tracing_reads_none(tables, monkeypatch):
    monkeypatch.delattr(piet_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "piet_tpu_torch.tracing", None)
    ctx = {"frames": 3, "device": _frames(3)}
    for name in list(GROUPS) + ["staging.host_ms.rebuild",
                                "setup.capture_s"]:
        assert _read(name, ctx) is None
