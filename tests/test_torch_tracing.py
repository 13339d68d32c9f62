"""The port's tracing (piet_tpu_torch/tracing.py): host spans under
torch.profiler, nothing while it is off, the stage map's bookkeeping and
the capture counters; on the card, the frame graph's stage map against
its device nodes.

No JAX here: the card's tests run this file with
``python -m pytest --noconftest tests/test_torch_tracing.py``."""

import contextlib
import dataclasses
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from piet_tpu_torch import kernels, tracing
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.ops.coarse import PROBE_STAGES
from piet_tpu_torch.renderer import graph
from piet_tpu_torch.renderer.capacity import fit_capacities
from piet_tpu_torch.renderer.graph import CapturedStep
from piet_tpu_torch.renderer.renderer import (Renderer, make_render_fn,
                                              prepare_scene)
from piet_tpu_torch.scene import affine, fixtures
from piet_tpu_torch.scene.svg import make_tiger

SIZE = 64
#: The spans of a render_u32 call: its scene is staged for the call,
#: without the host segment stage, so no ``piet.prepare.seg_pre``.
HOST_SPANS = ("piet.render_u32", "piet.prepare", "piet.upload",
              "piet.stats_read")


@pytest.fixture
def renderer():
    scene = fixtures.get_scene("path_test")
    r = Renderer.for_scene(scene, SIZE, SIZE, device="cpu")
    r.render_u32(scene)
    return r, scene


@pytest.fixture
def clean_tables(monkeypatch):
    monkeypatch.setattr(tracing, "SPANS", {})
    monkeypatch.setattr(tracing, "GRAPHS", [])
    monkeypatch.setattr(tracing, "graph_captures", 0)
    monkeypatch.setattr(tracing, "capture_s", 0.0)


def _ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("piet.")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_render_u32_under_the_profiler_opens_nested_spans(renderer,
                                                         clean_tables):
    r, scene = renderer
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_u32(scene)
    ranges = _ranges(prof)
    names = [n for n, _, _ in ranges]
    for name in HOST_SPANS:
        assert name in names, names
    assert "piet.prepare.seg_pre" not in names
    assert names.count("piet.render_u32") == 1
    (top,) = [g for g in ranges if g[0] == "piet.render_u32"]
    for g in ranges:
        assert _inside(g, top), (g, top)
    # The prepare, the uploads and the stats read do not overlap.
    flat = sorted((g for g in ranges if g[0] in ("piet.prepare",
                                                  "piet.stats_read")),
                  key=lambda g: g[1])
    assert flat[0][0] == "piet.prepare" and flat[-1][0] == "piet.stats_read"
    assert flat[0][2] <= flat[-1][1]
    for name in set(names):
        seconds, count = tracing.SPANS[name]
        assert count == names.count(name) and seconds > 0


@pytest.mark.parametrize("seg_pre", [True, False])
def test_prepare_scene_opens_seg_pre_inside_prepare(renderer, clean_tables,
                                                    seg_pre):
    """A stage-once caller's prepare_scene (the default, with the host
    segment stage) opens ``piet.prepare.seg_pre`` inside
    ``piet.prepare``; without the host stage it opens none."""
    r, scene = renderer
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prepare_scene(scene, r.config, "cpu", seg_pre=seg_pre)
    ranges = _ranges(prof)
    names = [n for n, _, _ in ranges]
    assert names.count("piet.prepare") == 1
    assert names.count("piet.prepare.seg_pre") == int(seg_pre), names
    if seg_pre:
        prep = next(g for g in ranges if g[0] == "piet.prepare")
        seg = next(g for g in ranges if g[0] == "piet.prepare.seg_pre")
        assert _inside(seg, prep)
    for name in set(names):
        seconds, count = tracing.SPANS[name]
        assert count == names.count(name) and seconds > 0


def test_spans_cost_no_range_and_record_nothing_while_off(renderer,
                                                         clean_tables,
                                                         monkeypatch):
    r, scene = renderer

    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = dict(tracing.SEG_STAGES)
    r.render_u32(scene)
    assert tracing.SPANS == {}
    # The counters are always on.
    assert tracing.SEG_STAGES == {"host": before["host"],
                                  "device": before["device"] + 1}
    assert tracing.span("piet.anything") is tracing.span("piet.other")


def test_mark_outside_a_capture_records_nothing(clean_tables):
    tracing.mark("fine")
    tracing.mark("present")
    assert tracing.GRAPHS == [] and tracing._RECORDING is None


def test_launch_counters_stay_importable_from_kernels():
    """The launch counters have one home, tracing: kernels no longer
    re-exports them, and its launches count there."""
    for name in ("LAUNCHES", "reset_launches", "add_launches",
                 "launches_apart"):
        assert not hasattr(kernels, name), name
    assert kernels.tracing.LAUNCHES is tracing.LAUNCHES


class _FakeCuda:
    """Just enough of ``torch.cuda`` for ``CapturedStep`` to capture on the
    CPU: streams, a graph whose replay does nothing, and a device-node
    count that the step's ``fn`` advances."""

    def __init__(self):
        self.nodes = 0

    class Stream:
        cuda_stream = 1

        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    class CUDAGraph:
        def replay(self):
            pass

    def graph(self, g, stream=None):
        self.nodes = 0
        return contextlib.nullcontext()

    def install(self, monkeypatch):
        null = lambda *a, **k: contextlib.nullcontext()  # noqa: E731
        for name, value in (("Stream", self.Stream),
                            ("CUDAGraph", self.CUDAGraph),
                            ("graph", self.graph), ("device", null),
                            ("stream", null),
                            ("current_stream", lambda *a: self.Stream())):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(kernels, "library", lambda: None)
        monkeypatch.setattr(tracing, "captured_device_nodes",
                            lambda stream: self.nodes)


def test_captures_count_once_per_signature_and_keep_their_map(clean_tables,
                                                              monkeypatch):
    cuda = _FakeCuda()

    def fn(x):
        cuda.nodes += 3
        tracing.mark("cand_expand")
        cuda.nodes += 2
        tracing.mark("fine")
        cuda.nodes += 1
        return x * 2

    step = CapturedStep(fn, "cpu")
    small, big = torch.ones(4), torch.ones(8)
    # The static inputs are made on the CPU; the step then runs as on a card.
    step.static_inputs(small)
    step.static_inputs(big)
    step.device = torch.device("cuda")
    cuda.install(monkeypatch)
    for _ in range(3):
        for x in (small, big):
            assert torch.equal(step(x), x * 2)
    assert tracing.graph_captures == 2 and step.n_graphs() == 2
    assert tracing.capture_s > 0
    want = [("cand_expand", 3), ("fine", 2), ("rest", 1)]
    assert tracing.GRAPHS == [want, want]
    assert [e.stages for e in step._entries.values()] == [want, want]


def test_a_capture_runs_with_the_cyclic_collector_off(clean_tables,
                                                       monkeypatch):
    """A collection inside a capture could free an unreferenced step's
    graph, which a capturing stream does not permit: the eager pre-run
    runs with the collector on, the capture with it off, and it is on
    again after."""
    cuda = _FakeCuda()
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x + 1

    step = CapturedStep(fn, "cpu")
    x = torch.ones(4)
    step.static_inputs(x)
    step.device = torch.device("cuda")
    cuda.install(monkeypatch)
    assert gc.isenabled()
    for _ in range(2):
        assert torch.equal(step(x), x + 1)
    assert seen == [True, False] and gc.isenabled()


def test_a_map_ends_at_its_last_mark_when_nothing_follows(clean_tables,
                                                           monkeypatch):
    cuda = _FakeCuda()
    cuda.install(monkeypatch)
    with tracing.recording_stages(1) as stages:
        cuda.nodes = 5
        tracing.mark("present")
    assert stages == [("present", 5)] and tracing.GRAPHS == [stages]
    assert tracing._RECORDING is None


# ---- on the card ----------------------------------------------------------

def _tiger_step(kind):
    """(the frame step's CapturedStep, a call that replays it, its step
    function on its static inputs) for the 512^2 tiger: static (staged
    once), rebuilt (staged by each ``Renderer.render_u32`` call) or spun
    on the card."""
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512),
                         bucket=True)
    if kind == "static":
        render = make_render_fn(cfg, "cuda")
        x = render.stage(prepare_scene(scene, cfg, "cuda"))
        return render.step, lambda: render.flat(x), lambda: render.step.fn(x)
    if kind == "rebuilt":
        r = Renderer(cfg, "cuda")
        step = r._render.step
        return step, lambda: r.render_u32(scene), lambda: step.fn(r._staged)
    cfg = dataclasses.replace(cfg, max_hits=8 * cfg.max_hits,
                              max_candidates=8 * cfg.max_candidates)
    render_t = affine.make_affine_render_fn(
        cfg, scene, lambda t: affine.rotation_about(256.0, 256.0, t, 0.9))
    ts = render_t.static_inputs(torch.empty((), dtype=torch.float32))
    return render_t.step, lambda: render_t(0.5), lambda: render_t.step.fn(ts)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["static", "rebuilt", "affine"])
def test_cuda_stage_map_covers_the_frame_graph_in_order(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    step, call, fn = _tiger_step(kind)
    captures = tracing.graph_captures
    derived = tracing.SEG_STAGES["device"]
    call()
    assert tracing.graph_captures == captures + 1
    (entry,) = step._entries.values()
    stages = entry.stages
    assert tracing.GRAPHS[-1] is stages
    names = [s for s, _ in stages]
    assert all(n > 0 for _, n in stages), stages
    assert names[-2:] == ["fine", "present"], names
    coarse = names[1:-2] if kind == "affine" else names[:-2]
    if kind == "affine":
        assert names[0] == "animate"
    # Only the scene staged once carries the host segment stage.
    assert ("seg_expand" in coarse and "seg_rows" in coarse) == (
        kind != "static"), names
    # The device segment derivation ends with its rows (no probe there).
    order = list(PROBE_STAGES)
    order.insert(order.index("seg_rects") + 1, "seg_rows")
    assert coarse == [s for s in order if s in coarse], names
    assert coarse[0] == "cand_expand" and coarse[-1] == "tile_reduce"
    assert sum(n for _, n in stages) == len(graph.device_ops(fn))
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    assert tracing.graph_captures == captures + 1
    # One scene a rebuilt frame, its segment stage derived on the card.
    assert tracing.SEG_STAGES["device"] == derived + 4 * (kind == "rebuilt")
