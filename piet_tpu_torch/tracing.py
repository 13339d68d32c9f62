"""The port's tracing: host spans, counters, and the stage map of every
captured frame graph.

**Spans.**  ``with span("piet.prepare"): ...`` marks a host layer
boundary.  While torch's profiler is collecting, a span opens a
``torch.profiler.record_function`` range of that name, so it lands in the
profiler's timeline beside the card's records, and adds its host seconds
and one count to :data:`SPANS`.  While the profiler is off, ``span``
checks the profiler's state once and returns a shared no-op context.  The
spans, all prefixed ``piet.``:

* ``piet.render_u32`` (``Renderer.render_u32``) and ``piet.step``
  (``CapturedStep.__call__``): one per entry call, the parent of the
  frame's other spans;
* ``piet.prepare`` (``prepare_scene``: padding, colour decode), with
  ``piet.prepare.seg_pre`` (``segstage.build_seg_pre``) inside where the
  scene takes the host segment stage: a stage-once caller's
  ``prepare_scene``, not ``Renderer.render_u32``'s, whose frame derives
  the segments on the card;
* ``piet.upload`` (``CapturedStep``'s copies into its static inputs);
* ``piet.replay`` (the graph's replay and the output's clone);
* ``piet.stats_read`` (``Renderer._finish``: the stats read and the
  capacity check);
* ``piet.capture`` (``CapturedStep``'s eager pre-run and capture).

**Counters.**  :data:`LAUNCHES` counts kernel launches per wrapper
(kernels.py); :data:`graph_captures` and :data:`capture_s` count the CUDA
graphs captured and the host seconds they took; :data:`SEG_STAGES`
counts the scenes ``prepare_scene`` staged, by where their segment stage
is computed, and :data:`COMBINED_FILLS` the combined multi-subpath fills
among them.  They are always on.

**Stage map.**  A CUDA graph replay runs hundreds of device ops whose
kernel names the stages share, and a profiler range opened while a graph
is captured does not exist when it is replayed.  So while
``CapturedStep`` captures a step it records a map: each stage of the
frame calls :func:`mark` at its end, and ``mark`` counts the device nodes
(kernel, memcpy, memset) captured so far.  The map is a list of
``(stage, nodes in the stage)`` in capture order, and holds only stages
that captured a node (every count > 0): a stage whose work an earlier
stage's kernel did (``seg_rects``, in the segment rows' kernel that
``seg_derive`` holds) is left out.  The frame's ops all run on one
stream, so the graph is a chain and a replay runs its nodes in that
order.  Stages: ``animate`` (a device animation's transform), the coarse
pass's probes (``ops/coarse.py::PROBE_STAGES``), ``fine``, ``present``
(the composite, the stats and the output's assembly), and ``rest`` for
nodes after the last mark.  Outside a capture ``mark`` costs one check;
on the CPU there is no capture and no map.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Dict, List, Optional, Tuple

import torch

# ---- spans ------------------------------------------------------------

#: Span name -> [host seconds, count], added while the profiler collects.
SPANS: Dict[str, list] = {}

_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.autograd.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        acc = SPANS.setdefault(self.name, [0.0, 0])
        acc[0] += dt
        acc[1] += 1
        return False


def span(name: str):
    """A context that traces ``name`` while the profiler collects, and
    does nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


# ---- counters ---------------------------------------------------------

#: Launches per kernel wrapper (one per wrapper call that launched its
#: kernel).  Plain-version calls never count.
#: Kernel D counts its paired instantiation ("fine_paired") apart from
#: its run dispatch ("fine"), and expand.cu its pairing compaction
#: ("expand_pairing", ``piet_compact_rows``) apart from the expansion
#: ("expand"); the three kernels of ``csrc/probes.cu`` and the two of
#: ``csrc/mosaic_probe.cu`` (the tools', ``ops/probes.py``) count one
#: each, and ``probe_numerics``' division op, launched for
#: ``div_probe``, counts as "probe_div".
LAUNCHES = {"candfuse": 0, "hitfuse": 0, "sort": 0, "fine": 0, "expand": 0,
            "keyed": 0, "gatherm": 0, "dense_tail": 0, "entries_tail": 0,
            "seg_rows": 0, "cand_rows": 0, "fine_dense": 0, "fine_paired": 0,
            "expand_pairing": 0, "probe_div": 0, "probe_numerics": 0,
            "probe_halfmix": 0, "probe_delivery": 0, "probe_mosaic": 0,
            "probe_dma16": 0}

#: Scenes staged by ``prepare_scene``, by where their segment stage is
#: computed: "host" (``build_seg_pre``, staged with the scene) or "device"
#: (no ``seg_pre``: the frame derives it, ``coarse.derive_seg_stage``).
SEG_STAGES = {"host": 0, "device": 0}

#: Combined multi-subpath fills in the scenes ``prepare_scene`` staged,
#: counted from the host flags: "scenes" that hold one, their "groups"
#: (FLAG_FILL_FINAL items) and "subpaths" (FLAG_FILL_CONT and
#: FLAG_FILL_FINAL items).
COMBINED_FILLS = {"scenes": 0, "groups": 0, "subpaths": 0}

#: CUDA graphs captured by ``CapturedStep`` in this process, and the host
#: seconds of their eager pre-runs and captures.
graph_captures = 0
capture_s = 0.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(counts: dict) -> None:
    for k, n in counts.items():
        LAUNCHES[k] += n


@contextlib.contextmanager
def launches_apart():
    """Count the launches made inside the block apart: they fill the
    yielded dict (kernel -> launches), and :data:`LAUNCHES` is left as it
    was before the block."""
    before = dict(LAUNCHES)
    apart = {}
    try:
        yield apart
    finally:
        for k, n in before.items():
            apart[k] = LAUNCHES[k] - n
            LAUNCHES[k] = n


def add_capture(seconds: float) -> None:
    global graph_captures, capture_s
    graph_captures += 1
    capture_s += seconds


# ---- the stage map ----------------------------------------------------

#: The stage maps of the captures, in capture order: the most recent is
#: the last.
GRAPHS: List[List[Tuple[str, int]]] = []

#: CUgraphNodeType values of the nodes that are device work (cuda.h).
DEVICE_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}

_CUDA = None


def _libcuda() -> ctypes.CDLL:
    global _CUDA
    if _CUDA is None:
        _CUDA = ctypes.CDLL("libcuda.so.1")
    return _CUDA


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


def graph_device_nodes(graph: int) -> List[str]:
    """The kinds of the device nodes (kernel, memcpy, memset) of the CUDA
    graph ``graph`` (a ``CUgraph`` handle), in the order
    ``cuGraphGetNodes`` gives them."""
    cuda = _libcuda()
    handle = ctypes.c_void_p(graph)
    n = ctypes.c_size_t(0)
    _check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    kinds = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value in DEVICE_NODES:
            kinds.append(DEVICE_NODES[kind.value])
    return kinds


def captured_device_nodes(stream: int) -> int:
    """Device nodes captured so far into the graph that ``stream`` (a
    ``CUstream`` handle under capture) is capturing."""
    cuda = _libcuda()
    status = ctypes.c_int(0)
    graph = ctypes.c_void_p(0)
    # (stream, status, id, graph, dependencies, their count); the id and
    # the dependencies are optional outputs.
    _check(cuda.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(stream), ctypes.byref(status), None,
        ctypes.byref(graph), None, None), "cuStreamGetCaptureInfo_v2")
    if status.value != 1 or not graph.value:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("the stream is not capturing")
    return len(graph_device_nodes(graph.value))


class _StageMap:
    """The map of one capture on ``stream``, as :func:`mark` fills it."""

    def __init__(self, stream: int):
        self.stream = stream
        self.stages: List[Tuple[str, int]] = []
        self.done = 0

    def mark(self, stage: str) -> None:
        n = captured_device_nodes(self.stream)
        if n > self.done:
            self.stages.append((stage, n - self.done))
        self.done = n


_RECORDING: Optional[_StageMap] = None


def mark(stage: str) -> None:
    """End stage ``stage`` of the step being captured: its device nodes
    are those captured since the previous mark (none: the map leaves it
    out).  Does nothing outside a capture that records a map."""
    if _RECORDING is not None:
        _RECORDING.mark(stage)


@contextlib.contextmanager
def recording_stages(stream: int):
    """Record the stage map of the capture on ``stream`` inside the block
    (the block holds the capture): yields the map's list, filled when the
    block ends, with nodes after the last mark as ``rest``; a stage with no
    node is left out.  The map is appended to :data:`GRAPHS`."""
    global _RECORDING
    rec = _StageMap(stream)
    _RECORDING = rec
    try:
        yield rec.stages
        rec.mark("rest")
    finally:
        _RECORDING = None
    GRAPHS.append(rec.stages)
