"""The closed loop: one frame in flight, each waited for before the next.

For every frame the harness hands the frame's input to the port's entry,
then waits until the frame's output is complete (it reads the frame's
stats words, which the frame writes last, or the entry read them itself)
and only then starts the next frame, as a UI loop presents a frame
before it draws the next.

A frame's latency is the host's clock from just before the hand-over to
the end of the wait: the host's work in the frame (staging, uploads,
launches), the card's, and the host's waking up to the frame's end.  The
garbage collector stays on, as it is in the loop of an app.
"""

from __future__ import annotations

import time

import numpy as np


class Keeper:
    """Holds the output of the latest frame of each pose in ``poses``
    (``None``: of the last frame) for the comparison after the window."""

    def __init__(self, poses):
        self.poses = poses
        self.kept = {}

    def offer(self, wl, i, out):
        if out is None:
            return
        p = wl.pose(i)
        if self.poses is None:
            self.kept = {p: out}
        elif p in self.poses:
            self.kept[p] = out


def window(wl, seconds: float, keeper: Keeper, first: int = 0) -> dict:
    """Frames back to back in a closed loop for ``seconds`` of host time.

    Returns ``attempted`` (frames started), ``failed`` (frames that raised
    or whose overflow counters read above zero), ``completed`` (frames
    that returned), ``latency_ms`` (every frame's latency) and
    ``window_s`` (from the first hand-over to the end of the last
    frame's wait)."""
    lat, attempted, n_failed, completed = [], 0, 0, 0
    clock = time.perf_counter
    t_start = clock()
    deadline = t_start + seconds
    i = first
    while clock() < deadline:
        attempted += 1
        t0 = clock()
        out = wl.frame(i)
        bad = wl.finish(out)
        lat.append(1e3 * (clock() - t0))
        n_failed += bool(bad)
        completed += out is not None
        keeper.offer(wl, i, out)
        i += 1
    t_end = clock()
    return {"attempted": attempted, "failed": n_failed,
            "completed": completed, "latency_ms": lat,
            "window_s": t_end - t_start, "next": i}


def host_spans(wl, frames: int, keeper: Keeper, first: int = 0) -> dict:
    """``frames`` frames of the same loop, each port call's host span (from
    the hand-over until the call returns, before the wait) by the host's
    clock, and the loop's seconds a frame (``frame_s``)."""
    spans, n_failed = [], 0
    t_start = time.perf_counter()
    for i in range(first, first + frames):
        t0 = time.perf_counter()
        out = wl.frame(i)
        spans.append(time.perf_counter() - t0)
        n_failed += bool(wl.finish(out))
        keeper.offer(wl, i, out)
    return {"host_call_s": spans, "failed": n_failed, "next": first + frames,
            "frame_s": (time.perf_counter() - t_start) / frames}


def traced(wl, frames: int, keeper: Keeper, trace_path: str,
           first: int = 0) -> dict:
    """``frames`` frames of the same loop under torch.profiler (CPU and
    CUDA activities), each inside a ``frame_bench.frame`` range; the
    trace is exported to ``trace_path``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n_failed = 0
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for i in range(first, first + frames):
            with record_function("frame_bench.frame"):
                with record_function("frame_bench.call"):
                    out = wl.frame(i)
                with record_function("frame_bench.wait"):
                    n_failed += bool(wl.finish(out))
            keeper.offer(wl, i, out)
    prof.export_chrome_trace(trace_path)
    return {"failed": n_failed, "next": first + frames}


def p95(values) -> float:
    """The 95th percentile of every value (linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), 95.0))
