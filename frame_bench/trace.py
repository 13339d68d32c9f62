"""Reduce a torch.profiler trace of the traced slice to what the per-layer
metrics read.

The slice is the span from the start of its first ``frame_bench.frame``
range to the end of its last.  Device work is every kernel, copy and fill
record of the trace (``kernel``, ``gpu_memcpy``, ``gpu_memset``); the card
is busy where at least one of them runs, idle elsewhere.  An idle gap is
named by what the host was doing at its middle: the shortest host range
(an op, a runtime call or one of the harness's ranges) that covers it.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
FRAME_RANGE = "frame_bench.frame"


def load(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(events: list) -> dict:
    """Times in seconds.  Returns ``frames`` (frame ranges in the slice),
    ``window_s``, ``busy_s``, ``device`` (list of (name, start_s, dur_s)
    in the slice), ``gaps`` (list of (label, seconds))."""
    frames = [e for e in events if e.get("ph") == "X"
              and e.get("name") == FRAME_RANGE
              and e.get("cat") in ("user_annotation", "cpu_op")]
    if not frames:
        return {"frames": 0, "window_s": 0.0, "busy_s": 0.0, "device": [],
                "gaps": []}
    w0 = min(e["ts"] for e in frames)
    w1 = max(e["ts"] + e["dur"] for e in frames)
    dev = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _union([(max(s, w0), min(s + d, w1)) for _, s, d in dev])
    busy_us = sum(e - s for s, e in busy)
    host = sorted(((float(e["ts"]), float(e["ts"] + e["dur"]), e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in HOST_CATS
                   and e["ts"] < w1 and e["ts"] + e["dur"] > w0),
                  key=lambda h: (h[0], -h[1]))
    spans = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            spans.append((prev, s))
        prev = max(prev, e)
    labels = _labels(host, [(a + b) / 2.0 for a, b in spans])
    return {"frames": len(frames), "window_s": (w1 - w0) * 1e-6,
            "busy_s": busy_us * 1e-6,
            "device": [(n, s * 1e-6, d * 1e-6) for n, s, d in dev],
            "gaps": [(lab, (b - a) * 1e-6)
                     for lab, (a, b) in zip(labels, spans)]}


def _labels(host, times):
    """For each of ``times`` (ascending), the innermost host range that
    covers it: one sweep over the ranges, sorted by start (outer first),
    with a stack of the ranges still open."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(host) and host[j][0] <= t:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host range)")
    return out


def top(pairs, n: int = 10):
    """``pairs`` of (name, seconds) summed by name, the ``n`` largest."""
    acc = defaultdict(float)
    for name, sec in pairs:
        acc[name] += sec
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
