"""Device time per frame by stage of the captured frame graph: the helper
of the stage readers (``coarse.*_device_ms``, ``present.device_ms``,
``animation.device_ms``).

The program records, when it captures its frame step, the graph's stage
map (``piet_tpu_torch.tracing.GRAPHS``, the most recent capture last): a
list of (stage, device nodes) in capture order.  The step's ops run on one
stream, so a replay runs those nodes in that order.  In the trace, sorted
by start, a frame is then: what the entry enqueues before the replay (a
fill of ``t`` in the anim cell, nothing in a replay cell), the map's N
nodes, the output's clone, and the harness's read of the stats words, the
frame's one device-to-host copy (``Memcpy DtoH``).

Alignment, frame by frame between one stats copy and the next (the first
frame from the start of the traced slice): the record before the stats
copy is the clone, and the N records before the clone are the replay.  A
frame is aligned when

* it holds as many records before its clone as the most frequent count
  over the slice's frames, and at least N (a frame the profiler dropped a
  record from holds fewer, and is left out), and
* its N replay records hold no host copy (``HtoD`` or ``DtoH``) and so
  start after the previous frame's stats copy.

An aligned frame's replay is split by the map's counts and its durations
summed by stage.  A reading is the stage group's seconds over the frames
aligned; it is None where the program keeps no map (a program without
``tracing``), where the map holds none of the group's stages, or where
under 90% of the traced frames align.
"""

from __future__ import annotations

from collections import Counter, defaultdict

#: Least share of the traced frames that must align for a reading.
MIN_ALIGNED = 0.9


def stage_map():
    """The most recent capture's stage map, or None."""
    try:
        from piet_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.GRAPHS[-1] if tracing.GRAPHS else None


def _host_copy(name: str) -> bool:
    return name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name)


def stage_seconds(device, smap):
    """(device seconds by stage summed over the aligned frames, frames
    aligned) from ``device`` records (name, start_s, dur_s) and the stage
    map ``smap``."""
    n = sum(k for _, k in smap)
    recs = sorted(device, key=lambda r: r[1])
    stats = [i for i, r in enumerate(recs) if r[0].startswith("Memcpy DtoH")]
    # (first record after the previous stats copy, the clone's index).
    frames = []
    prev = -1
    for k in stats:
        frames.append((prev + 1, k - 1))
        prev = k
    usual = Counter(c - a for a, c in frames).most_common(1)
    if n <= 0 or not usual or usual[0][0] < n:
        return {}, 0
    usual = usual[0][0]
    sec = defaultdict(float)
    aligned = 0
    for a, c in frames:
        replay = recs[c - n:c]
        if c - a != usual or any(_host_copy(r[0]) for r in replay):
            continue
        at = 0
        for stage, k in smap:
            sec[stage] += sum(r[2] for r in replay[at:at + k])
            at += k
        aligned += 1
    return dict(sec), aligned


def stage_ms(ctx, stages) -> float | None:
    """Device ms per frame of the stage group ``stages``, or None."""
    smap = stage_map()
    if smap is None or not ctx["frames"] or not ctx["device"]:
        return None
    if not any(s in stages for s, _ in smap):
        return None
    sec, aligned = stage_seconds(ctx["device"], smap)
    if aligned < MIN_ALIGNED * ctx["frames"]:
        return None
    return 1e3 * sum(v for s, v in sec.items() if s in stages) / aligned
