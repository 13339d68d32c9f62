"""The share of the frame loop in which the card runs no kernel, copy
or fill: 1 - (the traced slice's busy seconds a frame) / (seconds a frame
of the untraced slice that precedes it, same loop).

The traced slice's own wall time is not the base: under the profiler a
graph launch costs the host several times what it costs untraced, so the
traced loop idles the card for the profiler's sake.  ``device.busy_s`` and
``window_s`` of the result line are the traced slice's own.
"""

NAME = "device.idle_share"
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(ctx):
    if not ctx["frames"] or not ctx.get("untraced_frame_s"):
        return None
    busy = ctx["busy_s"] / ctx["frames"]
    return 100.0 * (1.0 - busy / ctx["untraced_frame_s"])
