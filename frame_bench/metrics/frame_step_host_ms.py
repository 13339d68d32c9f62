"""Host time inside the port's frame call until it returns, per frame:
the harness's own span around the call (host clock), over the untraced
frames that precede the traced slice."""

NAME = "frame_step.host_ms"
UNIT = "ms/frame"
LAYER = "frame step"
SOURCE = "host_clock"
MOVES = "frame_ms"


def read(ctx):
    spans = ctx.get("host_call_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
