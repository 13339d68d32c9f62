"""Device operations (kernels, copies and fills) per frame in the traced
slice: everything the frame step enqueues on the card, and the harness's
one read of the stats words."""

NAME = "frame_step.device_ops"
UNIT = "ops/frame"
LAYER = "frame step"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(ctx):
    if not ctx["frames"] or not ctx["device"]:
        return None
    return len(ctx["device"]) / ctx["frames"]
