"""Device time per frame of every operation of the frame but the fine
kernel: the coarse pass (kernels A, B, C, keyed, expand, gatherm and the
torch glue between them), the present composite and the output's copy."""

from .fine_device_ms import fine_seconds

NAME = "coarse.device_ms"
UNIT = "ms/frame"
LAYER = "coarse"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(ctx):
    if not ctx["frames"] or not ctx["device"]:
        return None
    sec = sum(d for _, _, d in ctx["device"]) - fine_seconds(ctx)
    return 1e3 * sec / ctx["frames"]
