"""Device time per frame of the coarse pass's tail, from the frame graph's
stage map (``_stages.py``): pairing or the run words on the entries
route (``pairing``, ``runs``), and the per-tile reduction, the bail and,
on the dense route, the slot scatters (``tile_reduce``)."""

from ._stages import stage_ms

NAME = "coarse.tail_device_ms"
UNIT = "ms/frame"
LAYER = "coarse"
SOURCE = "device_trace"
MOVES = "frame_ms"

STAGES = ("pairing", "runs", "tile_reduce")


def read(ctx):
    return stage_ms(ctx, STAGES)
