"""Device time per frame of the coarse pass's binning, from the frame
graph's stage map (``_stages.py``): kernel A's candidate rows and their
expansion (``cand_expand``), kernel B's hit records (``hit_expand``), the
keyed sums (``cand_emit``) and the winding deltas (``deltas``), with the
torch glue between them."""

from ._stages import stage_ms

NAME = "coarse.binning_device_ms"
UNIT = "ms/frame"
LAYER = "coarse"
SOURCE = "device_trace"
MOVES = "frame_ms"

STAGES = ("cand_expand", "hit_expand", "cand_emit", "deltas")


def read(ctx):
    return stage_ms(ctx, STAGES)
