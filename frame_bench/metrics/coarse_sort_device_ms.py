"""Device time per frame of the coarse pass's sort, from the frame graph's
stage map (``_stages.py``): the assembly of the rows to sort (``rows``),
the sort itself, kernel C (``sort``), and the gather of the sorted rows
(``sorted_gather``), with the torch glue between them."""

from ._stages import stage_ms

NAME = "coarse.sort_device_ms"
UNIT = "ms/frame"
LAYER = "coarse"
SOURCE = "device_trace"
MOVES = "frame_ms"

STAGES = ("rows", "sort", "sorted_gather")


def read(ctx):
    return stage_ms(ctx, STAGES)
