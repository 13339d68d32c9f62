"""Device time per frame of the present, from the frame graph's stage map
(``_stages.py``): after the fine kernel, the composite of bailed tiles'
colours, the stats words and the assembly of the step's one output (the
output's clone, after the replay, is not in it)."""

from ._stages import stage_ms

NAME = "present.device_ms"
UNIT = "ms/frame"
LAYER = "present"
SOURCE = "device_trace"
MOVES = "frame_ms"

STAGES = ("present",)


def read(ctx):
    return stage_ms(ctx, STAGES)
