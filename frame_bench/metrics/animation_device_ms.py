"""Device time per frame of device animation, from the frame graph's stage
map (``_stages.py``): the pose's affine and its application to the scene
(``animate``), and the coarse pass's derivation of the segments from the
moved points (``seg_expand``, ``seg_points``, ``seg_derive``,
``seg_rects`` and the rows' assembly after it, ``seg_rows``), which a
host-staged scene does not run."""

from ._stages import stage_ms

NAME = "animation.device_ms"
UNIT = "ms/frame"
LAYER = "device animation"
SOURCE = "device_trace"
MOVES = "frame_ms"

STAGES = ("animate", "seg_expand", "seg_points", "seg_derive", "seg_rects",
          "seg_rows")


def read(ctx):
    return stage_ms(ctx, STAGES)
