"""``frame_step.device_ops`` in the cells whose frames the host rebuilds,
which report ``frame_ms.rebuild`` in place of ``frame_ms``: the same
reading."""

from .frame_step_device_ops import LAYER, SOURCE, UNIT, read  # noqa: F401

NAME = "frame_step.device_ops.rebuild"
MOVES = "frame_ms.rebuild"
