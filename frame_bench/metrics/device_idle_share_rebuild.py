"""``device.idle_share`` in the cells whose frames the host rebuilds, which
report ``frame_ms.rebuild`` in place of ``frame_ms``: the same reading."""

from .device_idle_share import LAYER, SOURCE, UNIT, read  # noqa: F401

NAME = "device.idle_share.rebuild"
MOVES = "frame_ms.rebuild"
