"""Device time per frame of the fine kernel: the dense interpreter
(``csrc/fine_dense.cu``, the default route) or kernel D
(``csrc/fine.cu``, the entries route), with the dense-first tile order
both launch before it (``csrc/fine_common.cuh``)."""

NAME = "fine.device_ms"
UNIT = "ms/frame"
LAYER = "fine"
SOURCE = "device_trace"
MOVES = "frame_ms"

#: Name fragments of the fine kernel's device operations.
FINE_KERNELS = ("fine_dense_kernel", "fine_entries_kernel", "tile_order")


def is_fine(name: str) -> bool:
    return any(k in name for k in FINE_KERNELS)


def fine_seconds(ctx) -> float:
    return sum(d for name, _, d in ctx["device"] if is_fine(name))


def read(ctx):
    if not ctx["frames"]:
        return None
    sec = fine_seconds(ctx)
    return 1e3 * sec / ctx["frames"] if sec > 0 else None
