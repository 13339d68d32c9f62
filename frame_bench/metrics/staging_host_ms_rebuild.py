"""Host time per frame of host staging where the host rebuilds each frame:
the program's spans ``piet.prepare`` (``prepare_scene``: padding, colour
decode and ``build_seg_pre``) and ``piet.upload`` (the copies into the
frame step's static inputs), summed over the traced slice (the spans
record while the profiler collects: ``tracing.SPANS``), over its frames.
None for a program without the spans."""

NAME = "staging.host_ms.rebuild"
UNIT = "ms/frame"
LAYER = "host staging"
SOURCE = "host_clock"
MOVES = "frame_ms.rebuild"

SPANS = ("piet.prepare", "piet.upload")


def read(ctx):
    try:
        from piet_tpu_torch import tracing
    except ImportError:
        return None
    if not ctx["frames"] or any(s not in tracing.SPANS for s in SPANS):
        return None
    return 1e3 * sum(tracing.SPANS[s][0] for s in SPANS) / ctx["frames"]
