"""Host seconds of the frame step's graph captures in set-up: the
program's counter ``tracing.capture_s`` (each capture's eager pre-run and
capture, the kernels' library already loaded), over every capture of the
run (``tracing.graph_captures``, one a signature).  None for a program
without the counter, or one that captured nothing."""

NAME = "setup.capture_s"
UNIT = "s"
LAYER = "frame step"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(ctx):
    try:
        from piet_tpu_torch import tracing
    except ImportError:
        return None
    if not tracing.graph_captures:
        return None
    return tracing.capture_s
