"""The port's numpy host layer, in one place for scripts.

Configuration, scenes, capacity fitting, the host segment stage, the CPU
oracle and the PNG writer are the port's own copies of the ``piet_tpu``
numpy modules, at the same relative paths (tests/test_torch_hostlayer.py
holds each copy against its original).  The port imports nothing of
``piet_tpu``.
"""

from .config import RenderConfig
from .raster.cpu_fine import cpu_render_scene
from .renderer.capacity import fit_capacities
from .renderer.segstage import build_seg_pre
from .scene.fixtures import get_scene
from .scene.svg import make_tiger
from .utils.png import write_png

__all__ = ["RenderConfig", "cpu_render_scene", "fit_capacities",
           "build_seg_pre", "get_scene", "make_tiger", "write_png"]
