"""The numpy host layer the port shares with the JAX package.

``piet_tpu``'s configuration, scenes, capacity fitting, host segment stage,
CPU oracle and PNG writer use only numpy; the port imports them as they
are rather than copying them (tests/test_torch_import.py checks that this
keeps ``jax`` out of the process).  Scripts take them from here.
"""

from piet_tpu.config import RenderConfig
from piet_tpu.raster.cpu_fine import cpu_render_scene
from piet_tpu.renderer.capacity import fit_capacities
from piet_tpu.renderer.segstage import build_seg_pre
from piet_tpu.scene.fixtures import get_scene
from piet_tpu.scene.svg import make_tiger
from piet_tpu.utils.png import write_png

__all__ = ["RenderConfig", "cpu_render_scene", "fit_capacities",
           "build_seg_pre", "get_scene", "make_tiger", "write_png"]
