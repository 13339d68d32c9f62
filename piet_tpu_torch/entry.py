"""The flagship step and its arguments: the counterpart of
``__graft_entry__.entry`` for the port.

``entry()`` returns ``(render_fn, (dev,))``: the frame step of the
Ghostscript Tiger at the reference's 8x demo scale, 1664^2 in 32x128
tiles with capacities fitted to the scene, and the scene staged on the
device.  ``render_fn(dev)`` renders one frame, one CUDA graph replay on a
card.  The JAX module's ``dryrun_multichip`` waits for the row-slab
sharding (ROADMAP queue 1, item 12).
"""

from __future__ import annotations


def entry(device="cuda"):
    from .config import RenderConfig
    from .renderer.capacity import fit_capacities
    from .renderer.renderer import make_render_fn, prepare_scene
    from .scene.svg import make_tiger

    scene = make_tiger()            # 8x demo scale (reference src/lib.rs:287)
    config = fit_capacities(
        scene, RenderConfig(width=1664, height=1664, tile_height=32,
                            tile_width=128), bucket=True)
    dev = prepare_scene(scene, config, device)
    return make_render_fn(config, device), (dev,)
