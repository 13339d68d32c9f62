"""The flagship step and the multi-device dry run: the counterparts of
``__graft_entry__.entry`` and ``__graft_entry__.dryrun_multichip``.

``entry()`` returns ``(render_fn, (dev,))``: the frame step of the
Ghostscript Tiger at the reference's 8x demo scale, 1664^2 in 32x128
tiles with capacities fitted to the scene, and the scene staged on the
device.  ``render_fn(dev)`` renders one frame, one CUDA graph replay on a
card.  ``dryrun_multichip(n)`` renders one row-sharded frame over ``n``
mesh positions (parallel/sharding.py) on tiny shapes.
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


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded frame over ``n_devices`` mesh positions on tiny shapes
    (the JAX dry run's: ``n_devices * 2`` tile rows of 16 pixels, 256
    pixels wide, the cardioid), on ``device``'s type: "cuda" takes cards
    0 .. n - 1, or puts every position on ``cuda:0`` where there are
    fewer cards (the JAX dry run falls back to CPU devices there; this one
    stays on the card); "cpu" puts them all on the CPU."""
    import torch

    from .config import RenderConfig
    from .parallel import ShardedRenderer
    from .renderer.renderer import check_device
    from .scene.fixtures import make_cardioid

    dev = check_device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        devs = ([f"cuda:{i}" for i in range(n_devices)]
                if n_cards >= n_devices else ["cuda:0"] * n_devices)
    else:
        devs = ["cpu"] * n_devices
    config = RenderConfig(
        width=256, height=n_devices * 2 * 16, tile_height=16, tile_width=128,
        cmd_capacity=128, max_items=256, max_points=1024, max_segments=1024,
        max_hits=1 << 13, max_candidates=1 << 11, max_deltas=1 << 10)
    scene = make_cardioid(center=(128.0, config.height / 2.0),
                          r=min(100.0, config.height / 2.0 - 8.0))
    renderer = ShardedRenderer(config, devs, fine_impl="auto")
    img = renderer.render(scene)
    assert img.shape == (config.height, config.width, 4), img.shape
    assert int(sum(v.sum() for k, v in renderer.last_stats.items()
                   if k.endswith("overflow"))) == 0
