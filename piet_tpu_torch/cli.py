"""Command line of the port: render / bench / animate / profile / goldens /
dump / info.

The counterpart of ``piet_tpu/cli.py``, with its commands, flags and JSON
keys.  Every command runs on the CUDA card; ``--cpu`` runs it on the CPU
instead (the tests do).  Without ``--cpu`` and without a card a command
fails: nothing falls back to the CPU.  ``--fine-impl`` takes the port's
route names, ``entries`` and ``dense``, and the JAX package's names of the
same two routes, ``pallas`` and ``xla``, so a command line written for
``piet_tpu`` runs unchanged; ``auto`` is the port's default route.

Usage:
    python -m piet_tpu_torch render --scene tiger --out tiger.png
    python -m piet_tpu_torch render --scene tiger --scale 19.2 --width 3840 \\
        --height 2160 --out tiger4k.png
    python -m piet_tpu_torch bench --scene beziers_10k --frames 20
    python -m piet_tpu_torch profile --scene tiger --width 1664 --height 1664
    python -m piet_tpu_torch goldens --outdir goldens/
    python -m piet_tpu_torch info

Times on the card are CUDA-event times; a command that prints a JSON
result prints the card's name and power limit on a line before it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

#: ``--fine-impl`` names -> the port's routes (``pallas``/``xla`` are the
#: JAX package's names of the same two routes).
FINE_IMPL_NAMES = {"auto": "auto", "entries": "entries", "dense": "dense",
                   "pallas": "entries", "xla": "dense"}


def card_line(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; "cpu" on the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[dev.index or 0]


def _device(args):
    """The command's device: "cuda", or "cpu" under ``--cpu``; a CUDA
    device without a card raises (renderer.check_device)."""
    from .renderer.renderer import check_device
    return check_device("cpu" if args.cpu else "cuda")


def _impl(args) -> str:
    return FINE_IMPL_NAMES[args.fine_impl]


@contextlib.contextmanager
def _timer(device, out: list):
    """Time the block: CUDA events on a card (the block's device work,
    synchronized at its end), the host clock on the CPU; appends ms to
    ``out``."""
    import torch
    if device.type != "cuda":
        t0 = time.perf_counter()
        yield
        out.append((time.perf_counter() - t0) * 1e3)
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    torch.cuda.synchronize(device)
    out.append(start.elapsed_time(end))


def _print_result(device, result: dict) -> None:
    print(card_line(device))
    print(json.dumps(result))


def _build_scene(args):
    from .scene.fixtures import get_scene
    kw = {}
    if args.scene == "tiger" and args.scale:
        kw["scale"] = args.scale
    if args.scene == "animated":
        kw["t"] = args.t
    return get_scene(args.scene, **kw)


def _config_for(args, scene):
    import numpy as np

    from .config import RenderConfig
    from .renderer.capacity import fit_capacities
    w = args.width or int(np.ceil(scene.bboxes[:, 2].max() + 8))
    h = args.height or int(np.ceil(scene.bboxes[:, 3].max() + 8))
    # Record capacities fitted to the scene on the host (exact counts,
    # renderer/capacity.py): padding costs frame time.
    return fit_capacities(scene, RenderConfig(width=w, height=h),
                          bucket=True)


def _envelope(cfg, c, fields):
    """``cfg`` with each of ``fields`` raised to ``c``'s where larger."""
    return dataclasses.replace(cfg, **{f: max(getattr(cfg, f), getattr(c, f))
                                       for f in fields})


_RECORD_FIELDS = ("max_hits", "max_candidates", "max_deltas", "cmd_capacity")


def _write_frames(outdir, imgs, cfg) -> None:
    """(H, W) int32 RGBA8 images -> ``outdir/frame_NNNN.png``."""
    import numpy as np

    from .utils.png import write_png
    os.makedirs(outdir, exist_ok=True)
    for i, img in enumerate(imgs):
        write_png(os.path.join(outdir, f"frame_{i:04d}.png"),
                  np.ascontiguousarray(img.cpu().numpy()).view(np.uint8)
                  .reshape(cfg.height, cfg.width, 4))


def cmd_render(args) -> int:
    from .renderer.renderer import Renderer
    from .scene.scene import Scene
    from .utils.png import write_png

    dev = _device(args)
    if args.load:
        scene = Scene.load(args.load)
    elif args.svg:
        from .scene.svg_full import load_svg_file
        scene = load_svg_file(args.svg, scale=args.scale,
                              target_width=args.width)
    else:
        scene = _build_scene(args)
    if args.save_scene:
        scene.save(args.save_scene)
    cfg = _config_for(args, scene)
    t0 = time.time()
    renderer = Renderer(cfg, dev, fine_impl=_impl(args))
    img = renderer.render(scene)
    print(f"rendered {cfg.width}x{cfg.height} in {time.time() - t0:.1f}s "
          f"(includes capture); stats: {renderer.last_stats}")
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


def cmd_bench(args) -> int:
    import numpy as np
    import torch

    from .profiling import profile_render
    from .renderer.renderer import Renderer, pack_scene, prepare_scene
    from .roofline import frame_roofline

    dev = _device(args)
    scene = _build_scene(args)
    cfg = _config_for(args, scene)
    renderer = Renderer(cfg, dev, fine_impl=_impl(args))
    renderer.render(scene)  # capture + capacity check
    stats = renderer.last_stats
    times: list = []
    if args.reencode:
        # Animated workload: re-encode the scene on the host and re-upload
        # it every frame as ONE packed buffer (pack_scene), unpacked inside
        # the frame's graph; the native C++ builder where it is available.
        from . import native
        from .scene.fixtures import (make_animated_frame,
                                     make_animated_frame_native)
        build = (make_animated_frame_native if native.available()
                 else make_animated_frame)
        rfn = renderer.packed_render_fn()

        def packed(s):
            return torch.from_numpy(pack_scene(s, cfg).view(np.int32))

        rfn.flat(packed(scene))  # capture
        flat = None
        with _timer(dev, times):
            for i in range(args.frames):
                frame_scene = (build(i / 60.0)
                               if args.scene == "animated" else scene)
                flat = rfn.flat(packed(frame_scene))
        vals = flat[-len(rfn.keys):].tolist()
        renderer.last_stats = dict(zip(rfn.keys, vals))
        renderer._check_capacity(renderer.last_stats)
    else:
        x = renderer._render.stage(prepare_scene(scene, cfg, dev))
        renderer._render.flat(x)
        with _timer(dev, times):
            for _ in range(args.frames):
                renderer._render.flat(x)
    value = times[0] / args.frames
    prof = profile_render(scene, cfg, fine_impl=_impl(args),
                          reps=args.frames, device=dev)
    roof = frame_roofline(stats, cfg, prof["coarse_total"], prof["fine"],
                          value)
    print(json.dumps({"roofline": roof}))
    _print_result(dev, {
        "scene": args.scene, "viewport": f"{cfg.width}x{cfg.height}",
        "ms_per_frame": round(value, 3), "frames": args.frames,
        "reencode": bool(args.reencode),
        "fill_mpix_per_s": round(cfg.width * cfg.height / value / 1e3, 1),
    })
    return 0


def cmd_animate(args) -> int:
    """Render an N-frame animation to PNGs: the headless counterpart of
    the reference's 60 Hz redraw loop, driven through the batched
    ``Renderer.render_sequence`` (one graph replay per chunk), or, for
    the animated fixture and ``--affine``/``--svg``, a device animation
    (one replay per frame, no host encode)."""
    from .renderer.capacity import fit_capacities
    from .renderer.renderer import Renderer
    from .scene.fixtures import get_scene
    from .utils.png import write_png

    dev = _device(args)
    os.makedirs(args.outdir, exist_ok=True)
    if args.affine or args.svg:
        return _animate_affine(args, dev)
    if args.scene == "animated" and args.device_anim:
        return _animate_device(args, dev)

    t_enc0 = time.perf_counter()
    scenes = []
    for i in range(args.frames):
        t = args.t0 + i * args.dt
        if args.scene == "animated":
            scenes.append(get_scene("animated", t=t))
        elif args.scene == "tiger":
            # Breathing tiger: the scale animated about the requested one.
            s = (args.scale or 4.0) * (1.0 + 0.15 * math.sin(t * 2 * math.pi))
            scenes.append(get_scene("tiger", scale=s))
        else:
            scenes.append(_build_scene(args))
    encode_ms = (time.perf_counter() - t_enc0) * 1e3

    # One capacity envelope over every frame (field-wise max): the whole
    # sequence shares one frame step.
    cfg = _config_for(args, scenes[0])
    for s in scenes[1:]:
        cfg = _envelope(cfg, fit_capacities(s, cfg, bucket=True),
                        ("max_items", "max_points", "max_segments")
                        + _RECORD_FIELDS)
    renderer = Renderer(cfg, dev, fine_impl=_impl(args))

    chunk = max(1, args.chunk)
    t_r0 = time.perf_counter()
    frames = [renderer.render_sequence(scenes[lo:lo + chunk])
              for lo in range(0, len(scenes), chunk)]
    render_ms = (time.perf_counter() - t_r0) * 1e3
    n = 0
    for batch in frames:
        for img in batch:
            write_png(os.path.join(args.outdir, f"frame_{n:04d}.png"), img)
            n += 1
    _print_result(dev, {
        "scene": args.scene, "frames": n,
        "viewport": f"{cfg.width}x{cfg.height}",
        "encode_ms_per_frame": round(encode_ms / n, 3),
        "render_ms_per_frame": round(render_ms / n, 3),
        "outdir": args.outdir,
    })
    return 0


def _animate_loop(args, dev, render_t, cfg, result: dict) -> int:
    """Warm ``render_t``, render the frames back to back (one replay
    each), time them, write them, print the JSON result."""
    render_t(args.t0)  # capture + warm
    times: list = []
    with _timer(dev, times):
        outs = [render_t(args.t0 + i * args.dt) for i in range(args.frames)]
    wall_ms = times[0]
    _write_frames(args.outdir, [img for img, _ in outs], cfg)
    _print_result(dev, {
        **result, "viewport": f"{cfg.width}x{cfg.height}",
        "encode_ms_per_frame": 0.0,
        "wall_ms_per_frame": round(wall_ms / args.frames, 3),
        "fps_wall": round(1e3 * args.frames / wall_ms, 1),
        "outdir": args.outdir,
    })
    return 0


def _animate_device(args, dev) -> int:
    """The animated fixture computed on the device from ``t`` inside the
    frame's graph (scene/animate.py): no host encode a frame."""
    from .renderer.capacity import fit_capacities
    from .scene import animate
    from .scene.fixtures import make_animated_frame

    tmpl = animate.template_scene()
    cfg = _config_for(args, tmpl)
    # Capacity envelope over the t sweep: the field-wise max of a few
    # host-built frames (overflow is still checked per frame by stats).
    for k in range(1, 5):
        t = args.t0 + (args.frames - 1) * args.dt * k / 4
        cfg = _envelope(cfg, fit_capacities(make_animated_frame(t), cfg,
                                            bucket=True),
                        ("max_segments",) + _RECORD_FIELDS)
    render_t, _ = animate.make_animated_render_fn(cfg, device=dev,
                                                  fine_impl=_impl(args))
    return _animate_loop(args, dev, render_t, cfg, {
        "scene": "animated", "frames": args.frames, "device_anim": True})


def _animate_affine(args, dev) -> int:
    """Any scene spun and zoomed about the viewport centre, its transform
    computed from ``t`` inside the frame's graph (scene/affine.py)."""
    import torch

    from .renderer.capacity import fit_capacities
    from .scene import affine

    if args.svg:
        from .scene.svg_full import load_svg_file
        scene = load_svg_file(args.svg, scale=args.scale or 1.0)
    else:
        scene = _build_scene(args)
    cfg = _config_for(args, scene)
    cx, cy = cfg.width / 2.0, cfg.height / 2.0
    period, zoom = args.period, args.zoom

    # Capacity envelope over the t sweep: record counts change under
    # rotation, so fit a few host-transformed samples and take the max.
    for k in range(5):
        t = args.t0 + (args.frames - 1) * args.dt * k / 4
        a = t * (2.0 * math.pi / period)
        m = affine.rotation_about(cx, cy, torch.tensor(a),
                                  1.0 + zoom * math.sin(a)).numpy()
        cfg = _envelope(cfg, fit_capacities(
            affine.host_transform_scene(scene, m), cfg, bucket=True),
            _RECORD_FIELDS)

    def mats_fn(t):
        a = t * (2.0 * math.pi / period)
        return affine.rotation_about(cx, cy, a, 1.0 + zoom * torch.sin(a))

    render_t = affine.make_affine_render_fn(cfg, scene, mats_fn, device=dev,
                                            fine_impl=_impl(args))
    return _animate_loop(args, dev, render_t, cfg, {
        "scene": args.svg or args.scene, "frames": args.frames,
        "device_affine": True})


def cmd_profile(args) -> int:
    """Per-stage times on the device (piet_tpu_torch/profiling.py)."""
    from .profiling import format_profile, profile_render

    dev = _device(args)
    scene = _build_scene(args)
    cfg = _config_for(args, scene)
    results = profile_render(scene, cfg, fine_impl=_impl(args),
                             reps=args.frames, device=dev)
    print(format_profile(results))
    _print_result(dev, results)
    return 0


#: The fixtures ``goldens`` renders.
GOLDEN_SCENES = ("path_test", "cardioid", "circles_rects", "glyph_page",
                 "clip_star", "gradients", "holes")


def cmd_goldens(args) -> int:
    """Render every fixture through the device path and the numpy oracle,
    write PNG pairs, report the largest difference; exit 1 above
    ``--tolerance``."""
    import numpy as np

    from .config import RenderConfig
    from .raster.cpu_fine import cpu_render_scene
    from .renderer.capacity import fit_capacities
    from .renderer.renderer import Renderer
    from .scene.fixtures import get_scene
    from .utils.png import write_png

    dev = _device(args)
    os.makedirs(args.outdir, exist_ok=True)
    # 512^2: the oracle is scalar numpy; a sweep stays under a minute.
    worst = 0
    for name in GOLDEN_SCENES:
        scene = get_scene(name)
        cfg = fit_capacities(
            scene, RenderConfig(width=512, height=512, tile_height=16,
                                tile_width=128), bucket=True)
        img = Renderer(cfg, dev, fine_impl=_impl(args)).render(scene)
        gold = cpu_render_scene(scene, cfg)
        diff = int(np.abs(img.astype(int) - gold.astype(int)).max())
        worst = max(worst, diff)
        write_png(os.path.join(args.outdir, f"{name}.png"), img)
        write_png(os.path.join(args.outdir, f"{name}_golden.png"), gold)
        print(f"{name}: max |device - golden| = {diff}")
    return 0 if worst <= args.tolerance else 1


def cmd_dump(args) -> int:
    """Hexdump a scene's wire encoding (u32 words, annotated)."""
    from .scene.scene import Scene
    from .scene.wire import encode_scene, hexdump_scene

    scene = Scene.load(args.load) if args.load else _build_scene(args)
    print(hexdump_scene(encode_scene(scene)))
    return 0


def cmd_info(args) -> int:
    import torch

    from . import native
    print(f"torch: {torch.__version__} (cuda {torch.version.cuda})")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}")
    else:
        print("devices: no CUDA device")
    print(f"native C++ library: "
          f"{'available' if native.available() else 'unavailable'}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="piet_tpu_torch", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    sub = p.add_subparsers(dest="cmd", required=True)

    def fine_impl_arg(sp):
        sp.add_argument("--fine-impl", default="auto",
                        choices=list(FINE_IMPL_NAMES),
                        help="frame route: entries (pallas) or dense (xla)")

    def scene_args(sp):
        sp.add_argument("--scene", default="tiger")
        sp.add_argument("--scale", type=float, default=None)
        sp.add_argument("--t", type=float, default=0.0)
        sp.add_argument("--width", type=int, default=None)
        sp.add_argument("--height", type=int, default=None)
        fine_impl_arg(sp)

    r = sub.add_parser("render", help="render a scene to PNG")
    scene_args(r)
    r.add_argument("--out", default="out.png")
    r.add_argument("--load", help="load scene from .npz instead")
    r.add_argument("--svg", help="render an SVG FILE via the general "
                   "parser (scene/svg_full.py; --scale applies)")
    r.add_argument("--save-scene", help="also save the scene as .npz")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="time a scene, print JSON")
    scene_args(b)
    b.add_argument("--frames", type=int, default=20)
    b.add_argument("--reencode", action="store_true",
                   help="re-encode + re-upload the scene every frame")
    b.set_defaults(fn=cmd_bench)

    a = sub.add_parser("animate", help="render an N-frame animation to PNGs")
    scene_args(a)
    a.add_argument("--frames", type=int, default=24)
    a.add_argument("--t0", type=float, default=0.0)
    a.add_argument("--dt", type=float, default=1.0 / 60.0)
    a.add_argument("--chunk", type=int, default=8,
                   help="frames per graph replay (host encode)")
    a.add_argument("--outdir", default="frames")
    a.add_argument("--affine", action="store_true",
                   help="device-side affine animation of ANY scene "
                        "(spin/zoom about the viewport center; "
                        "scene/affine.py)")
    a.add_argument("--svg", help="affine-animate an SVG file (implies "
                                 "--affine scene source)")
    a.add_argument("--period", type=float, default=4.0,
                   help="seconds of t per full rotation (--affine)")
    a.add_argument("--zoom", type=float, default=0.15,
                   help="zoom oscillation amplitude (--affine)")
    a.add_argument("--host-encode", dest="device_anim",
                   action="store_false", default=True,
                   help="per-frame HOST re-encode instead of the "
                        "device-side animation path (scene/animate.py)")
    a.set_defaults(fn=cmd_animate)

    pr = sub.add_parser("profile", help="per-stage pipeline timing (JSON)")
    scene_args(pr)
    pr.add_argument("--frames", type=int, default=40)
    pr.set_defaults(fn=cmd_profile)

    g = sub.add_parser("goldens", help="device vs CPU-oracle PNG pairs")
    g.add_argument("--outdir", default="goldens")
    g.add_argument("--tolerance", type=int, default=0)
    fine_impl_arg(g)
    g.set_defaults(fn=cmd_goldens)

    d = sub.add_parser("dump", help="hexdump a scene's wire encoding")
    scene_args(d)
    d.add_argument("--load", help="load scene from .npz instead")
    d.set_defaults(fn=cmd_dump)

    i = sub.add_parser("info", help="torch, card and native library status")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
