"""Host orchestration: stage a scene, bin it, rasterize it.

Port of ``piet_tpu/renderer/renderer.py``.  The scene is staged once as
padded tensors on a device (``prepare_scene``, with the numpy host segment
stage ``build_seg_pre`` unless a device animation derives segments per
frame), then a frame takes one of two routes (``fine_impl``):

* ``"dense"`` (the JAX package's portable ``"xla"`` route):
  ``coarse_rasterize(output="dense")`` -> ``fine_rasterize_xla`` on the
  (T, CAP) PTCL, then the present composite: bailed tiles take their
  solid colour's bytes;
* ``"entries"`` (the JAX package's ``"pallas"`` route):
  ``coarse_rasterize`` -> ``fine_rasterize_entries``, the present
  composite fused into the fine pass's empty tiles.  Its stream may be
  paired (ops/pairing.py): the mode is read from ``PIET_PAIR`` when a
  step is built, "off" unless it is set, as in the JAX package.

``"auto"``, the default of every entry point, is ``"dense"``: the JAX
package's rule off a TPU, and the faster graphed route on the H100 at six
of the seven cells measured (PERF.md).

A frame is one compiled step, as the JAX package's ``jax.jit`` makes it:
:func:`make_render_fn` returns ``render(scene) -> (img, stats)``, which on
a CUDA device is captured once per input signature as a CUDA graph and
replayed on every later call (renderer/graph.py); on the CPU it runs
eagerly.  :func:`make_render_sequence_fn` captures N frames of a stacked
scene in one graph (the counterpart of JAX's one ``lax.map`` dispatch).
Every ``Renderer`` entry point goes through them: ``render``/
``render_u32`` stage into the step's static inputs and replay it,
``render_sequence`` replays the sequence graph, ``render_packed_u32``
replays a step that unpacks the single staging buffer of ``pack_scene``
inside the graph, and ``render_updated`` copies only the dirty fields into
the static inputs before a replay.  A frame synchronizes once, when the
capacity statistics are read.  ``Renderer.render_device`` is the eager
reference: the same frame op by op, on no entry point's path.

Usage:
    r = Renderer.for_scene(scene, 1664, 1664)   # device="cuda" by default
    image = r.render(scene)        # (H, W, 4) uint8 RGBA
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..scene.color import decode_color_linear

from ..ops.coarse import DeviceScene, SegPre, coarse_rasterize
from ..ops.fine import fine_rasterize_entries
from ..ops.fine_xla import fine_rasterize_xla
from ..ops.pairing import pair_mode_from_env, resolve_pair_mode
from .graph import CapturedStep

#: The two frame routes; see the module doc.  ``"auto"`` names the
#: default, ``"dense"``.
FINE_IMPLS = ("entries", "dense")


class SceneCapacityError(ValueError):
    pass


def resolve_fine_impl(fine_impl: str) -> str:
    """A route name, with ``"auto"`` (the JAX package's default) read as
    the JAX package reads it off a TPU: ``"dense"``; raises for an unknown
    name."""
    impl = "dense" if fine_impl == "auto" else fine_impl
    if impl not in FINE_IMPLS:
        raise ValueError(f"fine_impl must be one of {FINE_IMPLS} or 'auto', "
                         f"got {fine_impl!r}")
    return impl


def check_device(device) -> torch.device:
    """``device`` as a torch.device: "cpu", "cuda" or "cuda:n".  A CUDA
    device without CUDA raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _host_tensor(arr) -> torch.Tensor:
    """numpy array -> CPU tensor of its own; uint32 as int32 bits."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _to_device(arr, device) -> torch.Tensor:
    """numpy array -> tensor on ``device``; uint32 travels as int32 bits."""
    return _host_tensor(arr).to(device)


def _pad(arr, n: int) -> np.ndarray:
    """``arr`` zero-padded along axis 0 to ``n`` rows."""
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[:arr.shape[0]] = arr
    return out


def device_scene_from_numpy(leaves, device) -> DeviceScene:
    """Stage numpy scene leaves on ``device`` as the port's DeviceScene.

    ``leaves`` is any object with the DeviceScene field names as
    attributes holding numpy arrays -- for example the JAX package's
    staged DeviceScene with every leaf taken as a numpy array.  uint32
    words (colours, flags, the segment table) become int32 bit patterns,
    reinterpreted with ``.view(torch.float32)`` where a pass reads floats.
    """
    sp = getattr(leaves, "seg_pre", None)
    seg_pre = None if sp is None else _stage_seg_pre(sp, device)
    fields = {f: _to_device(getattr(leaves, f), device)
              for f in DeviceScene._fields if f not in ("n_items", "seg_pre")}
    n_items = torch.tensor(int(np.asarray(leaves.n_items)), dtype=torch.int32,
                           device=device)
    return DeviceScene(n_items=n_items, seg_pre=seg_pre, **fields)


def prepare_scene(scene, config: RenderConfig, device="cuda",
                  seg_pre: bool = True) -> DeviceScene:
    """Pad an SoA scene into capacity-sized tensors on ``device``.

    ``seg_pre=True`` also stages the host-precomputed segment stage
    (renderer/segstage.py), bitwise equal to the device derivation; pass
    False for paths that move geometry on the device (scene/affine.py,
    scene/animate.py), whose coarse pass then derives segments itself."""
    from .segstage import build_seg_pre

    _check_scene_size(scene, config)
    NI = config.max_items
    host = DeviceScene(
        tags=_pad(scene.tags, NI), colors_u32=_pad(scene.colors, NI),
        colors_lin=_pad(decode_color_linear(scene.colors), NI),
        widths=_pad(scene.widths, NI), bboxes=_pad(scene.bboxes, NI),
        pt_offset=_pad(scene.pt_offset, NI), n_pts=_pad(scene.n_pts, NI),
        points=_pad(scene.points, config.max_points),
        flags=_pad(scene.flags, NI), clips=_pad(scene.clips, NI),
        grads=_pad(scene.grads, NI), n_items=np.int32(scene.n_items),
        seg_pre=build_seg_pre(scene, config) if seg_pre else None)
    return device_scene_from_numpy(host, device)


def _stage_seg_pre(sp, device) -> SegPre:
    """A host segment stage (numpy SegPre leaves) on ``device``."""
    return SegPre(*(_to_device(getattr(sp, f), device)
                    for f in SegPre._fields))


def _check_scene_size(scene, config: RenderConfig) -> None:
    if scene.n_items > config.max_items:
        raise SceneCapacityError(
            f"{scene.n_items} items > max_items {config.max_items}")
    if scene.n_points > config.max_points:
        raise SceneCapacityError(
            f"{scene.n_points} points > max_points {config.max_points}")


#: pack_scene's word counts per field, in units of max_items (NI) or
#: max_points (NP): tags, colours, linear colours, widths, bboxes,
#: pt_offset, n_pts, flags, clips, grads, then points and n_items.
_PACKED_NI_WORDS = (1, 1, 4, 1, 4, 1, 1, 1, 4, 8)


def pack_scene(scene, config: RenderConfig) -> np.ndarray:
    """Pack a scene into ONE flat uint32 staging buffer, padded to the
    config's capacities: one host-to-device copy per frame instead of one
    per field.  The layout is the JAX package's, word for word."""
    _check_scene_size(scene, config)
    NI, NP = config.max_items, config.max_points

    def pad_u32(arr, n):
        flat = np.ascontiguousarray(arr).view(np.uint32).reshape(
            arr.shape[0], -1)
        out = np.zeros((n, flat.shape[1]), np.uint32)
        out[:flat.shape[0]] = flat
        return out.reshape(-1)

    return np.concatenate([
        pad_u32(scene.tags, NI), pad_u32(scene.colors, NI),
        pad_u32(decode_color_linear(scene.colors), NI),
        pad_u32(scene.widths, NI), pad_u32(scene.bboxes, NI),
        pad_u32(scene.pt_offset, NI), pad_u32(scene.n_pts, NI),
        pad_u32(scene.flags, NI), pad_u32(scene.clips, NI),
        pad_u32(scene.grads, NI), pad_u32(scene.points, NP),
        np.array([scene.n_items], np.uint32)])


def unpack_scene(buf: torch.Tensor, config: RenderConfig) -> DeviceScene:
    """Slice a packed staging buffer (int32 bits, on any device) back into
    a DeviceScene of views: ``.view()`` bitcasts of the buffer, no copies.
    There is no host segment stage (``seg_pre=None``): the coarse pass
    derives the segments on the device."""
    NI, NP = config.max_items, config.max_points
    parts, off = [], 0
    for w in [k * NI for k in _PACKED_NI_WORDS] + [2 * NP, 1]:
        parts.append(buf[off:off + w])
        off += w
    f32 = torch.float32
    return DeviceScene(
        tags=parts[0], colors_u32=parts[1],
        colors_lin=parts[2].view(f32).reshape(NI, 4),
        widths=parts[3].view(f32), bboxes=parts[4].reshape(NI, 4),
        pt_offset=parts[5], n_pts=parts[6], flags=parts[7],
        clips=parts[8].view(f32).reshape(NI, 4),
        grads=parts[9].view(f32).reshape(NI, 8),
        points=parts[10].view(f32).reshape(NP, 2),
        n_items=parts[11].reshape(()))


def stack_scenes(scenes, config: RenderConfig, device="cuda") -> DeviceScene:
    """Stage a list of scenes as one DeviceScene with a leading frame axis
    on every tensor (the segment stage included)."""
    prepared = [prepare_scene(s, config, device) for s in scenes]
    sp = SegPre(*(torch.stack(x) for x in zip(*(p.seg_pre
                                                 for p in prepared))))
    return DeviceScene(*(torch.stack(x) for x in zip(*(
        p[:-1] for p in prepared))), seg_pre=sp)


def _frame_of(stacked: DeviceScene, i: int) -> DeviceScene:
    """Frame ``i`` of a stacked DeviceScene (views)."""
    sp = stacked.seg_pre
    return DeviceScene(*(x[i] for x in stacked[:-1]),
                       seg_pre=None if sp is None else SegPre(
                           *(x[i] for x in sp)))


def frame_scalar(t, device) -> torch.Tensor:
    """A frame's ``t`` as a 0-d f32 tensor on ``device``.  A python number
    becomes a fill kernel's argument: ``torch.as_tensor(t, device="cuda")``
    is a blocking host-to-device copy, which PyTorch follows with a stream
    synchronize, so every frame would wait for the one before."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.float32)
    return torch.full((), float(t), dtype=torch.float32, device=device)


def fetch_scene(dev: DeviceScene, n_items: int, n_points: int):
    """A staged (or device-computed) scene -> host Scene of its live
    prefix: how a device animation frame is handed to the numpy oracle."""
    from ..scene.scene import Scene

    def host(t, n, as_u32=False):
        a = t[:n].cpu().numpy()
        return a.view(np.uint32) if as_u32 else a

    return Scene(
        tags=host(dev.tags, n_items),
        colors=host(dev.colors_u32, n_items, True),
        widths=host(dev.widths, n_items), bboxes=host(dev.bboxes, n_items),
        pt_offset=host(dev.pt_offset, n_items),
        n_pts=host(dev.n_pts, n_items), points=host(dev.points, n_points),
        flags=host(dev.flags, n_items, True), clips=host(dev.clips, n_items),
        grads=host(dev.grads, n_items))


def _solid_to_present_u32(solid: torch.Tensor) -> torch.Tensor:
    """Logical 0xRRGGBBAA bits -> packed framebuffer bits (R in the low
    byte): the raw sRGB bytes of the present fast path."""
    r = (solid >> 24) & 0xFF
    g = (solid >> 16) & 0xFF
    b = (solid >> 8) & 0xFF
    a = solid & 0xFF
    return r | (g << 8) | (b << 16) | (a << 24)


def step_pair_mode(fine_impl: str) -> str:
    """The pairing mode a step of route ``fine_impl`` is built with:
    ``PIET_PAIR`` on the entries route (ops/pairing.py), "off" on the
    dense route, which takes no pairing."""
    if resolve_fine_impl(fine_impl) == "dense":
        return "off"
    return resolve_pair_mode(pair_mode_from_env())


def render_slab(scene: DeviceScene, config: RenderConfig, *, tiles_y: int,
                row0: int = 0, fine_impl: str = "auto", pair="off"):
    """Coarse + fine + present for ``tiles_y`` tile rows from ``row0`` by
    the ``fine_impl`` route; ``pair`` pairs the entries route's stream
    (ops/pairing.py).  Returns (slab image as int32 RGBA8 bits, stats of
    0-d tensors)."""
    fine_impl = resolve_fine_impl(fine_impl)
    tiles_x = config.tiles_x
    th, tw = config.tile_height, config.tile_width
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tw, tile_h=th,
              max_segments=config.max_segments, max_hits=config.max_hits,
              max_candidates=config.max_candidates, row0=row0)
    if fine_impl == "entries":
        pair = resolve_pair_mode(pair)
        coarse = coarse_rasterize(scene, pair=pair, **kw)
        img = fine_rasterize_entries(
            coarse.first, coarse.n_entries,
            _solid_to_present_u32(coarse.solid), coarse.stream, row0,
            tile_h=th, tile_w=tw, tiles_x=tiles_x, paired=pair != "off")
        stats = {"max_tile_cmds": coarse.counts.max(),
                 "bail_tiles": (coarse.solid != 0).sum(), **coarse.diag}
        return img, stats
    coarse = coarse_rasterize(scene, output="dense",
                              cmd_capacity=config.cmd_capacity, **kw)
    fine = fine_rasterize_xla(
        coarse.counts.reshape(tiles_y, tiles_x), coarse.tags, coarse.args,
        row0, tile_h=th, tile_w=tw, cmd_capacity=config.cmd_capacity)
    # Present composite: bailed tiles take their solid colour's bytes.
    solid = coarse.solid.reshape(tiles_y, 1, tiles_x, 1)
    shape = (tiles_y, th, tiles_x, tw)
    img = torch.where((solid != 0).expand(shape),
                      _solid_to_present_u32(solid).expand(shape),
                      fine.view(shape)).reshape(tiles_y * th, tiles_x * tw)
    stats = {"max_tile_cmds": coarse.counts.max(),
             "overflow_cmds": coarse.overflow.sum(),
             "bail_tiles": (coarse.solid != 0).sum(), **coarse.diag}
    return img, stats


def _frame_flat(scene: DeviceScene, config: RenderConfig, fine_impl: str,
                keys: List[str], pair="off") -> torch.Tensor:
    """One whole-viewport frame as one int32 vector: the (H, W) image's
    words, then each stat; the stat names go into ``keys``.  One output
    tensor makes a frame one clone and one host read."""
    img, stats = render_slab(scene, config, tiles_y=config.tiles_y, row0=0,
                             fine_impl=fine_impl, pair=pair)
    keys[:] = list(stats)
    return torch.cat([img[:config.height, :config.width].reshape(-1),
                      torch.stack([v.to(torch.int32)
                                   for v in stats.values()])])


class RenderFn:
    """A compiled frame step: ``render(x) -> (img, stats)``, the image
    (H, W) int32 RGBA8 bits (R in the low byte) and each stat a 0-d int32
    tensor -- or, for a sequence step, (N, H, W) and (N,) -- fresh tensors
    that no later call changes.  No host synchronization.

    ``frame(x, keys)`` is the step (see :func:`_frame_flat`); on a CUDA
    device it runs as a replayed CUDA graph (renderer/graph.py).
    ``stage``/``static_inputs`` give the step's static input tensors,
    ``n_graphs`` the input signatures it was built for, ``flat`` the
    step's one output tensor (image words, then stats)."""

    def __init__(self, config: RenderConfig, device, frame: Callable):
        self.config = config
        self.keys: List[str] = []
        self.step = CapturedStep(lambda x: frame(x, self.keys), device)
        self.stage = self.step.stage
        self.static_inputs = self.step.static_inputs
        self.n_graphs = self.step.n_graphs

    def __call__(self, x):
        return self.split(self.flat(x))

    def flat(self, x) -> torch.Tensor:
        return self.step(x)

    def split(self, flat: torch.Tensor):
        """(img, stats) views of a ``flat`` output."""
        h, w = self.config.height, self.config.width
        img = flat[..., :h * w].reshape(*flat.shape[:-1], h, w)
        return img, {k: flat[..., h * w + i] for i, k in enumerate(self.keys)}


class TimeRenderFn(RenderFn):
    """A frame step of one number: ``render_t(t) -> (img, stats)``, where
    ``t`` (a number or a 0-d tensor) is written into the step's static 0-d
    f32 input -- a fill kernel, or a device copy for a device tensor, never
    a blocking host copy -- and the step replayed."""

    def __call__(self, t):
        ts = self.static_inputs(_T_LIKE)
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            ts.copy_(t)
        else:
            ts.fill_(float(t))
        return super().__call__(ts)


_T_LIKE = torch.empty((), dtype=torch.float32)


def make_render_fn(config: RenderConfig, device="cuda",
                   fine_impl: str = "auto") -> RenderFn:
    """The frame step: a DeviceScene (``prepare_scene``, with or without
    ``seg_pre``) -> ((H, W) image, stats).  The counterpart of the JAX
    package's jitted ``make_render_fn``: on a CUDA device one CUDA graph
    per input signature, replayed; on the CPU the eager ``render_slab``.
    ``fine_impl``: "auto" (the default, = "dense"), "dense" or
    "entries"; the entries route's pairing mode is read from ``PIET_PAIR``
    here, when the step is built (:func:`step_pair_mode`)."""
    impl = resolve_fine_impl(fine_impl)
    mode = step_pair_mode(impl)
    return RenderFn(config, check_device(device),
                    lambda scene, keys: _frame_flat(scene, config, impl,
                                                    keys, mode))


def make_render_sequence_fn(config: RenderConfig, device="cuda",
                            fine_impl: str = "auto") -> RenderFn:
    """The sequence step: a stacked DeviceScene (``stack_scenes``, frame
    axis 0 on every tensor) -> ((N, H, W) images, stats of shape (N,)).
    On a CUDA device all N frames are one CUDA graph, captured once per N
    (the counterpart of the JAX package's one ``lax.map`` dispatch): a
    sequence is one replay and one clone, whatever N."""
    impl = resolve_fine_impl(fine_impl)
    mode = step_pair_mode(impl)

    def frames(stacked: DeviceScene, keys):
        return torch.stack([_frame_flat(_frame_of(stacked, i), config, impl,
                                        keys, mode)
                            for i in range(stacked.tags.shape[0])])

    return RenderFn(config, check_device(device), frames)


def make_time_render_fn(config: RenderConfig, scene_at: Callable, device,
                        fine_impl: str = "auto") -> TimeRenderFn:
    """The frame step of a device animation: ``scene_at(t)`` (a 0-d f32
    tensor on ``device`` -> the frame's DeviceScene, torch ops only) and
    the frame, as one step -- one CUDA graph on a CUDA device."""
    impl = resolve_fine_impl(fine_impl)
    mode = step_pair_mode(impl)
    return TimeRenderFn(config, check_device(device),
                        lambda t, keys: _frame_flat(scene_at(t), config,
                                                    impl, keys, mode))


class Renderer:
    """User-facing renderer: a config, the device it renders on, the frame
    route and its compiled frame step (``make_render_fn``).

    ``device`` is "cuda" (the default), "cuda:n" or "cpu": a CUDA renderer
    without a CUDA device raises instead of running on the CPU.
    ``fine_impl`` is "auto" (the default, = "dense"), "dense" (the JAX
    package's "xla" route) or "entries" (its "pallas" route); see the
    module doc.  The entries route's pairing mode is read from
    ``PIET_PAIR`` here, and every step of the renderer is built with it.
    """

    #: DeviceScene fields ``render_updated`` may restage, keyed by the
    #: Scene attribute that sources them.
    _DYNAMIC_FIELDS = ("points", "colors", "bboxes", "widths", "grads",
                       "clips", "flags")

    def __init__(self, config: RenderConfig, device="cuda",
                 fine_impl: str = "auto"):
        self.device = check_device(device)
        self.fine_impl = resolve_fine_impl(fine_impl)
        self._pair = step_pair_mode(self.fine_impl)
        self.config = config
        self.last_stats: Optional[Dict] = None
        self._render = make_render_fn(config, self.device, self.fine_impl)
        self._render_seq: Optional[RenderFn] = None
        self._render_packed: Optional[RenderFn] = None
        self._staged: Optional[DeviceScene] = None

    @classmethod
    def for_scene(cls, scene, width: int, height: int, *, device="cuda",
                  fine_impl: str = "auto", bucket: bool = True,
                  **config_kw) -> "Renderer":
        """Renderer with record capacities fitted to ``scene``
        (renderer/capacity.py; bucket=True leaves headroom)."""
        from .capacity import fit_capacities
        base = RenderConfig(width=width, height=height, **config_kw)
        return cls(fit_capacities(scene, base, bucket=bucket), device=device,
                   fine_impl=fine_impl)

    def prepare(self, scene) -> DeviceScene:
        """The scene staged as fresh tensors on the renderer's device."""
        return prepare_scene(scene, self.config, self.device)

    def render_device(self, dev: DeviceScene):
        """The eager reference frame: one frame of a staged scene, op by op
        (no graph), as (H, W) int32 RGBA8 bits and the stats tensors; no
        host synchronization.  A scene without ``seg_pre`` (a device
        animation frame) has its segments derived on the device."""
        cfg = self.config
        # The renderer's card is current: the kernels launch on its stream.
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            img, stats = render_slab(dev, cfg, tiles_y=cfg.tiles_y, row0=0,
                                     fine_impl=self.fine_impl,
                                     pair=self._pair)
        return img[:cfg.height, :cfg.width], stats

    def _finish(self, fn: RenderFn, x) -> torch.Tensor:
        """Run ``fn`` on ``x``, read its stats (one sync) into
        ``last_stats`` (ints, or lists of ints per frame for a sequence),
        check every frame's; return the image(s)."""
        flat = fn.flat(x)
        img, _ = fn.split(flat)
        vals = flat[..., -len(fn.keys):]
        if vals.ndim == 1:
            self.last_stats = dict(zip(fn.keys, vals.tolist()))
            self._check_capacity(self.last_stats)
        else:
            self.last_stats = dict(zip(fn.keys, vals.t().tolist()))
            self._check_capacity({k: sum(v)
                                  for k, v in self.last_stats.items()})
        return img

    def render_u32(self, scene) -> torch.Tensor:
        """Stage ``scene`` into the frame step's static inputs and run it:
        (H, W) int32 RGBA8 bits."""
        self._staged = self._render.stage(
            prepare_scene(scene, self.config, "cpu"))
        return self._finish(self._render, self._staged)

    def render(self, scene) -> np.ndarray:
        return self._rgba8(self.render_u32(scene))

    def _rgba8(self, img: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(img.cpu().numpy()).view(np.uint8).reshape(
            *img.shape[:-2], self.config.height, self.config.width, 4)

    def render_sequence(self, scenes) -> np.ndarray:
        """Render N scenes -> (N, H, W, 4) uint8: the scenes are staged
        together (``stack_scenes``) into the sequence step's static inputs
        and rendered in one step (``make_render_sequence_fn``).
        ``last_stats`` holds each stat per frame (lists); every frame's
        stats are checked, so a frame past capacity raises."""
        if self._render_seq is None:
            self._render_seq = make_render_sequence_fn(
                self.config, self.device, self.fine_impl)
        stacked = stack_scenes(scenes, self.config, "cpu")
        return self._rgba8(self._finish(self._render_seq, stacked))

    def packed_render_fn(self) -> RenderFn:
        """The packed-buffer frame step: a ``pack_scene`` buffer (int32
        bits) -> (img, stats), unpacked inside the step (as the JAX package
        jits ``unpack_scene`` with the render).  No host sync: a
        multi-frame caller checks capacities itself."""
        if self._render_packed is None:
            cfg, impl, mode = self.config, self.fine_impl, self._pair
            self._render_packed = RenderFn(
                cfg, self.device, lambda buf, keys: _frame_flat(
                    unpack_scene(buf, cfg), cfg, impl, keys, mode))
        return self._render_packed

    def render_packed_u32(self, scene) -> torch.Tensor:
        """Single-transfer render: pack the scene into one staging buffer
        on the host, copy it once into the packed step's static buffer,
        unpack and render in the step."""
        buf = torch.from_numpy(pack_scene(scene, self.config).view(np.int32))
        return self._finish(self.packed_render_fn(), buf)

    def render_updated(self, scene, fields=("points", "colors",
                                            "bboxes")) -> torch.Tensor:
        """Incremental re-render: copy only ``fields`` of ``scene`` into the
        static inputs staged by the last ``render``/``render_u32`` (every
        other tensor stays as staged), then run the step.  Topology (tags,
        offsets, counts, item count) must not have changed.  When a
        geometry field is dirty, the host segment stage is rebuilt for the
        updated scene and copied in too."""
        if self._staged is None:
            return self.render_u32(scene)
        cfg = self.config
        _check_scene_size(scene, cfg)
        dev = self._staged

        def put(dst: torch.Tensor, arr) -> None:
            dst.copy_(_host_tensor(_pad(np.asarray(arr), dst.shape[0])))

        geom_dirty = False
        for f in fields:
            if f not in self._DYNAMIC_FIELDS:
                raise ValueError(f"field {f!r} is not restageable")
            if f == "colors":
                put(dev.colors_u32, scene.colors)
                put(dev.colors_lin, decode_color_linear(scene.colors))
            else:
                put(getattr(dev, f), getattr(scene, f))
            geom_dirty |= f in ("points", "bboxes", "widths")
        if geom_dirty and dev.seg_pre is not None:
            from .segstage import build_seg_pre
            sp = build_seg_pre(scene, cfg)
            for f in SegPre._fields:
                put(getattr(dev.seg_pre, f), getattr(sp, f))
        return self._finish(self._render, dev)

    def _check_capacity(self, stats: Dict[str, int]) -> None:
        # The winding deltas ride the hit records, so the record
        # capacities and, on the dense route, the per-tile command
        # capacity are the ones a frame can exceed.
        for k in ("seg_overflow", "hit_overflow", "cand_overflow"):
            if stats[k] > 0:
                raise SceneCapacityError(
                    f"coarse capacity exceeded: {k}={stats[k]}; "
                    f"raise the corresponding RenderConfig limit")
        if stats.get("overflow_cmds", 0) > 0:
            raise SceneCapacityError(
                f"PTCL overflow: {stats['overflow_cmds']} commands "
                f"dropped; raise RenderConfig.cmd_capacity")
