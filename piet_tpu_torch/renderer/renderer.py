"""Host orchestration: stage a scene, bin it, rasterize it.

Port of ``piet_tpu/renderer/renderer.py``.  The scene is staged once as
padded tensors on a device (``prepare_scene``, with the numpy host segment
stage ``build_seg_pre`` unless a device animation derives segments per
frame), then a frame takes one of two routes (``fine_impl``):

* ``"entries"`` (the default; the JAX package's ``"pallas"`` route):
  ``coarse_rasterize`` -> ``fine_rasterize_entries``, the present
  composite fused into the fine pass's empty tiles;
* ``"dense"`` (the JAX package's portable ``"xla"`` route):
  ``coarse_rasterize(output="dense")`` -> ``fine_rasterize_xla`` on the
  (T, CAP) PTCL, then the present composite: bailed tiles take their
  solid colour's bytes.

PyTorch runs eagerly; a frame synchronizes once, when the capacity
statistics are read.  Beside ``render``/``render_u32``: ``render_sequence``
(a list of scenes, one staged frame after another), the single-buffer
staging of ``pack_scene``/``unpack_scene`` (``render_packed_u32``), and
``render_updated`` (restage only dirty fields of the last staged scene).

Usage:
    r = Renderer.for_scene(scene, 1664, 1664)   # device="cuda" by default
    image = r.render(scene)        # (H, W, 4) uint8 RGBA
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..scene.color import decode_color_linear

from ..ops.coarse import DeviceScene, SegPre, coarse_rasterize
from ..ops.fine import fine_rasterize_entries
from ..ops.fine_xla import fine_rasterize_xla

#: The two frame routes; see the module doc.
FINE_IMPLS = ("entries", "dense")


class SceneCapacityError(ValueError):
    pass


def _to_device(arr, device) -> torch.Tensor:
    """numpy array -> tensor on ``device``; uint32 travels as int32 bits."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


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

    def pad(arr, n):
        out = np.zeros((n,) + arr.shape[1:], arr.dtype)
        out[:arr.shape[0]] = arr
        return out

    NI = config.max_items
    host = DeviceScene(
        tags=pad(scene.tags, NI), colors_u32=pad(scene.colors, NI),
        colors_lin=pad(decode_color_linear(scene.colors), NI),
        widths=pad(scene.widths, NI), bboxes=pad(scene.bboxes, NI),
        pt_offset=pad(scene.pt_offset, NI), n_pts=pad(scene.n_pts, NI),
        points=pad(scene.points, config.max_points),
        flags=pad(scene.flags, NI), clips=pad(scene.clips, NI),
        grads=pad(scene.grads, NI), n_items=np.int32(scene.n_items),
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
    """Frame ``i`` of a ``stack_scenes`` DeviceScene (views)."""
    return DeviceScene(*(x[i] for x in stacked[:-1]),
                       seg_pre=SegPre(*(x[i] for x in stacked.seg_pre)))


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


def render_slab(scene: DeviceScene, config: RenderConfig, *, tiles_y: int,
                row0: int = 0, fine_impl: str = "entries"):
    """Coarse + fine + present for ``tiles_y`` tile rows from ``row0`` by
    the ``fine_impl`` route.  Returns (slab image as int32 RGBA8 bits,
    stats of 0-d tensors)."""
    tiles_x = config.tiles_x
    th, tw = config.tile_height, config.tile_width
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tw, tile_h=th,
              max_segments=config.max_segments, max_hits=config.max_hits,
              max_candidates=config.max_candidates, row0=row0)
    if fine_impl == "entries":
        coarse = coarse_rasterize(scene, **kw)
        img = fine_rasterize_entries(
            coarse.first, coarse.n_entries,
            _solid_to_present_u32(coarse.solid), coarse.stream, row0,
            tile_h=th, tile_w=tw, tiles_x=tiles_x)
        stats = {"max_tile_cmds": coarse.counts.max(),
                 "bail_tiles": (coarse.solid != 0).sum(), **coarse.diag}
        return img, stats
    if fine_impl != "dense":
        raise ValueError(f"fine_impl must be one of {FINE_IMPLS}, got "
                         f"{fine_impl!r}")
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


class Renderer:
    """User-facing renderer: a config, the device it renders on and the
    frame route.

    ``device`` is "cuda" (the default), "cuda:n" or "cpu": a CUDA renderer
    without a CUDA device raises instead of running on the CPU.
    ``fine_impl`` is "entries" (the default; the JAX package's "pallas"
    route) or "dense" (its "xla" route); see the module doc.
    """

    #: DeviceScene fields ``render_updated`` may restage, keyed by the
    #: Scene attribute that sources them.
    _DYNAMIC_FIELDS = ("points", "colors", "bboxes", "widths", "grads",
                       "clips", "flags")

    def __init__(self, config: RenderConfig, device="cuda",
                 fine_impl: str = "entries"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda'): CUDA is not "
                               "available")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device!r}")
        if fine_impl not in FINE_IMPLS:
            raise ValueError(f"fine_impl must be one of {FINE_IMPLS}, got "
                             f"{fine_impl!r}")
        self.config = config
        self.device = dev
        self.fine_impl = fine_impl
        self.last_stats: Optional[Dict[str, int]] = None
        self._staged: Optional[DeviceScene] = None

    @classmethod
    def for_scene(cls, scene, width: int, height: int, *, device="cuda",
                  fine_impl: str = "entries", bucket: bool = True,
                  **config_kw) -> "Renderer":
        """Renderer with record capacities fitted to ``scene``
        (renderer/capacity.py; bucket=True leaves headroom)."""
        from .capacity import fit_capacities
        base = RenderConfig(width=width, height=height, **config_kw)
        return cls(fit_capacities(scene, base, bucket=bucket), device=device,
                   fine_impl=fine_impl)

    def prepare(self, scene) -> DeviceScene:
        return prepare_scene(scene, self.config, self.device)

    def render_device(self, dev: DeviceScene):
        """One frame of a staged scene: (H, W) int32 RGBA8 bits and the
        stats tensors; no host synchronization.  A scene without
        ``seg_pre`` (a device animation frame) has its segments derived
        on the device."""
        cfg = self.config
        img, stats = render_slab(dev, cfg, tiles_y=cfg.tiles_y, row0=0,
                                 fine_impl=self.fine_impl)
        return img[:cfg.height, :cfg.width], stats

    def _finish(self, dev: DeviceScene) -> torch.Tensor:
        """Render a staged scene, read its stats (one sync), check them."""
        img, stats = self.render_device(dev)
        keys = list(stats)
        vals = torch.stack([stats[k].to(torch.int64) for k in keys]).tolist()
        self.last_stats = dict(zip(keys, vals))
        self._check_capacity(self.last_stats)
        return img

    def render_u32(self, scene) -> torch.Tensor:
        self._staged = self.prepare(scene)
        return self._finish(self._staged)

    def render(self, scene) -> np.ndarray:
        return self._rgba8(self.render_u32(scene))

    def _rgba8(self, img: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(img.cpu().numpy()).view(np.uint8).reshape(
            *img.shape[:-2], self.config.height, self.config.width, 4)

    def render_sequence(self, scenes) -> np.ndarray:
        """Render N scenes -> (N, H, W, 4) uint8: the scenes are staged
        together (``stack_scenes``) and rendered one frame after another.
        ``last_stats`` holds each stat per frame (lists); every frame's
        stats are checked, so a frame past capacity raises."""
        stacked = stack_scenes(scenes, self.config, self.device)
        imgs, per_frame = [], []
        for i in range(len(scenes)):
            img, stats = self.render_device(_frame_of(stacked, i))
            imgs.append(img)
            per_frame.append(stats)
        keys = list(per_frame[0])
        vals = torch.stack([torch.stack([st[k].to(torch.int64)
                                         for st in per_frame])
                            for k in keys]).tolist()
        self.last_stats = dict(zip(keys, vals))
        self._check_capacity({k: sum(v) for k, v in self.last_stats.items()})
        return self._rgba8(torch.stack(imgs))

    def packed_render_fn(self):
        """``buf -> (img, stats)``: unpack a ``pack_scene`` buffer (int32
        bits on the renderer's device) and render it; no host sync, so a
        multi-frame caller checks capacities itself."""
        cfg = self.config

        def render_packed(buf: torch.Tensor):
            return self.render_device(unpack_scene(buf, cfg))

        return render_packed

    def render_packed_u32(self, scene) -> torch.Tensor:
        """Single-transfer render: pack the scene into one staging buffer
        on the host, copy it once, unpack it on the device and render."""
        buf = pack_scene(scene, self.config).view(np.int32)
        return self._finish(unpack_scene(
            torch.from_numpy(buf).to(self.device), self.config))

    def render_updated(self, scene, fields=("points", "colors",
                                            "bboxes")) -> torch.Tensor:
        """Incremental re-render: restage only ``fields`` of the scene
        staged by the last ``render``/``render_u32``, reusing every other
        tensor.  Topology (tags, offsets, counts, item count) must not have
        changed.  When a geometry field is dirty, the host segment stage
        is rebuilt for the updated scene."""
        if self._staged is None:
            return self.render_u32(scene)
        cfg = self.config
        _check_scene_size(scene, cfg)

        def pad(arr, n):
            out = np.zeros((n,) + arr.shape[1:], arr.dtype)
            out[:arr.shape[0]] = arr
            return _to_device(out, self.device)

        dev, geom_dirty = self._staged, False
        for f in fields:
            if f not in self._DYNAMIC_FIELDS:
                raise ValueError(f"field {f!r} is not restageable")
            if f == "points":
                dev = dev._replace(points=pad(scene.points, cfg.max_points))
            elif f == "colors":
                dev = dev._replace(
                    colors_u32=pad(scene.colors, cfg.max_items),
                    colors_lin=pad(decode_color_linear(scene.colors),
                                   cfg.max_items))
            else:
                dev = dev._replace(**{f: pad(getattr(scene, f),
                                             cfg.max_items)})
            geom_dirty |= f in ("points", "bboxes", "widths")
        if geom_dirty and dev.seg_pre is not None:
            from .segstage import build_seg_pre
            dev = dev._replace(seg_pre=_stage_seg_pre(
                build_seg_pre(scene, cfg), self.device))
        self._staged = dev
        return self._finish(dev)

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
