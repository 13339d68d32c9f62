"""Host orchestration: stage a scene, bin it, rasterize it.

Port of ``piet_tpu/renderer/renderer.py`` on the entry-stream path.  The
scene is staged once as padded tensors on an explicit device
(``prepare_scene``; the host segment stage comes from the JAX package's
numpy ``build_seg_pre``), then a frame is ``coarse_rasterize`` ->
``fine_rasterize_entries`` with the present composite fused into the fine
pass's empty tiles.  PyTorch runs eagerly; a frame synchronizes once, when
the capacity statistics are read.

Usage:
    r = Renderer.for_scene(scene, 1664, 1664, device="cuda")
    image = r.render(scene)        # (H, W, 4) uint8 RGBA
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from piet_tpu.config import RenderConfig
from piet_tpu.scene.color import decode_color_linear

from ..ops.coarse import DeviceScene, SegPre, coarse_rasterize
from ..ops.fine import fine_rasterize_entries


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
    seg_pre = None
    if sp is not None:
        seg_pre = SegPre(*(_to_device(getattr(sp, f), device)
                           for f in SegPre._fields))
    fields = {f: _to_device(getattr(leaves, f), device)
              for f in DeviceScene._fields if f not in ("n_items", "seg_pre")}
    n_items = torch.tensor(int(np.asarray(leaves.n_items)), dtype=torch.int32,
                           device=device)
    return DeviceScene(n_items=n_items, seg_pre=seg_pre, **fields)


def prepare_scene(scene, config: RenderConfig, device) -> DeviceScene:
    """Pad an SoA scene into capacity-sized tensors on ``device``, with the
    host-precomputed segment stage (renderer/segstage.py)."""
    from piet_tpu.renderer.segstage import build_seg_pre

    ni, np_ = scene.n_items, scene.n_points
    if ni > config.max_items:
        raise SceneCapacityError(f"{ni} items > max_items {config.max_items}")
    if np_ > config.max_points:
        raise SceneCapacityError(
            f"{np_} points > max_points {config.max_points}")

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
        grads=pad(scene.grads, NI), n_items=np.int32(ni),
        seg_pre=build_seg_pre(scene, config))
    return device_scene_from_numpy(host, device)


def _solid_to_present_u32(solid: torch.Tensor) -> torch.Tensor:
    """Logical 0xRRGGBBAA bits -> packed framebuffer bits (R in the low
    byte): the raw sRGB bytes of the present fast path."""
    r = (solid >> 24) & 0xFF
    g = (solid >> 16) & 0xFF
    b = (solid >> 8) & 0xFF
    a = solid & 0xFF
    return r | (g << 8) | (b << 16) | (a << 24)


def render_slab(scene: DeviceScene, config: RenderConfig, *, tiles_y: int,
                row0: int = 0):
    """Coarse + fine + present for ``tiles_y`` tile rows from ``row0``.
    Returns (slab image as int32 RGBA8 bits, stats of 0-d tensors)."""
    tiles_x = config.tiles_x
    coarse = coarse_rasterize(
        scene, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=config.tile_width,
        tile_h=config.tile_height, max_segments=config.max_segments,
        max_hits=config.max_hits, max_candidates=config.max_candidates,
        row0=row0)
    img = fine_rasterize_entries(
        coarse.first, coarse.n_entries, _solid_to_present_u32(coarse.solid),
        coarse.stream, row0, tile_h=config.tile_height,
        tile_w=config.tile_width, tiles_x=tiles_x)
    stats = {"max_tile_cmds": coarse.counts.max(),
             "bail_tiles": (coarse.solid != 0).sum(), **coarse.diag}
    return img, stats


class Renderer:
    """User-facing renderer: a config and the device it renders on.

    ``device`` is required ("cpu" or "cuda[:n]"): a CUDA renderer without a
    CUDA device raises instead of running on the CPU.
    """

    def __init__(self, config: RenderConfig, device):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda'): CUDA is not "
                               "available")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device!r}")
        self.config = config
        self.device = dev
        self.last_stats: Optional[Dict[str, int]] = None

    @classmethod
    def for_scene(cls, scene, width: int, height: int, *, device,
                  bucket: bool = True, **config_kw) -> "Renderer":
        """Renderer with record capacities fitted to ``scene``
        (renderer/capacity.py; bucket=True leaves headroom)."""
        from piet_tpu.renderer.capacity import fit_capacities
        base = RenderConfig(width=width, height=height, **config_kw)
        return cls(fit_capacities(scene, base, bucket=bucket), device=device)

    def prepare(self, scene) -> DeviceScene:
        return prepare_scene(scene, self.config, self.device)

    def render_device(self, dev: DeviceScene):
        """One frame of a staged scene: (H, W) int32 RGBA8 bits and the
        stats tensors; no host synchronization."""
        cfg = self.config
        img, stats = render_slab(dev, cfg, tiles_y=cfg.tiles_y, row0=0)
        return img[:cfg.height, :cfg.width], stats

    def render_u32(self, scene) -> torch.Tensor:
        img, stats = self.render_device(self.prepare(scene))
        keys = list(stats)
        vals = torch.stack([stats[k].to(torch.int64) for k in keys]).tolist()
        self.last_stats = dict(zip(keys, vals))
        self._check_capacity(self.last_stats)
        return img

    def render(self, scene) -> np.ndarray:
        img = self.render_u32(scene).cpu().numpy()
        return np.ascontiguousarray(img).view(np.uint8).reshape(
            self.config.height, self.config.width, 4)

    def _check_capacity(self, stats: Dict[str, int]) -> None:
        # The entry stream has no per-tile command capacity and the
        # winding deltas ride the hit records, so the record capacities
        # are the only ones a frame can exceed.
        for k in ("seg_overflow", "hit_overflow", "cand_overflow"):
            if stats[k] > 0:
                raise SceneCapacityError(
                    f"coarse capacity exceeded: {k}={stats[k]}; "
                    f"raise the corresponding RenderConfig limit")
