"""Row-slab rendering over a 1-D sequence of devices.

Port of ``piet_tpu/parallel/sharding.py``.  The tile grid is cut by tile
rows: mesh position ``d`` of ``N`` renders rows ``[d * rows, (d + 1) *
rows)`` with the whole pipeline (renderer/renderer.py::render_slab) at
``row0 = d * rows`` in absolute pixel coordinates, so each slab is
bitwise the one-slab frame's rows.  The scene is replicated and its
segment stage derived on the device for each slab (``seg_pre=None``: a
host stage covers the whole viewport).  Capacities (``max_hits`` and the
rest) apply per slab.  ``interleave = B`` gives position ``d`` the B
blocks ``d, d + N, d + 2N, ...`` of ``rows / B`` tile rows each, so a
band of heavy rows spreads over every position; ``max_tile_cmds`` is then
the largest over a position's blocks and every other stat their sum.

The mesh is a sequence of torch devices, e.g. ``["cuda:0", "cuda:1"]``,
``["cuda:0"] * 4`` or ``["cpu"] * 8``.  Positions on one device run in
turn inside one step of that device: on a card one CUDA graph
(renderer/graph.py::CapturedStep, which makes its card the current device
while it captures and replays, so the kernels launch on that card's
stream) that renders all of its slabs, on the CPU eagerly.  A frame is
one replay per device, then the slabs are gathered on the first device.
The entries route's pairing mode is read from ``PIET_PAIR`` when the step
is built, as for every frame step (renderer.py::step_pair_mode).

No ``torch.distributed``: the JAX version is one controller whose only
collective is the final gather of the framebuffer, and a process group
would add processes that carry no traffic; the gather is a device copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import RenderConfig
from ..renderer.graph import CapturedStep
from ..renderer.renderer import (SceneCapacityError, check_device,
                                 prepare_scene, render_slab,
                                 resolve_fine_impl, step_pair_mode)

#: Stats of a slab that a frame can exceed; each is summed over a
#: position's blocks (``overflow_cmds`` only on the dense route).
_OVERFLOWS = ("seg_overflow", "hit_overflow", "cand_overflow",
              "overflow_cmds")


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index ("cuda" is the current card), so that
    "cuda" and "cuda:0" are one mesh device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardedRenderFn:
    """The sharded frame step: ``fn(scene) -> (img, stats)``.

    ``scene`` is a DeviceScene on any device (its ``seg_pre`` is not
    read).  With ``interleave == 1`` ``img`` is the padded framebuffer
    (tiles_y * tile_h, tiles_x * tile_w) int32; with ``interleave = B >
    1`` it is (N * B, block_h, padded width), position-major (position
    d's blocks first).  ``stats`` maps each stat to an (N,) int32 tensor,
    one per mesh position.  Both lie on the first device."""

    def __init__(self, config: RenderConfig, devices: Sequence,
                 fine_impl: str = "auto", interleave: int = 1):
        self.devices = [_indexed(check_device(d)) for d in devices]
        ndev = len(self.devices)
        if ndev == 0:
            raise ValueError("expected at least one device")
        if config.tiles_y % ndev:
            raise ValueError(
                f"tiles_y={config.tiles_y} not divisible by mesh size "
                f"{ndev}")
        rows = config.tiles_y // ndev
        if interleave > 1 and rows % interleave:
            raise ValueError(
                f"rows-per-device {rows} not divisible by "
                f"interleave {interleave}")
        self.config = config
        self.interleave = max(interleave, 1)
        self.fine_impl = resolve_fine_impl(fine_impl)
        self._pair = step_pair_mode(self.fine_impl)
        self.block_rows = rows // self.interleave
        self.keys: List[str] = []
        # Mesh positions by device, in mesh order.
        self._groups: Dict[torch.device, List[int]] = {}
        for d, dv in enumerate(self.devices):
            self._groups.setdefault(dv, []).append(d)
        self._steps = {dv: CapturedStep(
            lambda scene, pos=tuple(pos): self._slabs(scene, pos), dv)
            for dv, pos in self._groups.items()}

    def blocks(self, d: int) -> List[int]:
        """The global blocks of ``block_rows`` tile rows that position
        ``d`` renders, in order."""
        n = len(self.devices)
        return [d + i * n for i in range(self.interleave)]

    def _slabs(self, scene, positions) -> torch.Tensor:
        """Every block of ``positions``, in turn: the block images' words,
        then each position's stats, as one int32 vector."""
        cfg, k = self.config, self.block_rows
        scene = scene._replace(seg_pre=None)
        imgs, stats = [], []
        for d in positions:
            per = []
            for b in self.blocks(d):
                img, st = render_slab(scene, cfg, tiles_y=k, row0=b * k,
                                      fine_impl=self.fine_impl,
                                      pair=self._pair)
                imgs.append(img.reshape(-1))
                per.append(st)
            self.keys[:] = list(per[0])
            stats.append(torch.stack([
                (torch.stack([st[n] for st in per]).max() if n ==
                 "max_tile_cmds" else torch.stack([st[n] for st in per])
                 .sum()).to(torch.int32) for n in self.keys]))
        return torch.cat(imgs + stats)

    def n_graphs(self) -> int:
        return sum(s.n_graphs() for s in self._steps.values())

    def stage(self, scene):
        """Copy ``scene`` into the static inputs of the first device's
        step and return them: handed back, they are not copied again
        (on a one-device mesh, a frame then copies no input)."""
        return self._steps[self.devices[0]].stage(scene)

    def __call__(self, scene):
        cfg, k = self.config, self.block_rows
        block_px = k * cfg.tile_height * cfg.padded_width
        n_blocks = self.interleave
        out = {dv: step(scene) for dv, step in self._steps.items()}
        first = self.devices[0]
        blocks: List[Optional[torch.Tensor]] = [None] * (
            len(self.devices) * n_blocks)
        stats: List[Optional[torch.Tensor]] = [None] * len(self.devices)
        for dv, pos in self._groups.items():
            flat = out[dv].to(first)
            n_img = len(pos) * n_blocks * block_px
            st = flat[n_img:].reshape(len(pos), -1)
            for j, d in enumerate(pos):
                for i in range(n_blocks):
                    o = (j * n_blocks + i) * block_px
                    blocks[d * n_blocks + i] = flat[o:o + block_px]
                stats[d] = st[j]
        img = torch.stack(blocks).reshape(
            len(blocks), k * cfg.tile_height, cfg.padded_width)
        if n_blocks == 1:
            img = img.reshape(cfg.padded_height, cfg.padded_width)
        st = torch.stack(stats)
        return img, {n: st[:, i] for i, n in enumerate(self.keys)}


def make_sharded_render_fn(config: RenderConfig, devices: Sequence,
                           fine_impl: str = "auto",
                           interleave: int = 1) -> ShardedRenderFn:
    """The sharded frame step over ``devices`` (a 1-D mesh); see
    :class:`ShardedRenderFn` and the module doc.  ``fine_impl`` is as for
    ``renderer.make_render_fn``."""
    return ShardedRenderFn(config, devices, fine_impl, interleave)


class ShardedRenderer:
    """Row-slab renderer over a 1-D sequence of devices.

    Usage:
        r = ShardedRenderer(config, ["cuda:0"] * 4)
        image = r.render(scene)      # (H, W, 4) uint8, gathered to host
    """

    def __init__(self, config: RenderConfig, devices: Sequence,
                 fine_impl: str = "auto", interleave: int = 1):
        self.config = config
        self.devices = list(devices)
        self.interleave = interleave
        self._render = make_sharded_render_fn(config, self.devices,
                                              fine_impl, interleave)
        self.last_stats: Optional[Dict[str, np.ndarray]] = None

    def render_u32(self, scene) -> torch.Tensor:
        """Stage ``scene`` (no host segment stage) and render it: the
        sharded step's image, on the first device."""
        dev = prepare_scene(scene, self.config, "cpu", seg_pre=False)
        img, stats = self._render(dev)
        self.last_stats = {k: v.cpu().numpy() for k, v in stats.items()}
        self._check_capacity()
        return img

    def render(self, scene) -> np.ndarray:
        img = np.ascontiguousarray(self.render_u32(scene).cpu().numpy())
        if self.interleave > 1:
            # (N*B, kh, W) position-major blocks: global block g sits at
            # (d = g % N, i = g // N); reorder to global order.
            ndev = len(self.devices)
            nb, kh, w = img.shape
            img = (img.reshape(ndev, nb // ndev, kh, w)
                   .transpose(1, 0, 2, 3).reshape(nb * kh, w))
        return np.ascontiguousarray(img).view(np.uint8).reshape(
            self.config.padded_height, self.config.padded_width,
            4)[:self.config.height, :self.config.width]

    def _check_capacity(self) -> None:
        s = self.last_stats
        for k in _OVERFLOWS:
            if k in s and int(s[k].sum()) > 0:
                raise SceneCapacityError(
                    f"coarse capacity exceeded on some device: {k}="
                    f"{s[k].tolist()}; raise the RenderConfig limit")
