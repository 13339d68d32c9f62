"""Viewport resize without a new graph.

Port of ``piet_tpu/renderer/resize.py``.  The reference handles
``drawableSizeWillChange`` as a runtime event: it reuses its compiled
pipelines and only re-allocates textures sized to the new drawable, with
one static maximum.  The JAX package compiles once for the maximum tile
grid; here the frame step (renderer.py::make_render_fn) is captured once,
as one CUDA graph, for the maximum tile grid, and any viewport that fits
is a replay of it and a crop on the host: ``n_compiles()`` stays 1 across
viewports.

Why this is exact: pixel coordinates in the whole pipeline are absolute
(tiles know their own x0/y0), so rendering a larger tile grid and
cropping gives the same pixels inside the crop -- tiles beyond the
viewport only add commands to tiles that are cropped away, and per-tile
state (backdrop prefix sums, bail analysis) is computed per tile row in
ascending column order (pinned by tests/test_torch_resize.py against
dedicated per-viewport renderers and the numpy oracle).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import RenderConfig
from .renderer import Renderer


class ResizableRenderer:
    """A renderer built once for a maximum viewport, rendering any smaller
    viewport from the same frame step.

    Usage:
        r = ResizableRenderer(RenderConfig(width=2048, height=2048))
        img_a = r.render(scene, 1024, 1024)   # captures (first use)
        img_b = r.render(scene, 1664, 1664)   # replays: no new graph

    The config's width/height set the maximum; record capacities are the
    config's (use :meth:`for_scene` to fit them to a scene at the maximum
    grid).  ``device`` and ``fine_impl`` are the ``Renderer``'s.
    """

    def __init__(self, config: RenderConfig, device="cuda",
                 fine_impl: str = "entries"):
        # Built at the full padded grid, so the step's crop is a no-op;
        # the per-viewport crop is a numpy slice on the host.
        self.max_width = config.padded_width
        self.max_height = config.padded_height
        self._config = dataclasses.replace(
            config, width=config.padded_width, height=config.padded_height)
        self._renderer = Renderer(self._config, device=device,
                                  fine_impl=fine_impl)

    @classmethod
    def for_scene(cls, scene, max_width: int, max_height: int, *,
                  device="cuda", fine_impl: str = "entries",
                  **config_kw) -> "ResizableRenderer":
        """Capacities fitted to ``scene`` at the maximum grid (bucketed,
        so moderate scene edits need no new graph either)."""
        from .capacity import fit_capacities
        base = RenderConfig(width=max_width, height=max_height, **config_kw)
        return cls(fit_capacities(scene, base, bucket=True), device=device,
                   fine_impl=fine_impl)

    @property
    def config(self) -> RenderConfig:
        return self._config

    @property
    def last_stats(self) -> Optional[dict]:
        return self._renderer.last_stats

    def n_compiles(self) -> int:
        """Input signatures the underlying frame step was built for -- on
        a CUDA device, the graphs it captured (the contract: 1 across
        resizes)."""
        return self._renderer._render.n_graphs()

    def render(self, scene, width: int, height: int) -> np.ndarray:
        """Render ``scene`` at ``width x height`` -> (H, W, 4) uint8 RGBA.

        Any viewport with width <= max_width and height <= max_height
        replays the one captured step."""
        if width > self.max_width or height > self.max_height:
            raise ValueError(
                f"viewport {width}x{height} exceeds the maximum "
                f"{self.max_width}x{self.max_height}; build a new "
                f"ResizableRenderer for larger viewports")
        if width <= 0 or height <= 0:
            raise ValueError("viewport must be positive")
        full = self._renderer.render(scene)
        return full[:height, :width]
