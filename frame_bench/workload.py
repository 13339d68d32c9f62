"""The one traffic generator: a cell's frames through the port's entry.

A traffic file (``traffic/<name>.json``) gives its ``entry`` and its
parameters.  The entry is the class ``Entry`` of the module
``entries/<entry>.py``, a :class:`Workload` that drives
``piet_tpu_torch`` with them: ``replay``, ``rebuild`` and ``anim`` are
there, and a new kind of entry is a new module.

Capacities are fitted as ``piet_tpu_torch/bench.py`` fits them (exact
counts, 32x128 tiles, ``cmd_capacity`` refitted), over every pose of the
cell, with the buckets' headroom where the traffic sets ``bucket``.
"""

from __future__ import annotations

import dataclasses

import torch

from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.scene.scene import Scene as PortScene

from . import scenes
from .spec import find_module

#: Stats words that count what a frame dropped: a frame with any of them
#: above zero failed.
OVERFLOW_KEYS = ("seg_overflow", "hit_overflow", "cand_overflow",
                 "overflow_cmds")

FIELDS = ("tags", "colors", "widths", "bboxes", "pt_offset", "n_pts",
          "points", "flags", "clips", "grads")


def port_scene(ref_scene) -> PortScene:
    """The same arrays as the port's host ``Scene``."""
    return PortScene(**{f: getattr(ref_scene, f) for f in FIELDS})


def envelope(cfg, fitted):
    return dataclasses.replace(cfg, **{
        f.name: max(getattr(c, f.name) for c in fitted)
        for f in dataclasses.fields(cfg)
        if f.name.startswith("max_") or f.name == "cmd_capacity"})


def stats_of(first_stat: torch.Tensor, keys) -> dict:
    """The frame's stats words, read in one copy: they sit after the
    image words of the step's one output, in ``keys`` order."""
    vals = first_stat.as_strided((len(keys),), (1,)).tolist()
    return dict(zip(keys, vals))


def failed(stats: dict) -> bool:
    return any(stats.get(k, 0) > 0 for k in OVERFLOW_KEYS)


class Workload:
    """One cell's frames.  ``frame(i)`` runs frame ``i`` and returns its
    output (no host wait beyond what the entry does itself);
    ``finish(out)`` waits for the frame by reading its stats and returns
    whether it failed; ``image(out)`` is its (H, W) int32 image.
    ``pose(i)`` is the pose frame ``i`` renders, and
    ``reference_scene(p)`` the host scene the reference renders for it."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = torch.device(device)
        self.width, self.height = config["width"], config["height"]
        self.n_poses = int(traffic.get("poses", 1))
        self.zoom = float(traffic.get("zoom", 0.0))
        self.bucket = bool(traffic.get("bucket", False))
        self.fine_impl = config["fine_impl"]
        self.base = scenes.make_scene(config, seed)
        self.base_cfg = RenderConfig(
            width=self.width, height=self.height,
            tile_width=config["tile_width"],
            tile_height=config["tile_height"],
            cmd_capacity=config["cmd_capacity"])

    def pose(self, i: int) -> int:
        return i % self.n_poses

    def image(self, out):
        return out

    def reference_scene(self, p: int):
        return self.base

    def close(self):
        """Drop the program's state (its graphs and buffers)."""


def entry_class(entry: str):
    """The :class:`Workload` subclass of entry ``entry``."""
    return find_module("entries", entry).Entry


def make_workload(config: dict, traffic: dict, seed: int, device):
    """The traffic file's entry, driven with its parameters."""
    return entry_class(traffic["entry"])(config, traffic, seed, device)
