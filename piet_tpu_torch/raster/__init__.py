"""CPU golden rasterizer: the correctness oracle for the device kernels."""

from .ptcl import (ARG_WORDS, CMD_BAIL, CMD_CIRCLE, CMD_DRAW_FILL, CMD_END,
                   CMD_FILL, CMD_FILL_EDGE, CMD_LINE, CMD_SOLID, CMD_STROKE,
                   Ptcl, TileCmdEncoder, assemble_ptcl)
from .cpu_tiler import cpu_tile_scene
from .cpu_fine import (cpu_render_ptcl, cpu_render_scene, finish_pixels,
                       render_tile, solid_pixels)

__all__ = [
    "Ptcl", "TileCmdEncoder", "assemble_ptcl", "cpu_tile_scene",
    "cpu_render_ptcl", "cpu_render_scene", "render_tile", "finish_pixels",
    "solid_pixels", "ARG_WORDS", "CMD_END", "CMD_CIRCLE", "CMD_LINE",
    "CMD_FILL", "CMD_STROKE", "CMD_FILL_EDGE", "CMD_DRAW_FILL", "CMD_SOLID",
    "CMD_BAIL",
]
