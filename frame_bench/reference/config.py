"""Render configuration for piet-tpu.

Mirrors the reference's compile-time configuration header
(reference: TestApp/PietShaderTypes.h:17-32), but as a runtime dataclass so a
single build supports many tile geometries, and so benchmark configs are
driven by data instead of recompiles.

TPU-first choices vs the reference:

* The reference uses 16x16-pixel tiles because that is the natural Metal
  threadgroup shape.  On TPU the natural fine-raster block is a multiple of
  the VPU register tile (8 sublanes x 128 lanes).  The default is
  **32x128-pixel tiles**: measured on hardware, taller tiles more than pay
  for their extra per-command vector work by shrinking the record counts
  (fewer (segment, tile) crossings) and the per-tile interpreter overhead
  -- 4K tiger: 18.8 ms at 16x128 vs 14.0 ms at 32x128 (8x128 and 64x128
  are slower).  The binning/coverage algorithm is tile-size-parametric,
  so any power-of-two geometry works (16x16 reproduces the reference).
* PTCL capacity is an explicit array dimension (``cmd_capacity``) instead of
  a byte budget; overflow is *detected and reported* (the reference's 4096-
  byte cap silently corrupts -- PietShaderTypes.h:24-27 "for production we'd
  want a mechanism to overflow").
"""

from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Geometry/capacity configuration for one compiled renderer.

    All sizes are static under ``jax.jit``; changing any field triggers a
    recompile (by design -- shapes must be static for XLA).
    """

    # Viewport, in pixels. Padded internally to a whole number of tiles.
    width: int = 1024
    height: int = 1024

    # Fine-raster tile size in pixels (reference: 16x16 via
    # PietShaderTypes.h:17-18). TPU default: 32 rows x 128 cols (see module
    # docstring for the measured rationale).
    tile_height: int = 32
    tile_width: int = 128

    # Max commands per tile PTCL (reference: 4096 B / 24 B = 170 cmds,
    # PietShaderTypes.h:24-27). Must be a multiple of the fine kernel's DMA
    # chunk (128 commands) so per-tile command lists stream in whole chunks;
    # this also keeps the flattened (tiles, cap * 8) f32 arg array
    # 128-lane-aligned.
    cmd_capacity: int = 384

    # Capacity buckets for scene padding (recompilation trap avoidance,
    # SURVEY.md section 7 "hard parts" item 6).
    max_items: int = 1 << 11      # scene items (fills/polys/lines/circles)
    max_points: int = 1 << 16     # flattened points across all items
    max_segments: int = 1 << 16   # derived segments (points incl. fill wrap)

    # Capacity for expanded (segment x tile) hit records and per-(item,tile)
    # candidate records in the coarse/binning pass.  Defaults are sized for
    # ~1024^2 scenes of a few thousand items; coarse passes do fixed-shape
    # work over these CAPACITIES every frame, and the Pallas sort's compile
    # scales with max_hits (ops/sort.py::PALLAS_SORT_MAX), so oversizing
    # costs both compile and frame time.  Undersizing fails loud
    # (SceneCapacityError); ``Renderer.for_scene`` fits exact counts.
    # (The old 1<<20 hits default compiled >30 min -- the round-3
    # "exactness hang", tools/onchip_r3.log.)
    max_hits: int = 1 << 18
    max_candidates: int = 1 << 16

    # Capacity for per-row winding (backdrop) delta records.
    max_deltas: int = 1 << 17

    def __post_init__(self):
        if self.cmd_capacity % 128:
            raise ValueError("cmd_capacity must be a multiple of 128")
        if self.tile_width <= 0 or self.tile_height <= 0:
            raise ValueError("tile size must be positive")

    # -- derived tile-grid geometry -------------------------------------
    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_width)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_height)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_width

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_height

    def with_viewport(self, width: int, height: int) -> "RenderConfig":
        return dataclasses.replace(self, width=width, height=height)


#: Reference-compatible configuration: 16x16 tiles, 170-cmd PTCL, used by the
#: parity test-suite so our CPU tiler can be compared against the reference's
#: exact tiling geometry (PietShaderTypes.h:17-27).
REFERENCE_CONFIG = RenderConfig(tile_height=16, tile_width=16, cmd_capacity=256)

# Scene-level constants shared with the reference implementation.
TOLERANCE: float = 0.1          # flattening tolerance (src/lib.rs:330)
THIN_LINE: float = 0.7          # thin-stroke clamp width (src/lib.rs:351)
TIGER_SCALE: float = 8.0        # demo scene scale (src/lib.rs:287)
