"""Least-time (roofline) model of a frame on one NVIDIA H100.

Port of ``piet_tpu/roofline.py``.  A frame's statistics (``Renderer.
last_stats``: record counts, live entries or commands) give the bytes
each stage must move and the f32 operations it must do; divided by the
card's peaks they give the least time the stage could take, and beside a
measured time its percent of that floor.

Peaks (NVIDIA's H100 SXM data sheet, 700 W): HBM at 3.35e12 B/s, and
67e12 f32 operations/s outside the tensor cores.  The data sheet counts
a fused multiply-add as two operations; the kernels are built with
``-fmad=false`` (kernels.py), so every multiply and add issues on its own
and the attainable rate is half: 33.5e12.  A card set below 700 W runs
slower, so every measured time is reported with its power limit.

Keys as in the JAX model, except the compute term: the TPU's VPU is not
the H100's ALU, so ``vpu_ops``/``ms_vpu`` are ``f32_ops``/``ms_f32`` here
(``bytes_moved``, ``ms_hbm``, ``ms_floor``, ``gbytes``, ``measured_ms``
and ``pct_of_roofline`` mean what they mean there).

Work model: the port's own work, counted from what this frame's data
needs (live records and entries; capacity padding is not counted), each
input read once and each output written once.  A floor is a lower bound:
a measured stage below its floor means the model over-counts.

* fine, entries route (kernel D, ``csrc/fine.cu``): each live entry's
  16-word row read once, the three per-tile words (first, count, present
  colour) read once, every pixel of the tile grid written once (the
  present composite is fused, so bailed and empty tiles are written by
  the kernel too).  Operations: the resolve of every pixel of a tile with
  entries (:data:`OPS_RESOLVE`); the entries' own commands are counted
  as none, since an EndClip or BeginLayer entry moves no float.  Tiles
  with entries are at least ``ceil(live_entries / max_tile_cmds)``: a
  live entry holds at least one command.
* fine, dense route (``csrc/fine_dense.cu``): each live command's 13
  words (a tag and 12 operands) and the per-tile count read once, every
  pixel written once; operations as above, from ``live_cmds``.
* coarse (``ops/coarse.py``): kernel A writes each live candidate's
  32-word row and its tile and ty words; kernel B reads each live
  segment's 27-word row and writes one 24-word record per hit
  (``csrc/hitfuse.cu``); every live record (hit or candidate) becomes a
  16-word row, written at assembly, read by the sorted gather and written
  into the entry stream; kernel C sorts one (key, value) pair of 8 bytes
  per live record, reading and writing each once on its cluster route
  (the pairs stay in shared memory between digit passes) and once per
  digit pass on its device-memory route, after an upsweep that reads
  every key once (``ops/sort.py::sort_plan``).  Operations: none counted
  (kernel B's tests are a few dozen per record, against the ~960 that
  its 96-byte record is worth at 10 operations a byte).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from .ops.coarse import sort_key_bounds
from .ops.sort import KEY_LIMIT, sort_plan

#: HBM bytes per second (H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
#: f32 operations per second outside the tensor cores, each multiply and
#: add on its own (``-fmad=false``): half the data sheet's 67e12.
F32_OPS_PER_S = 67e12 / 2

#: One 16-word entry row (``layout/entry_stream.py::ENTRY_WORDS``).
ENTRY_BYTES = 16 * 4
#: One dense PTCL command: a tag word and 12 operand words.
DENSE_CMD_BYTES = 13 * 4
#: Words per tile the entries kernel reads: first, n_entries, present.
TILE_WORDS = 3
#: Kernel B's hit record (``csrc/hitfuse.cu``, ``hitfuse.OUT_WORDS``).
HIT_RECORD_BYTES = 24 * 4
#: A segment row of the segment stage (``SegPre.seg_rows``: 27 words).
SEG_ROW_BYTES = 27 * 4
#: Kernel A's candidate record: 32 words, then its tile and ty words.
CAND_RECORD_BYTES = (32 + 2) * 4
#: A sort pair: an f32 key and an int32 value.
SORT_PAIR_BYTES = 8
#: Crossings of a live record's 16-word row: written at assembly, read by
#: the sorted gather, written into the entry stream.
ROW_CROSSINGS = 3

#: f32 operations per pixel of the resolve (``cmd_math.cuh::pack_rgba8``):
#: per channel, ``srgb_encode`` does a clamp (2), the linear branch (1),
#: the 8-step log polynomial (16), the exponent scale (2), floor and
#: fraction (2), the 5-step exp polynomial (10), the gamma branch (3)
#: and the scale to a code (1): 37, for 3 channels.  Only the arithmetic
#: every pixel runs is counted (no compare, select or conversion).
OPS_RESOLVE = 3 * 37


def _stat(stats: Dict, key: str) -> float:
    return float(np.asarray(stats.get(key, 0)).sum())


def fine_model(stats: Dict, *, tile_h: int, tile_w: int,
               n_tiles: int) -> Dict[str, float]:
    """The fine pass's floor: the entries route's when ``stats`` has
    ``live_entries``, else the dense route's (``live_cmds``)."""
    tile_px = tile_h * tile_w
    if "live_entries" in stats:
        units = _stat(stats, "live_entries")
        bytes_moved = units * ENTRY_BYTES + n_tiles * TILE_WORDS * 4
    else:
        units = _stat(stats, "live_cmds")
        bytes_moved = units * DENSE_CMD_BYTES + n_tiles * 4
    bytes_moved += n_tiles * tile_px * 4.0
    per_tile = max(_stat(stats, "max_tile_cmds"), 1.0)
    live_tiles = min(math.ceil(units / per_tile), n_tiles)
    ops = live_tiles * tile_px * float(OPS_RESOLVE)
    return _bound(bytes_moved, ops)


def sort_bytes(n_records: float, n_pairs: int,
               bounds: Sequence[int]) -> float:
    """Bytes kernel C moves for ``n_records`` live pairs of a sort of
    ``n_pairs`` (which picks the route) with key ``bounds``."""
    plan = sort_plan(n_pairs, bounds)
    crossings = 1 if plan.cluster else len(plan.passes)
    upsweep = 0 if plan.cluster else 4
    return n_records * (2 * SORT_PAIR_BYTES * crossings + upsweep)


def coarse_model(stats: Dict, *, max_hits: int, max_candidates: int,
                 max_deltas: int = 0,
                 sort_bounds: Optional[Sequence[int]] = None
                 ) -> Dict[str, float]:
    """The coarse pass's floor.  ``max_hits + max_candidates`` is the
    sort's size, which picks its route; ``sort_bounds`` are its key
    bounds (one key below 2^24 when not given).  ``max_deltas`` is
    accepted for the JAX signature: the winding deltas ride the hit
    records, so no record of their own is moved."""
    n_hits = _stat(stats, "n_hits")
    n_cand = _stat(stats, "n_candidates")
    n_segs = _stat(stats, "n_segments")
    records = n_hits + n_cand
    bounds = tuple(sort_bounds) if sort_bounds else (KEY_LIMIT,)
    bytes_moved = (n_segs * SEG_ROW_BYTES + n_hits * HIT_RECORD_BYTES
                   + n_cand * CAND_RECORD_BYTES
                   + records * ENTRY_BYTES * ROW_CROSSINGS
                   + sort_bytes(records, max_hits + max_candidates, bounds))
    return _bound(bytes_moved, 0.0)


def _bound(bytes_moved: float, f32_ops: float) -> Dict[str, float]:
    ms_hbm = bytes_moved / HBM_BYTES_PER_S * 1e3
    ms_f32 = f32_ops / F32_OPS_PER_S * 1e3
    return {
        "bytes_moved": bytes_moved,
        "f32_ops": f32_ops,
        "ms_hbm": ms_hbm,
        "ms_f32": ms_f32,
        "ms_floor": max(ms_hbm, ms_f32),
    }


def bound(n_bytes: float, n_ops: float = 0.0):
    """(least ms, what bounds it: "bytes" or "operations") for ``n_bytes``
    moved and ``n_ops`` f32 operations at the H100's peaks."""
    m = _bound(n_bytes, n_ops)
    return ((m["ms_hbm"], "bytes") if m["ms_hbm"] >= m["ms_f32"]
            else (m["ms_f32"], "operations"))


def frame_roofline(stats: Dict, config, coarse_ms: float | None,
                   fine_ms: float | None, total_ms: float) -> Dict:
    """The per-stage floors and, where a measured time is given, its
    percent of the floor: ``{"fine", "coarse", "frame"}``."""
    n_tiles = config.tiles_x * config.tiles_y
    fine = fine_model(stats, tile_h=config.tile_height,
                      tile_w=config.tile_width, n_tiles=n_tiles)
    coarse = coarse_model(stats, max_hits=config.max_hits,
                          max_candidates=config.max_candidates,
                          max_deltas=config.max_deltas,
                          sort_bounds=sort_key_bounds(config.n_tiles,
                                                    config.max_items))
    return {
        "fine": _stage(fine, fine_ms),
        "coarse": _stage(coarse, coarse_ms),
        "frame": _stage(_bound(fine["bytes_moved"] + coarse["bytes_moved"],
                               fine["f32_ops"] + coarse["f32_ops"]),
                        total_ms),
    }


def _stage(model: Dict[str, float], measured_ms: float | None) -> Dict:
    # Five decimals: the card's floors are microseconds.
    d = {"ms_floor": round(model["ms_floor"], 5),
         "ms_hbm": round(model["ms_hbm"], 5),
         "ms_f32": round(model["ms_f32"], 5),
         "gbytes": round(model["bytes_moved"] / 1e9, 6)}
    if measured_ms is not None and measured_ms > 0:
        d["measured_ms"] = round(measured_ms, 5)
        d["pct_of_roofline"] = round(100 * model["ms_floor"] / measured_ms,
                                     2)
    return d
