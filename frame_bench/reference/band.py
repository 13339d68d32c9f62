"""The oracle over bands of tile rows, in worker processes.

``cpu_tile_scene`` and ``cpu_render_ptcl`` visit every tile in one
process: 15 s for the 4K tiger and 47 s for beziers_10k on one core.  A
tile's commands and pixels depend only on the scene and that tile, so
:func:`render` hands each worker every n-th tile row and puts the rows
back together: the same image, from the same frozen functions, in the
time of the slowest worker.  Besides the image it returns the live
commands of every tile (the work that ``metrics/fine_roofline.py``
counts) and each tile's bail colour.

The workers are plain child processes (``python3 -c`` running
:func:`serve`), each handed its job and returning its rows as a pickle
over its pipes, and each waited for before :func:`render` returns, on
every path out of it.  No ``multiprocessing`` pool is used: its spawn
context starts a resource tracker that outlives the pool until the
parent exits.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

from .config import RenderConfig
from .raster.cpu_fine import finish_pixels, render_tile, solid_pixels
from .raster.cpu_tiler import (_clip_tile, _fill_tile, _line_tile,
                               _poly_tile, _segments)
from .raster.ptcl import ARG_WORDS, TileCmdEncoder, assemble_ptcl
from .scene.scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL,
                          FLAG_EVEN_ODD, FLAG_FILL_CONT, FLAG_FILL_FINAL,
                          FLAG_IN_GROUP, FLAG_POP_LAYER, TAG_CIRCLE,
                          TAG_CLIP, TAG_FILL, TAG_LAYER, TAG_LINE, TAG_POLY,
                          TAG_POP)

F = np.float32


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bfloat16 (ties to even), kept as f32."""
    u = np.ascontiguousarray(x, F).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(F)


#: Per-pixel state precisions: "f32" is the oracle; "bf16" the control,
#: its colour, distance field and area rounded to bfloat16 after every
#: command.
STATE_ROUND = {"f32": None, "bf16": _bf16}


def _encode_tile(scene, segs, enc, x0, y0, tw, th):
    """The commands of one tile: the loop body of ``cpu_tile_scene``."""
    bb = scene.bboxes
    hit = np.nonzero((bb[:, 2] >= x0) & (bb[:, 0] < x0 + tw)
                     & (bb[:, 3] >= y0) & (bb[:, 1] < y0 + th))[0]
    for i in hit:
        tag = int(scene.tags[i])
        color = int(scene.colors[i])
        width = F(scene.widths[i])
        clip = tuple(scene.clips[i])
        if tag == TAG_CIRCLE:
            enc.circle(bb[i], clip=clip)
        elif tag == TAG_LINE:
            _line_tile(enc, segs[i], color, width, clip, x0, y0, tw, th)
        elif tag == TAG_FILL:
            fl = int(scene.flags[i])
            is_grad = fl & (FLAG_BRUSH_LINEAR | FLAG_BRUSH_RADIAL)
            _fill_tile(enc, segs[i], color, bool(fl & FLAG_EVEN_ODD), clip,
                       bool(fl & FLAG_IN_GROUP), x0, y0, tw, th,
                       grad=scene.grads[i] if is_grad else None,
                       radial=bool(fl & FLAG_BRUSH_RADIAL),
                       cont=bool(fl & FLAG_FILL_CONT),
                       final=bool(fl & FLAG_FILL_FINAL))
        elif tag == TAG_POLY:
            _poly_tile(enc, segs[i], color, width, clip, x0, y0, tw, th)
        elif tag == TAG_CLIP:
            _clip_tile(enc, segs[i], bool(scene.flags[i] & FLAG_EVEN_ODD),
                       x0, y0, tw, th)
        elif tag == TAG_LAYER:
            enc.begin_layer()
        elif tag == TAG_POP:
            if scene.flags[i] & FLAG_POP_LAYER:
                enc.end_layer(float(scene.widths[i]))
            else:
                enc.end_clip()


def _rows(job):
    """Worker: tile rows ``rows`` of ``scene`` -> (rows, pixel band per
    row, live commands as (tile, tag, args) arrays, bail colour per
    tile)."""
    scene, config, rows, precision = job
    rnd = STATE_ROUND[precision]
    tw, th = config.tile_width, config.tile_height
    segs = []
    for i in range(scene.n_items):
        off, n = int(scene.pt_offset[i]), int(scene.n_pts[i])
        segs.append(_segments(scene.points[off:off + n],
                              wrap=int(scene.tags[i]) in (TAG_FILL,
                                                          TAG_CLIP)))
    bands, tiles, tags, args, solid = [], [], [], [], []
    for ty in rows:
        encs = []
        for tx in range(config.tiles_x):
            enc = TileCmdEncoder(config.cmd_capacity)
            _encode_tile(scene, segs, enc, F(tx) * F(tw), F(ty) * F(th),
                         F(tw), F(th))
            encs.append(enc)
        ptcl = assemble_ptcl(encs, config.cmd_capacity)
        band = np.zeros((th, config.padded_width, 4), np.uint8)
        for tx in range(config.tiles_x):
            xs = tx * tw
            if ptcl.solid[tx]:
                band[:, xs:xs + tw] = solid_pixels(int(ptcl.solid[tx]), th, tw)
                continue
            n = int(ptcl.counts[tx])
            band[:, xs:xs + tw] = finish_pixels(render_tile(
                ptcl.tags[tx], ptcl.args[tx], n, xs, ty * th, th, tw,
                state_round=rnd))
            tiles.append(np.full(n, ty * config.tiles_x + tx, np.int32))
            tags.append(ptcl.tags[tx, :n])
            args.append(ptcl.args[tx, :n])
        bands.append(band)
        solid.append(ptcl.solid.copy())
    return rows, bands, tiles, tags, args, solid


#: The checkout's root, put first on a worker's path.
ROOT = str(Path(__file__).resolve().parents[2])


def serve() -> None:
    """Worker: one pickled job from stdin, its rows pickled to stdout."""
    job = pickle.load(sys.stdin.buffer)
    pickle.dump(_rows(job), sys.stdout.buffer, pickle.HIGHEST_PROTOCOL)
    sys.stdout.buffer.flush()


def _in_workers(jobs) -> list:
    """``_rows`` of every job, each in a child process of its own; every
    child has ended when this returns or raises."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            f"from {__name__} import serve; serve()")
    procs = []
    try:
        for _ in jobs:
            procs.append(subprocess.Popen(
                [sys.executable, "-B", "-c", code], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE))
        for p, job in zip(procs, jobs):
            pickle.dump(job, p.stdin, pickle.HIGHEST_PROTOCOL)
            p.stdin.close()
        parts = []
        for p in procs:
            out = p.stdout.read()
            if p.wait() != 0:
                raise RuntimeError(f"reference worker exited {p.returncode}")
            parts.append(pickle.loads(out))
        return parts
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                f.close()


def render(scene, config: RenderConfig, workers: int = 0,
           precision: str = "f32"):
    """The oracle image of ``scene`` under ``config`` and its work.

    Returns ``(image (height, width, 4) uint8, ptcl)``, ``ptcl`` a dict:
    ``tile``, ``tag`` (n,) int32 and ``args`` (n, 12) f32 of every live
    command in tile and list order, ``solid`` (T,) uint32 bail colours.
    ``workers`` processes (0: one per core, at most the tile rows), each
    started fresh and waited for before this returns."""
    n_rows = config.tiles_y
    workers = min(workers or os.cpu_count() or 1, n_rows)
    jobs = [(scene, config, list(range(w, n_rows, workers)), precision)
            for w in range(workers)]
    parts = [_rows(jobs[0])] if workers == 1 else _in_workers(jobs)
    th = config.tile_height
    img = np.zeros((config.padded_height, config.padded_width, 4), np.uint8)
    solid = np.zeros((config.tiles_y, config.tiles_x), np.uint32)
    tiles, tags, args = [np.zeros(0, np.int32)], [np.zeros(0, np.int32)], \
        [np.zeros((0, ARG_WORDS), F)]
    for rows, bands, p_tiles, p_tags, p_args, p_solid in parts:
        for ty, band, s in zip(rows, bands, p_solid):
            img[ty * th:(ty + 1) * th] = band
            solid[ty] = s
        tiles += p_tiles
        tags += p_tags
        args += p_args
    tile = np.concatenate(tiles)
    # A tile's commands are consecutive and in list order in its worker's
    # output: a stable sort by tile keeps that order.
    order = np.argsort(tile, kind="stable")
    ptcl = {"tile": tile[order], "tag": np.concatenate(tags)[order],
            "args": np.concatenate(args)[order], "solid": solid.reshape(-1)}
    return img[:config.height, :config.width], ptcl
