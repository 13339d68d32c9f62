"""Synthetic entry streams, unpaired and paired, for holding kernel D's
two instantiations against their plain version and the numpy oracle: the
entry sequences at which the paired instantiation changes course.

:func:`synth_entry_streams` builds, from a seed with numpy, the command
lists of a grid of six tiles and three entry streams of the same
commands (the format of ``ops/coarse.py``'s entries route):

* ``"off"``: one record an entry (a line; a plain fill; a fill edge with
  or without its slot-1 fill; a tail command with its 12 operand words),
  its ``W_RUN`` words set as the coarse pass sets them;
* ``"compact"``: adjacent fills, and adjacent lines, of one path merged
  into F2 and L2 entries, pairs (0, 1), (2, 3), ... of each path, as
  ``ops/pairing.py`` merges them; no ``W_RUN`` words;
* ``"hole"``: the same, each merged second left in place as an all-zero
  hole, and more holes where no pairing puts one: at the start of tile 1,
  at the end of tile 4, and tile 2 holding nothing but holes.

The tiles (staged by kernel D in chunks of 32 entries):

* tile 0: fill and line streaks across the chunk boundaries in every
  stream (a 61-fill path, F2 x 30 and an F1, from entry 7 on when
  compact), and F2 / F1 runs of two paths back to back;
* tile 1: a fill edge with its slot-1 fill between two fill streaks; a
  begin clip right after a paired streak (where the kernel copies its
  register state into the state with stacks); a layer;
* tile 2: no command (only holes in the hole stream);
* tile 3: a random sequence with clips and layers (nested at most two
  deep, balanced), gradients and winding carries;
* tile 4: a random sequence without group commands;
* tile 5: no entry (white).

``oracle`` is the image of the command lists by the numpy oracle
(``raster/cpu_fine.py::render_tile``); every stream's image equals it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from ..layout.entry_stream import (ENTRY_WORDS, RUN_CAP, W_META, W_RUN,
                                   W_S0_ARG, W_S0_TAG, W_S1_ARG, W_S1_TAG)
from .cpu_fine import finish_pixels, render_tile
from .ptcl import (ARG_WORDS, CMD_BEGIN_CLIP, CMD_BEGIN_LAYER, CMD_CIRCLE,
                   CMD_DRAW_FILL, CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD,
                   CMD_END_CLIP, CMD_END_LAYER, CMD_FILL, CMD_FILL_EDGE,
                   CMD_LINE, CMD_STROKE, CMD_WIND)
from .synth_ptcl import _Commands

#: Tiles of the synthetic grid (tiles_y, tiles_x).
GRID = (2, 3)
#: The streams' modes.
MODES = ("off", "compact", "hole")
#: Zero rows after the last tile's entries, at least; the stream's rows
#: are a multiple of 128 (the JAX kernel's block of entries).
TAIL = 8

_Cmd = Tuple[int, np.ndarray]


class EntryStream(NamedTuple):
    first: np.ndarray      # (T,) int32
    n_entries: np.ndarray  # (T,) int32
    stream: np.ndarray     # (E, 16) float32


class SynthEntries(NamedTuple):
    streams: Dict[str, EntryStream]  # by mode
    oracle: np.ndarray               # (tiles_y * th, tiles_x * tw, 4) u8
    tiles_x: int
    tile_w: int
    tile_h: int


# An entry of the unpaired stream: ("fill", [fill]), ("line", [line]),
# ("edge", [fill_edge] or [fill_edge, fill]) or ("cand", [command]).
# A path is a list of entries whose fills (or lines) pair with each other.
_Path = List[Tuple[str, List[_Cmd]]]


def _row(entry) -> np.ndarray:
    """The unpaired record of one entry (meta: its command count)."""
    kind, cmds = entry
    r = np.zeros(ENTRY_WORDS, np.float32)
    if kind == "fill":
        r[W_S1_TAG] = CMD_FILL
        r[W_S1_ARG:W_S1_ARG + 5] = cmds[0][1][:5]
    elif kind == "line":
        r[W_S0_TAG] = CMD_LINE
        r[W_S0_ARG:W_S0_ARG + 7] = cmds[0][1][:7]
    elif kind == "edge":
        r[W_S0_TAG] = CMD_FILL_EDGE
        r[W_S0_ARG:W_S0_ARG + 2] = cmds[0][1][:2]
        if len(cmds) > 1:
            r[W_S1_TAG] = CMD_FILL
            r[W_S1_ARG:W_S1_ARG + 5] = cmds[1][1][:5]
    else:  # a tail command: operand words 0-11 in words 1-12
        tag, words = cmds[0]
        r[W_S0_TAG] = tag
        r[W_S0_ARG:W_S0_ARG + ARG_WORDS] = words
    r[W_META] = len(cmds)
    return r


def _merge(first: np.ndarray, second: np.ndarray, kind: str) -> np.ndarray:
    """The F2 or L2 entry of two adjacent records (ops/pairing.py)."""
    r = first.copy()
    if kind == "fill":
        r[W_S0_TAG] = CMD_FILL
        r[W_S0_ARG:W_S0_ARG + 5] = first[W_S1_ARG:W_S1_ARG + 5]
        r[W_S1_ARG:W_S1_ARG + 5] = second[W_S1_ARG:W_S1_ARG + 5]
    else:
        r[W_S1_TAG] = CMD_LINE
        # [sx, sy, ex, ey, inv_denom]: slot-0 words 0-3 and 5.
        r[W_S1_ARG:W_S1_ARG + 4] = second[W_S0_ARG:W_S0_ARG + 4]
        r[W_S1_ARG + 4] = second[W_S0_ARG + 5]
    r[W_META] += 1
    return r


def _tile_rows(paths: List[_Path], mode: str) -> List[np.ndarray]:
    """A tile's records in ``mode``: each path's runs of fills or of
    lines paired (0, 1), (2, 3), ... unless ``mode`` is "off"."""
    out = []
    for path in paths:
        i = 0
        while i < len(path):
            kind, _ = path[i]
            r = _row(path[i])
            pairs = (mode != "off" and kind in ("fill", "line")
                     and i + 1 < len(path) and path[i + 1][0] == kind)
            if pairs:
                out.append(_merge(r, _row(path[i + 1]), kind))
                if mode == "hole":
                    out.append(np.zeros(ENTRY_WORDS, np.float32))
                i += 2
            else:
                out.append(r)
                i += 1
    return out


def _run_words(rows: np.ndarray) -> None:
    """W_RUN of a tile's unpaired records, in place: each plain fill's
    (+) and line's (-) remaining streak length, as the coarse pass
    writes it."""
    t0, t1 = rows[:, W_S0_TAG], rows[:, W_S1_TAG]
    cls = np.where((t0 == 0) & (t1 == CMD_FILL), 1,
                   np.where((t0 == CMD_LINE) & (t1 == 0), 2, 0))
    n = rows.shape[0]
    for i in range(n):
        if cls[i]:
            j = i
            while j < n and cls[j] == cls[i]:
                j += 1
            rows[i, W_RUN] = min(j - i, RUN_CAP) * (1 if cls[i] == 1 else -1)


class _Paths:
    """Entries and paths of commands around one tile."""

    def __init__(self, rng, ox, oy, tw, th):
        self.rng = rng
        self.c = _Commands(rng, ox, oy, tw, th)

    def fills(self, k) -> _Path:
        return [("fill", [self.c.fill()]) for _ in range(k)]

    def lines(self, k) -> _Path:
        return [("line", [self.c.line()]) for _ in range(k)]

    def edge(self, with_fill=True) -> _Path:
        cmds = [self.c.fill_edge()] + ([self.c.fill()] if with_fill else [])
        return [("edge", cmds)]

    @staticmethod
    def cand(cmd) -> _Path:
        return [("cand", [cmd])]

    def random(self, n: int, groups: bool) -> List[_Path]:
        """About ``n`` entries of fill paths, strokes, circles and solids
        (with ``groups``, balanced clips and layers at most two deep,
        gradients and winding carries)."""
        rng, c = self.rng, self.c
        paths, count, open_groups = [], 0, []
        while count < n or open_groups:
            kind = rng.uniform()
            if count >= n:  # close what is open
                kind = 1.0
            if groups and kind >= 0.93:
                if open_groups and (count >= n or rng.uniform() < 0.5):
                    tag = open_groups.pop()
                    end = CMD_END_CLIP if tag == CMD_BEGIN_CLIP else \
                        CMD_END_LAYER
                    p = self.cand(c.group(end))
                elif len(open_groups) < 2:
                    tag = int(rng.choice([CMD_BEGIN_CLIP, CMD_BEGIN_LAYER]))
                    open_groups.append(tag)
                    p = self.cand(c.group(tag))
                else:
                    continue
            elif kind < 0.45:
                p = self.fills(int(rng.integers(1, 14)))
                if rng.uniform() < 0.3:
                    p = p[:2] + self.edge(rng.uniform() < 0.7) + p[2:]
                if groups and rng.uniform() < 0.25:
                    p += self.cand(c._cmd(CMD_WIND, rng.choice([-1.0, 1.0])))
                if groups and rng.uniform() < 0.3:
                    p += self.cand(c.gradient(int(rng.choice(
                        [CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD]))))
                else:
                    p += self.cand(c.draw_fill())
            elif kind < 0.7:
                p = self.lines(int(rng.integers(1, 10))) + self.cand(
                    c.stroke())
            elif kind < 0.82:
                p = self.cand(c.circle(CMD_CIRCLE))
            elif kind < 0.93:
                p = self.cand(c.solid())
            else:
                continue
            paths.append(p)
            count += len(p)
        return paths


def _tiles(rng, tile_w: int, tile_h: int) -> List[List[_Path]]:
    """The paths of each tile (module doc)."""
    tiles_y, tiles_x = GRID
    out = []
    for t in range(tiles_y * tiles_x):
        p = _Paths(rng, (t % tiles_x) * tile_w, (t // tiles_x) * tile_h,
                   tile_w, tile_h)
        c = p.c
        if t == 0:
            paths = [p.cand(c.solid()) + p.edge(), p.fills(3),
                     p.cand(c.draw_fill()), p.lines(2) + p.cand(c.stroke()),
                     p.fills(61), p.cand(c.draw_fill()),
                     p.lines(59) + p.cand(c.stroke()),
                     p.fills(3), p.fills(3), p.fills(2) + p.edge(False),
                     p.cand(c.draw_fill())]
        elif t == 1:
            paths = [p.fills(5) + p.edge() + p.fills(6),
                     p.cand(c.draw_fill()), p.fills(4),
                     p.cand(c.group(CMD_BEGIN_CLIP)),
                     p.fills(3) + p.cand(c.draw_fill()),
                     p.cand(c.group(CMD_END_CLIP)),
                     p.lines(4) + p.cand(c.stroke()),
                     p.cand(c.group(CMD_BEGIN_LAYER)),
                     p.cand(c.circle()), p.lines(3) + p.cand(c.stroke()),
                     p.cand(c.group(CMD_END_LAYER)),
                     p.fills(2) + p.cand(c.draw_fill())]
        elif t == 3:
            paths = p.random(90, groups=True)
        elif t == 4:
            paths = p.random(110, groups=False)
        else:
            paths = []
        out.append(paths)
    return out


def synth_entry_streams(seed: int, *, tile_w: int = 128,
                        tile_h: int = 16) -> SynthEntries:
    """The three streams of one seed and their oracle image (module
    doc)."""
    rng = np.random.default_rng(seed)
    tiles_y, tiles_x = GRID
    tiles = _tiles(rng, tile_w, tile_h)
    hole = np.zeros(ENTRY_WORDS, np.float32)
    streams = {}
    for mode in MODES:
        rows, first, n = [], [], []
        for t, paths in enumerate(tiles):
            tr = _tile_rows(paths, mode)
            if mode == "hole":
                if t == 1:
                    tr = [hole, hole] + tr
                elif t == 2:
                    tr = [hole] * 5
                elif t == 4:
                    tr = tr + [hole] * 3
            if mode == "off" and tr:
                tr = np.stack(tr)
                _run_words(tr)
                tr = list(tr)
            first.append(len(rows))
            n.append(len(tr))
            rows += tr
        rows += [hole] * (TAIL + (-(len(rows) + TAIL)) % 128)
        streams[mode] = EntryStream(
            first=np.array(first, np.int32), n_entries=np.array(n, np.int32),
            stream=np.stack(rows).astype(np.float32))
    img = np.zeros((tiles_y * tile_h, tiles_x * tile_w, 4), np.uint8)
    for t, paths in enumerate(tiles):
        cmds = [cmd for path in paths for _, cs in path for cmd in cs]
        tags = np.array([tag for tag, _ in cmds] or [0], np.int32)
        args = np.array([w for _, w in cmds] or [np.zeros(ARG_WORDS)],
                        np.float32)
        x0, y0 = (t % tiles_x) * tile_w, (t // tiles_x) * tile_h
        rgb = render_tile(tags, args, len(cmds), x0, y0, tile_h, tile_w)
        img[y0:y0 + tile_h, x0:x0 + tile_w] = finish_pixels(rgb)
    return SynthEntries(streams=streams, oracle=img, tiles_x=tiles_x,
                        tile_w=tile_w, tile_h=tile_h)
