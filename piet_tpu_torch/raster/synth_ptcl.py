"""Synthetic dense PTCLs for holding the dense interpreters against each
other: every command class, in sequences no scene would give, at the
places where the CUDA kernel changes course.

The dense PTCL is the coarse pass's ``output="dense"`` format (ptcl.py):
per tile a count, a row of ``cap`` int32 tags and a row of ``cap * 12``
f32 operand words.  :func:`synth_dense_ptcl` builds one from a seed with
numpy, on a grid of six tiles:

* tile 0: a count 40 above ``cap`` (the interpreters read ``cap``
  commands; its last slot is a no-op, since JAX's XLA interpreter reads
  that slot again for every count past the capacity); with ``groups``,
  the first group command at slot 0;
* tiles 1-4: the first group command at slot 31, 32, 127 or 128 (the
  chunk of 128 commands the kernel stages, and a warp's width); a streak
  of fills across the chunk boundary (slots 110-150, tile 1) and one of
  lines (slots 100-159, tile 2); tile 4 holds exactly ``cap`` commands;
* tile 5: no command.

Without ``groups`` the tags are those of ``_fine_kernel``'s map, 0-9 (a
tag below 2 is a circle, 9 a no-op): no group, gradient or wind command.
With it, tags up to 20 (above 16 the clip makes a wind).
"""

from __future__ import annotations

import numpy as np

from .ptcl import (ARG_WORDS, CMD_BEGIN_CLIP, CMD_BEGIN_LAYER, CMD_CIRCLE,
                   CMD_DRAW_FILL, CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD,
                   CMD_END_CLIP, CMD_END_LAYER, CMD_FILL, CMD_FILL_EDGE,
                   CMD_LINE, CMD_SOLID, CMD_STROKE, CMD_WIND)

#: Tiles of the synthetic grid (tiles_y, tiles_x).
GRID = (2, 3)
#: Slot of each tile's first group command (None: no group command).
FIRST_GROUP = (0, 31, 32, 127, 128, None)
#: Tag 9: the no-op (Bail) of both tag maps.
CMD_NOOP = 9


def synth_dense_ptcl(seed: int, *, tile_w: int, tile_h: int,
                     cap: int = 256, groups: bool = True):
    """(counts (2, 3) int32, tags (6, cap) int32, args (6, cap * 12) f32);
    see the module doc.  ``cap`` is a multiple of 128, at least 256."""
    if cap % 128 or cap < 256:
        raise ValueError(f"cap {cap}: a multiple of 128, at least 256")
    rng = np.random.default_rng(seed)
    tiles_y, tiles_x = GRID
    T = tiles_y * tiles_x
    counts = np.array([cap + 40, 230, 200, 180, cap, 0], np.int32)
    tags = np.zeros((T, cap), np.int32)
    args = np.zeros((T, cap, ARG_WORDS), np.float32)
    for t in range(T):
        ox = (t % tiles_x) * tile_w
        oy = (t // tiles_x) * tile_h
        cmd = _Commands(rng, ox, oy, tile_w, tile_h)
        n = min(int(counts[t]), cap)
        seq = cmd.sequence(n, groups)
        if t == 1:                      # a fill streak across slot 128
            seq[110:151] = [cmd.fill() for _ in range(41)]
            seq[151] = cmd.draw_fill()
        if t == 2:                      # a line streak across slot 128
            seq[100:160] = [cmd.line() for _ in range(60)]
            seq[160] = cmd.stroke()
        first = FIRST_GROUP[t]
        if groups and first is not None:
            seq[first] = cmd.group(CMD_BEGIN_LAYER if t == 0
                                   else CMD_BEGIN_CLIP)
            for j in range(first + 1, n):
                if rng.uniform() < 0.06:
                    seq[j] = cmd.group()
        if t == 0:
            seq[cap - 1] = (CMD_NOOP, np.zeros(ARG_WORDS))
        for j, (tag, words) in enumerate(seq):
            tags[t, j] = tag
            args[t, j] = words
    return (counts.reshape(tiles_y, tiles_x), tags,
            args.reshape(T, cap * ARG_WORDS))


class _Commands:
    """Commands with operands around one tile at (ox, oy)."""

    def __init__(self, rng, ox, oy, tw, th):
        self.rng, self.ox, self.oy, self.tw, self.th = rng, ox, oy, tw, th

    def _u(self, lo, hi):
        return self.rng.uniform(lo, hi)

    def _pt(self):
        return (self.ox + self._u(-0.3, 1.3) * self.tw,
                self.oy + self._u(-0.3, 1.3) * self.th)

    def _rgba(self):
        return list(self.rng.uniform(0.0, 1.0, 4))

    def _clip(self):
        """A draw's clip rect (words 8-11): mostly the whole tile."""
        ox, oy, tw, th = self.ox, self.oy, self.tw, self.th
        if self.rng.uniform() < 0.7:
            return [ox - 64.0, oy - 64.0, ox + tw + 64.0, oy + th + 64.0]
        x0, y0 = ox + self._u(0, tw / 2), oy + self._u(0, th / 2)
        return [x0, y0, x0 + self._u(1, tw), y0 + self._u(1, th)]

    @staticmethod
    def _cmd(tag, *words):
        w = np.zeros(ARG_WORDS)
        w[:len(words)] = words
        return tag, w

    def fill(self):
        sx, sy = self._pt()
        ey = self.oy + self._u(-0.3, 1.3) * self.th
        return self._cmd(CMD_FILL, sx, sy, ey, self._u(-2, 2),
                         self.rng.choice([-1.0, 1.0]))

    def fill_edge(self):
        return self._cmd(CMD_FILL_EDGE, self.rng.choice([-1.0, 1.0]),
                         self.oy + self._u(-2, self.th + 2))

    def line(self):
        (sx, sy), (ex, ey) = self._pt(), self._pt()
        lx, ly = np.float32(ex - sx), np.float32(ey - sy)
        d = np.float32(lx * lx + ly * ly)
        inv = np.float32(1.0) / d if d > 0 else np.inf
        return self._cmd(CMD_LINE, sx, sy, ex, ey, 1.0, inv)

    def stroke(self):
        return self._cmd(CMD_STROKE, self._u(0.5, 4.0), *self._rgba(), 0.0,
                         0.0, 0.0, *self._clip())

    def draw_fill(self):
        return self._cmd(CMD_DRAW_FILL, float(self.rng.integers(-1, 2)),
                         *self._rgba(), float(self.rng.integers(0, 2)), 0.0,
                         0.0, *self._clip())

    def circle(self, tag=CMD_CIRCLE):
        cx, cy = self._pt()
        r = self._u(1.0, max(self.tw, self.th) / 2)
        return self._cmd(tag, cx - r, cy - r, cx + r, cy + r, 0.0, 0.0, 0.0,
                         0.0, *self._clip())

    def solid(self):
        return self._cmd(CMD_SOLID, *self._rgba(), 0.0, 0.0, 0.0, 0.0,
                         *self._clip())

    def gradient(self, tag):
        cx, cy = self._pt()
        if tag == CMD_DRAW_LIN_GRAD:
            g0, g1 = self._u(-1, 1) / self.tw, self._u(-1, 1) / self.th
            g = (g0, g1, 0.5 - (g0 * cx + g1 * cy))
        else:
            g = (cx, cy, 1.0 / self._u(2.0, self.tw))
        return self._cmd(tag, float(self.rng.integers(-1, 2)), *g,
                         *self._rgba(), *self._rgba())

    def group(self, tag=None):
        """A begin/end clip or layer (random when ``tag`` is None)."""
        if tag is None:
            tag = int(self.rng.integers(CMD_BEGIN_CLIP, CMD_END_LAYER + 1))
        if tag == CMD_BEGIN_CLIP:
            return self._cmd(tag, float(self.rng.integers(-1, 2)),
                             float(self.rng.integers(0, 2)))
        if tag == CMD_END_LAYER:
            return self._cmd(tag, self._u(0.0, 1.0))
        return self._cmd(tag)

    def sequence(self, n, groups):
        """n commands: fill paths, strokes, circles and solids (and, with
        ``groups``, gradients and winding carries), no group command."""
        seq = []
        while len(seq) < n:
            kind = self.rng.uniform()
            if kind < 0.4:
                seq += [self.fill() for _ in range(self.rng.integers(1, 12))]
                if self.rng.uniform() < 0.3:
                    seq.append(self.fill_edge())
                if groups and self.rng.uniform() < 0.3:
                    seq.append(self._cmd(int(self.rng.choice(
                        [CMD_WIND, 20])), self.rng.choice([-1.0, 1.0])))
                if groups and self.rng.uniform() < 0.3:
                    seq.append(self.gradient(int(self.rng.choice(
                        [CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD]))))
                else:
                    seq.append(self.draw_fill())
            elif kind < 0.65:
                seq += [self.line() for _ in range(self.rng.integers(1, 8))]
                seq.append(self.stroke())
            elif kind < 0.8:
                seq.append(self.circle(int(self.rng.choice(
                    [CMD_CIRCLE, CMD_CIRCLE, 1]))))
            elif kind < 0.95:
                seq.append(self.solid())
            else:
                seq.append(self._cmd(int(self.rng.choice([0, CMD_NOOP]))))
        return seq[:n]
