"""One tile of the gradient demo, word by word: the coarse pass's entries
on the card, then the oracle tiler's commands.

Port of ``tools/grad_tile_probe.py``.  Kernel D is bitwise the oracle at
16-row tiles, so a pixel off in a tile means the tile's commands differ
between the coarse pass and the CPU tiler: this probe prints both, each
word as its f32 bits, so the diverging operand is read, not guessed.
The port's stream is entry-major, (E, 16): a tile's entries are rows
``first .. first + n``.

Usage: python -m piet_tpu_torch.tools.grad_tile_probe [ty tx]
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import RenderConfig
from ..layout.entry_stream import W_META, W_S0_TAG, W_S1_TAG
from ..ops.coarse import coarse_rasterize
from ..raster.cpu_tiler import cpu_tile_scene
from ..renderer.renderer import prepare_scene
from ..scene.fixtures import make_gradient_demo
from . import card
from .grad_exact_probe import CFG


def coarse_pass(device="cuda"):
    """(config, the demo's entries pass on ``device``)."""
    cfg = RenderConfig(**CFG)
    dev = prepare_scene(make_gradient_demo(256), cfg, device)
    return cfg, coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        max_segments=cfg.max_segments, max_hits=cfg.max_hits,
        max_candidates=cfg.max_candidates, output="entries", pair="off")


def tile_entries(ty: int, tx: int, device="cuda"):
    """(tile index, first, n, solid bits, the tile's (n, 16) f32 entry
    rows) of the demo's coarse pass on ``device``."""
    cfg, out = coarse_pass(device)
    t = ty * cfg.tiles_x + tx
    fe, ne = int(out.first[t]), int(out.n_entries[t])
    rows = out.stream[fe:fe + ne].cpu().numpy()
    return t, fe, ne, int(out.solid[t]), rows


def entry_lines(ty: int, tx: int, device="cuda") -> list:
    t, fe, ne, solid, rows = tile_entries(ty, tx, device)
    lines = [f"tile ({ty},{tx}) t={t}: first={fe} n={ne} "
             f"solid={solid:#x}"]
    for i, row in enumerate(rows):
        u = row.view(np.uint32)
        lines.append(f"  e{i:02d} tag0={row[W_S0_TAG]:.0f} "
                     f"tag1={row[W_S1_TAG]:.0f} meta={row[W_META]:.0f} "
                     f"w=({' '.join(f'{w:08x}' for w in u)})")
    return lines


def oracle_lines(ty: int, tx: int) -> list:
    cfg = RenderConfig(**CFG)
    t = ty * cfg.tiles_x + tx
    ptcl = cpu_tile_scene(make_gradient_demo(256), cfg)
    cnt = int(ptcl.counts[t])
    lines = [f"oracle tile t={t}: {cnt} commands"]
    for j in range(cnt):
        args = ptcl.args[t, j].view(np.uint32)
        lines.append(f"  c{j:02d} tag={int(ptcl.tags[t, j])} "
                     f"args=({' '.join(f'{a:08x}' for a in args)})")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ty, tx = (int(argv[0]), int(argv[1])) if len(argv) > 1 else (7, 0)
    for line in entry_lines(ty, tx, card()) + oracle_lines(ty, tx):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
