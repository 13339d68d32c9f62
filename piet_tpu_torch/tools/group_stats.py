"""Size the batched-group design of kernel D from the port's entry stream.

Port of ``tools/group_stats.py``.  For each configuration, runs the
port's coarse pass (``coarse_rasterize(output="entries", pair="off")``,
on the card) and reports, per run class (line runs W_RUN < 0, plain-fill
runs W_RUN > 0):

  * live entries and the share sitting in runs, with the run-length
    histogram,
  * groups of 4 and 8 formed inside runs, the entries they cover and the
    dummies a padded stream adds,
  * the single-entry 8-row window fit and, for groups formed after
    sorting each run by its window start, whether the group's union fits
    8 or 16 rows,

which says how far sublane-style batching (several entries per vector
step) could reach in kernel D.  The port's stream is entry-major (E, 16)
(``CoarseEntries.stream``), read as it is; the JAX pass's ``max_deltas``
and ``sort_impl`` have no counterpart.  The lines are the JAX tool's.

Usage: python -m piet_tpu_torch.tools.group_stats [config ...]
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import RenderConfig
from ..layout.entry_stream import W_RUN, W_S0_ARG, W_S0_TAG, W_S1_ARG
from ..ops.coarse import coarse_rasterize
from ..renderer.capacity import fit_capacities
from ..renderer.renderer import prepare_scene
from . import card


def _tiger(scale):
    from ..scene.svg import make_tiger
    return make_tiger(scale=scale)


def _fixture(name):
    from ..scene import fixtures
    return fixtures.get_scene(name)


#: name -> (scene maker, width, height), the JAX tool's.
CONFIGS = {
    "tiger_4k": (lambda: _tiger(19.2), 3840, 2160),
    "tiger_8x": (lambda: _tiger(8.0), 1664, 1664),
    "beziers_10k": (lambda: _fixture("beziers_10k"), 1024, 1024),
    "glyph_page_5k": (lambda: _fixture("glyph_page"), 1024, 1024),
    "circles_rects_1k": (lambda: _fixture("circles_rects"), 1024, 1024),
}
DEFAULT = ["tiger_4k", "beziers_10k", "tiger_8x", "glyph_page_5k"]


def entries(scene, width: int, height: int, device="cuda"):
    """The configuration's fitted config and its coarse pass's entry
    stream, on the host: (cfg, (E, 16) f32 stream, first, n_entries)."""
    cfg = fit_capacities(scene, RenderConfig(
        width=width, height=height, tile_height=32, tile_width=128,
        cmd_capacity=1024))
    dev = prepare_scene(scene, cfg, device)
    out = coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        max_segments=cfg.max_segments, max_hits=cfg.max_hits,
        max_candidates=cfg.max_candidates, output="entries", pair="off")
    return (cfg, out.stream.cpu().numpy(), out.first.cpu().numpy(),
            out.n_entries.cpu().numpy())


def analyze_stream(name: str, cfg, ent: np.ndarray, first: np.ndarray,
                   n_ent: np.ndarray) -> list:
    """The tool's report lines for one entry stream ((E, 16) f32)."""
    lines = []
    out = lines.append
    th = cfg.tile_height
    E = ent.shape[0]
    rw = ent[:, W_RUN]
    live = ent[:, W_S0_TAG] != 0
    live |= ent[:, 8] != 0  # slot-1-only (plain fill) entries
    n_live = int(live.sum())
    out(f"== {name}: {E} slots, {n_live} live entries, "
        f"tiles {cfg.tiles_x}x{cfg.tiles_y} tile {cfg.tile_width}x{th}")

    # Each entry's tile from the per-tile ranges, for the window math.
    tile_of = np.full(E, -1, np.int64)
    for t in np.nonzero(n_ent > 0)[0]:
        tile_of[first[t]:first[t] + n_ent[t]] = t
    ty = np.where(tile_of >= 0, tile_of // cfg.tiles_x, 0)
    y0 = (ty * th).astype(np.float32)

    for cls, sgn in (("line", -1), ("fill", +1)):
        in_run = (sgn * rw) > 0
        n_run = int(in_run.sum())
        # Run starts: the remaining count equals the run's full length
        # (the entry before is not in the same run).
        rem = np.where(in_run, sgn * rw, 0).astype(np.int64)
        prev = np.concatenate([[0], rem[:-1]])
        starts = in_run & (prev != rem + 1)
        lens = rem[starts]
        if not lens.size:
            out(f"  {cls}: {n_run} run entries, 0 runs")
            continue
        hist = np.bincount(np.clip(lens, 0, 33))
        out(f"  {cls}: {n_run} run entries "
            f"({100*n_run/max(n_live,1):.1f}% of live), "
            f"{lens.size} runs, mean len {lens.mean():.1f}")
        out(f"    run-length hist (1..16,17+): "
            f"{list(hist[1:17])} {int((lens >= 17).sum())}")
        for bs in (4, 8):
            # Groups inside runs: floor(L / bs) a run; padding each run to
            # a multiple of bs costs (bs - L % bs) % bs dummies.
            cover = (lens // bs * bs).sum()
            padded = ((lens + bs - 1) // bs * bs).sum()
            out(f"    batch-{bs}: unpadded covers {cover} "
                f"({100*cover/max(n_live,1):.1f}% of live); padded "
                f"stream adds {int(padded - lens.sum())} dummies "
                f"({100*(padded - lens.sum())/max(n_live,1):.1f}%)")
        # Window stats of groups formed inside runs after sorting each
        # run's members by their single-entry window start.
        base = W_S0_ARG if cls == "line" else W_S1_ARG
        sy = ent[:, base + 1]
        ey = ent[:, base + 3]
        if cls == "line":
            thr = ent[:, base + 4]
            lo = np.minimum(sy, ey) - thr
            hi = np.maximum(sy, ey) + thr
        else:
            lo = np.minimum(sy, ey)
            hi = np.maximum(sy, ey)
        li = (lo - y0).astype(np.int64) - 1
        hh = (hi - y0).astype(np.int64) + 2
        rs1 = np.clip(li & ~7, 0, th - 8)
        fits1 = hh <= rs1 + 8
        ridx = np.nonzero(in_run)[0]
        out(f"    single-entry 8-row fit: {100*fits1[ridx].mean():.1f}%")
        run_id = np.cumsum(starts)[ridx]     # 1-based run id per member
        for bs in (4, 8):
            ws = []
            order = np.lexsort((li[ridx], run_id))
            rr, ll, hh2 = run_id[order], li[ridx][order], hh[ridx][order]
            cuts = np.nonzero(np.diff(rr))[0] + 1
            for seg_l, seg_h in zip(np.split(ll, cuts), np.split(hh2, cuts)):
                for q in range(0, len(seg_l) - bs + 1, bs):
                    glo = seg_l[q:q+bs].min()
                    ghi = seg_h[q:q+bs].max()
                    ws.append(ghi - max(min(glo & ~7, th - 8), 0))
            ws = np.asarray(ws)
            if ws.size:
                for wr in (8, 16):
                    out(f"    sorted batch-{bs} union fits {wr} rows: "
                        f"{100*(ws <= wr).mean():.1f}% of "
                        f"{ws.size} groups")
    return lines


def analyze(name: str, device="cuda", configs=None) -> list:
    make, w, h = (configs or CONFIGS)[name]
    return analyze_stream(name, *entries(make(), w, h, device))


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or DEFAULT
    dev = card()
    for nm in names:
        for line in analyze(nm, dev):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
