"""Time the pairing path's kernels of two source trees on one CUDA card,
in turns, with each tree's kernel resources.

    python -m piet_tpu_torch.tools.pairing_ab ROOT_A ROOT_B

ROOT_A and ROOT_B are checkouts of this repository (a parent commit
unpacked with ``git archive`` into a gitignored directory, and the working
tree).  It runs A, B, B, A, every run in a process of its own that
imports ``piet_tpu_torch`` and ``chip_smoke`` from its root, builds its
kernels there and times, on the tiger at 1664^2 (32x128 tiles) and
beziers_10k at 1024^2 (``Renderer.for_scene``'s bucketed capacities),
with chip_smoke's helpers (CUDA events around 20 back-to-back calls
behind a GPU spin):

  fine        kernel D's run dispatch on the unpaired stream ("off") and
              its paired instantiation on the compact and hole streams,
              three times each;
  fine_dense  both instantiations on the dense route's PTCL of the scene;
  compaction  ``pairing.compact_rows`` on the compact pass's bundle and
              keep mask, eager and replayed from a CUDA graph;
  frame       the graphed entries frame with ``PIET_PAIR`` off, compact
              and hole (median of 20 frames, CUDA events around each).

Each run prints one JSON line; then each tree's registers and stack
bytes of kernel D's four instantiations and fine_dense's four
(``kernels.resource_usage`` on the tree's built library) and, per number
(ms), each tree's mean and its two runs (``tools.ab_lines``).  Exits 1
when no card is present.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

#: Kernel D's and fine_dense's instantiations in a mangled name:
#: (kernel, flag, pixels a thread).  The flag is kPaired for kernel D,
#: kGroups for fine_dense.
FINE_NAME = re.compile(r"(fine_entries_kernel|fine_dense_kernel)"
                       r"ILb([01])ELi(\d+)EE")


def fine_resources(usage: dict) -> dict:
    """The fine kernels' instantiations of ``kernels.resource_usage``:
    "fine_entries_kernel<paired=1, R=8>" -> its resources."""
    out = {}
    for name, res in usage.items():
        m = FINE_NAME.search(name)
        if m:
            kernel, flag, r = m.groups()
            what = "paired" if kernel == "fine_entries_kernel" else "groups"
            out[f"{kernel}<{what}={flag}, R={r}>"] = res
    return dict(sorted(out.items()))


def measure(dev) -> dict:
    """The numbers of the module doc for the tree on ``sys.path``."""
    import torch

    import chip_smoke as cs
    from piet_tpu_torch import kernels
    from piet_tpu_torch.host import make_tiger
    from piet_tpu_torch.ops import coarse, fine, fine_xla, pairing
    from piet_tpu_torch.renderer.renderer import (Renderer,
                                                  _solid_to_present_u32)
    from piet_tpu_torch.scene import fixtures

    res = {"library": str(kernels.build())}
    for tag, sc, w, kw in (
            ("tiger 1664x1664", make_tiger(), 1664,
             dict(tile_height=32, tile_width=128)),
            ("beziers_10k 1024x1024", fixtures.get_scene("beziers_10k"),
             1024, {})):
        r = Renderer.for_scene(sc, w, w, device=dev, fine_impl="entries",
                               **kw)
        c = r.config
        staged = r.prepare(sc)
        for mode in ("off", "compact", "hole"):
            taps = {}
            ce = coarse.coarse_rasterize(staged, pair=mode, taps=taps,
                                         **cs.coarse_kw(c))
            a = (ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
                 ce.stream)
            fk = dict(tile_h=c.tile_height, tile_w=c.tile_width,
                      tiles_x=c.tiles_x, paired=mode != "off")
            res[f"{tag} fine {mode}"] = [
                cs.time_ms(lambda: fine.fine_rasterize_entries(*a, **fk),
                           reps=20, warm=2) for _ in range(3)]
            if mode == "compact":
                bundle, keep = taps["pairing"]

                def compact():
                    return pairing.compact_rows(bundle, keep)
                res[f"{tag} compaction eager"] = cs.time_ms(compact, reps=20,
                                                            warm=2)
                res[f"{tag} compaction graphed"] = cs.time_ms(
                    cs.replay_of(compact), reps=20, warm=2)
        d = cs.dense_inputs(staged, c)
        res[f"{tag} fine_dense non-group"] = cs.time_ms(
            lambda: fine.fine_rasterize(*d[:3], **d[3]), reps=20, warm=2)
        res[f"{tag} fine_dense group"] = cs.time_ms(
            lambda: fine_xla.fine_rasterize_xla(*d[:3], **d[3]), reps=20,
            warm=2)
        for mode in ("off", "compact", "hole"):
            os.environ["PIET_PAIR"] = mode
            rf = Renderer(c, dev, fine_impl="entries")
            del os.environ["PIET_PAIR"]
            rf.render(sc)
            st = rf._render.stage(rf.prepare(sc))
            res[f"{tag} frame {mode}"] = cs.frame_ms(
                lambda: rf._render.flat(st), reps=20)
        torch.cuda.synchronize()
    return res


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    print(json.dumps(measure(torch.device("cuda"))), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        worker(os.path.abspath(argv[1]))
        return 0
    import torch

    from piet_tpu_torch import kernels
    from piet_tpu_torch.tools import ab_lines, ab_runs
    if not torch.cuda.is_available():
        print("pairing_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in argv]
    if len(roots) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    runs = ab_runs(os.path.abspath(__file__), dict(zip("AB", roots)))
    if runs is None:
        return 1
    for t, rs in runs.items():
        for name, r in fine_resources(kernels.resource_usage(
                rs[0]["library"])).items():
            print(f"resources {t} {name}: registers {r['REG']}, "
                  f"stack {r['STACK']} B, local {r.get('LOCAL', 0)} B, "
                  f"shared {r['SHARED']} B", flush=True)
    print("\n".join(ab_lines(runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
