"""The first stage array of the coarse pass that differs between two
devices, with up to 6 differing indices.

Port of ``tools/eng_array_probe.py``.  The JAX tool captures the raw
stage arrays of two engine settings (``with_probes="arrays"``) because
sums of probes were too weak to localize a divergence.  The port's stage
probes are the arrays themselves (``coarse_rasterize(with_probes=True)``)
and its two settings are devices: "cpu" (every kernel's plain version)
and "cuda" (every kernel), on eng_bisect_probe's configuration.  Each
stage array is printed with its mismatched words until the first that
differs.

Usage: python -m piet_tpu_torch.tools.eng_array_probe [devA devB]
"""

from __future__ import annotations

import sys

import numpy as np

from . import card, engines
from .eng_bisect_probe import run


def report(pa: dict, pb: dict, a: str = "cpu", b: str = "cuda") -> list:
    lines = []
    for k, x in pa.items():
        y = pb.get(k)
        if y is None:
            continue
        d = engines.diff(x, y)
        lines.append(f"{k:24s} shape={tuple(x.shape)} mismatched={d.size}")
        if d.size:
            wa, wb = engines.words(x), engines.words(y)
            for ix in d[:6]:
                t = tuple(int(i) for i in np.unravel_index(ix, x.shape))
                lines.append(f"    at {t}: {a}={int(wa[ix]):#x} "
                             f"{b}={int(wb[ix]):#x}")
            break
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    a, b = (argv + ["cpu", "cuda"][len(argv):])[:2]
    for d in (a, b):
        if d != "cpu":
            card()
    pa, pb = run(a, a)[0], run(b, b)[0]
    for line in report(pa, pb, a, b):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
