"""Hold each fine-math primitive, one op at a time on the card, against
a strict numpy mirror (every multiply and add rounded on its own).

Port of ``tools/mosaic_numerics_probe.py``.  The fine kernels' exactness
(``kernels.NVCC_FLAGS``: ``-fmad=false -prec-div=true -prec-sqrt=true
-ftz=false``) is otherwise held only through whole frames; here each of
the tool's eight ops runs as the ``probe_numerics`` kernel
(``csrc/probes.cu``, the device functions of ``cmd_math.cuh``) on the
tool's adversarial inputs (``default_rng(0)``, 16 batches) at both of its
shapes, (16, 128) and (32, 128), and prints the mismatches and the worst
ULP per op and shape.  Every op should be 0 mismatches.

``fill_delta_chain`` is the tool's expression, which no fine kernel
evaluates now: kernel D's and ``fine_dense``'s fill coverage is the
difference of two ``fill_F`` terms, whose ``sat`` the ``saturate_sub``
op runs.

Usage: python -m piet_tpu_torch.tools.mosaic_numerics_probe [op ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.probes import probe_numerics
from ..scene.color import srgb_encode_u8
from . import card

F = np.float32
SHAPES = [(16, 128), (32, 128)]
N_BATCH = 16  # batches of random inputs per op/shape


def rand_pos(r, s):
    return (r.random(s, dtype=np.float32) * F(100.0) + F(1e-3)).astype(F)


def rand_sym(r, s):
    return ((r.random(s, dtype=np.float32) - F(0.5)) * F(64.0)).astype(F)


def rand01(r, s):
    return r.random(s, dtype=np.float32).astype(F)


def _fdc_mirror(bq, dq, cq, xmin, xmax):
    t = F(F(dq * dq) - F(cq * cq))
    num = F(F(bq + F(F(0.5) * t)) - xmin)
    return num / F(xmax - xmin)


def _fdc_inputs(r, s):
    xmin = rand_sym(r, s)
    xmax = xmin + rand_pos(r, s)
    bq = rand01(r, s)
    dq = rand01(r, s)
    cq = rand01(r, s)
    return bq, dq, cq, xmin, xmax


#: op -> (numpy mirror, input maker), the tool's, in its order (that of
#: ``ops/probes.py::NUMERICS_OPS``).
MIRRORS = {
    "div": (lambda a, b: a / b,
            lambda r, s: (rand_pos(r, s), rand_pos(r, s))),
    "sqrt": (lambda a: np.sqrt(a), lambda r, s: (rand_pos(r, s),)),
    "muladd2": (lambda a, b, c, d: F(F(a * b) + F(c * d)),
                lambda r, s: tuple(rand_sym(r, s) for _ in range(4))),
    "lerp": (lambda r_, f, w: F(r_ + F(F(f - r_) * w)),
             lambda r, s: (rand01(r, s), rand01(r, s), rand01(r, s))),
    "fill_delta_chain": (_fdc_mirror, _fdc_inputs),
    "srgb_chain": (lambda ch: srgb_encode_u8(ch).astype(F),
                   lambda r, s: (rand01(r, s),)),
    "ieee_sqrt": (lambda a: np.sqrt(a), lambda r, s: (rand_pos(r, s),)),
    "saturate_sub": (lambda a, b: np.clip(F(a - b), F(0.0), F(1.0)),
                     lambda r, s: (rand_sym(r, s), rand_sym(r, s))),
}


def ulp_diff(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def inputs(names=None, n_batch: int = N_BATCH, seed: int = 0) -> dict:
    """The tool's inputs: (op, shape) -> list of ``n_batch`` operand
    tuples, drawn from one ``default_rng(seed)`` in the tool's order (op,
    then shape, then batch)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in names or list(MIRRORS):
        mk = MIRRORS[name][1]
        for shape in SHAPES:
            out[name, shape] = [mk(rng, shape) for _ in range(n_batch)]
    return out


def run(name: str, batches, device="cuda") -> np.ndarray:
    """The op on every batch in one launch: the batches stacked on a
    leading axis, (n_batch, *shape) f32."""
    ins = [torch.from_numpy(np.stack(col)).to(device)
           for col in zip(*batches)]
    return probe_numerics(name, *ins).cpu().numpy()


def compare(name: str, batches, got: np.ndarray):
    """(mismatched, finite words, worst ULP) of ``got`` against the
    mirror, over the mirror's finite words, as the tool counts."""
    npx = MIRRORS[name][0]
    bad = tot = worst = 0
    for ins, g in zip(batches, got):
        want = npx(*ins).astype(F)
        d = ulp_diff(np.ascontiguousarray(g), want)
        ok = np.isfinite(want)
        bad += int((d[ok] != 0).sum())
        tot += int(ok.sum())
        if d[ok].size:
            worst = max(worst, int(d[ok].max()))
    return bad, tot, worst


def probe(names=None, device="cuda") -> dict:
    """(op, shape) -> (mismatched, words, worst ULP)."""
    return {key: compare(key[0], b, run(key[0], b, device))
            for key, b in inputs(names).items()}


def report(results: dict) -> list:
    return [f"{name:18s} {shape}: mismatched {bad}/{tot} worst_ulp={worst}"
            for (name, shape), (bad, tot, worst) in results.items()]


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or None
    dev = card()
    for line in report(probe(names, device=dev)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
