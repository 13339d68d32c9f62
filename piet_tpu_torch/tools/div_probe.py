"""On-card probe: is the port's kernel division bitwise the card's
``torch.div`` and numpy's IEEE quotient?

Port of ``tools/div_probe.py``.  The fine and coarse kernels are built
with ``-prec-div=true`` (``kernels.NVCC_FLAGS``), so their quotients
should be correctly rounded; this probe checks it one division at a time
on the tool's operand mix (2^20 operands: generic f32s, near-integer
ratios, tiny/huge magnitude pairs, exact-multiple pairs), through the
division op of the ``probe_numerics`` kernel (``csrc/probes.cu``),
launched by ``probes.probe_div``.

Prints three lines: kernel_vs_torch (the tool's mosaic_vs_xla),
torch_vs_numpy, kernel_vs_numpy.

Usage: python -m piet_tpu_torch.tools.div_probe
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.probes import probe_div
from . import card


def operands(n: int = 1 << 20):
    """The tool's operand mix, ``default_rng(0)``, as (n/128, 128) f32
    arrays a, b (b == 0 set to 1)."""
    rng = np.random.default_rng(0)
    a = np.concatenate([
        rng.standard_normal(n // 4).astype(np.float32) * 1e3,
        rng.integers(1, 4096, n // 4).astype(np.float32),
        rng.standard_normal(n // 4).astype(np.float32) * 1e-3,
        (rng.integers(1, 512, n // 4) * rng.integers(1, 512, n // 4))
        .astype(np.float32),
    ]).reshape(-1, 128)
    b = np.concatenate([
        rng.standard_normal(n // 4).astype(np.float32) * 3.7,
        rng.integers(1, 64, n // 4).astype(np.float32),
        rng.standard_normal(n // 4).astype(np.float32) * 1e2,
        rng.integers(1, 512, n // 4).astype(np.float32),
    ]).reshape(-1, 128)
    b[b == 0] = 1.0
    return a, b


def words_off(x: np.ndarray, y: np.ndarray) -> int:
    return int((x.view(np.uint32) != y.view(np.uint32)).sum())


def compare(a: np.ndarray, b: np.ndarray, device="cuda") -> dict:
    """The three comparisons' differing words: name -> (words off, words).
    On the CPU the kernel's plain version stands in for it."""
    at = torch.from_numpy(a).to(device)
    bt = torch.from_numpy(b).to(device)
    kern = probe_div(at, bt).cpu().numpy()
    ref = torch.div(at, bt).cpu().numpy()
    ieee = a / b  # numpy: correctly rounded
    return {"kernel_vs_torch": (words_off(kern, ref), a.size),
            "torch_vs_numpy": (words_off(ref, ieee), a.size),
            "kernel_vs_numpy": (words_off(kern, ieee), a.size)}


def report(results: dict) -> list:
    return [f"{name}: {'IDENTICAL' if neq == 0 else 'DIFFER'} "
            f"({neq}/{size} words)"
            for name, (neq, size) in results.items()]


def main() -> int:
    dev = card()
    for line in report(compare(*operands(), device=dev)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
