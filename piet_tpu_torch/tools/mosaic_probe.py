"""On-card probe of the access patterns the batched fine-kernel design
needs: lane and sublane slices (static and dynamic), rolls, (1, 1) splats
broadcast five ways, an in-kernel transpose into scratch, grouped sums, a
read-modify-write at a dynamic row, 3-D scratch at dynamic indices, a
stack of scalars, and an async copy of 16-lane rows into scratch.

Port of ``tools/mosaic_probe.py``.  The JAX tool compiles one Pallas
kernel per probe and reports whether Mosaic lowers it.  Here each probe is
one instantiation of the ``probe_mosaic`` kernel template
(``csrc/mosaic_probe.cu``; ``dma_16lane`` is the ``probe_dma16`` kernel,
a bulk async copy completing on an mbarrier), and a probe is OK when its
kernel built, launched, and equals its plain version (``ops/probes.py``)
bit for bit at both fills of the scratch a probe reads before writing
(the Pallas interpreter's default NaN word and its
``uninitialized_memory="zero"``), on ``default_rng(0)`` input.

Prints ``name: OK`` or ``name: FAIL <Type>: <first line>`` per probe, in
the tool's order; ``PROBE_TB=1`` prints the traceback.  Exits 1 when a
probe failed.

Usage: python -m piet_tpu_torch.tools.mosaic_probe [probe ...]
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch

from ..ops import probes
from . import card
from .engines import diff

#: The tool's probes in its order: the 22 of ``probe_mosaic``, then the
#: DMA probe.
PROBES = list(probes.MOSAIC_PROBES) + ["dma_16lane"]


def probe_input(name: str) -> np.ndarray:
    """The probe's input, ``default_rng(0)`` normals: (16, 128) f32, or
    the DMA probe's (1024, 16)."""
    shape = (1024, 16) if name == "dma_16lane" else probes.MOSAIC_IN
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


def run(name: str, x: torch.Tensor, fill: int) -> torch.Tensor:
    """The probe's kernel (its plain version on a CPU tensor)."""
    if name == "dma_16lane":
        return probes.probe_dma16(x, fill)
    return probes.probe_mosaic(name, x, fill)


def run_plain(name: str, x: torch.Tensor, fill: int) -> torch.Tensor:
    if name == "dma_16lane":
        return probes.probe_dma16_plain(x, fill)
    return probes.probe_mosaic_plain(name, x, fill)


def check(name: str, device="cuda") -> None:
    """Run probe ``name`` at both fills; raise unless each result equals
    the plain version's bit for bit.  An unknown name raises KeyError,
    as the JAX tool's lookup does."""
    if name not in PROBES:
        raise KeyError(name)
    x = torch.from_numpy(probe_input(name)).to(device)
    for fill in probes.FILLS:
        got = run(name, x, fill)
        if x.is_cuda:
            torch.cuda.synchronize()  # a fault shows at its probe
        off = diff(got, run_plain(name, x, fill)).size
        if off:
            raise AssertionError(f"{off} of {got.numel()} words differ from "
                                 f"the plain version at fill {fill:#010x}")


def probe(names, device="cuda") -> list:
    """The tool's line for each probe."""
    lines = []
    for nm in names:
        try:
            check(nm, device)
            lines.append(f"{nm}: OK")
        except Exception as e:  # noqa: BLE001 -- every failure is a line
            msg = str(e).split("\n")[0][:160]
            lines.append(f"{nm}: FAIL {type(e).__name__}: {msg}")
            if os.environ.get("PROBE_TB"):
                traceback.print_exc()
        print(lines[-1], flush=True)
    return lines


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or PROBES
    dev = card()
    lines = probe(names, dev)
    return int(any(": FAIL " in line for line in lines))


if __name__ == "__main__":
    raise SystemExit(main())
