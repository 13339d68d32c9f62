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
``uninitialized_memory="zero"``), on ``default_rng(0)`` input.  The named
probes of ``probe_mosaic`` run in one launch, every probe at both fills
(``probes.probe_mosaic_batch``), and each is held to its plain version
on its own slices; ``dma_16lane`` runs on its own, once a fill.  A CUDA
error is sticky on the card, so an error of the batched launch marks
every probe of the batch FAIL with that error.

Prints ``name: OK`` or ``name: FAIL <Type>: <first line>`` per name, in
the order given (the tool's order by default); ``PROBE_TB=1`` prints the
traceback.  Exits 1 when a probe failed.

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


def _held(name: str, got, x: torch.Tensor, fill: int) -> None:
    """Raise unless ``got`` equals probe ``name``'s plain version at
    ``fill`` bit for bit."""
    off = diff(got, run_plain(name, x, fill)).size
    if off:
        raise AssertionError(f"{off} of {got.numel()} words differ from "
                             f"the plain version at fill {fill:#010x}")


def check(name: str, device="cuda") -> None:
    """Run probe ``name`` at both fills, one launch each; raise unless
    each result equals the plain version's bit for bit.  An unknown name
    raises KeyError, as the JAX tool's lookup does."""
    if name not in PROBES:
        raise KeyError(name)
    x = torch.from_numpy(probe_input(name)).to(device)
    for fill in probes.FILLS:
        got = run(name, x, fill)
        if x.is_cuda:
            torch.cuda.synchronize()  # a fault shows at its probe
        _held(name, got, x, fill)


def _line(name: str, err) -> str:
    if err is None:
        return f"{name}: OK"
    msg = str(err).split("\n")[0][:160]
    return f"{name}: FAIL {type(err).__name__}: {msg}"


def probe(names, device="cuda") -> list:
    """The tool's line for each name: the ``probe_mosaic`` probes among
    them (in the tool's order) at both fills in one launch, the rest each
    through :func:`check`."""
    batch = [n for n in probes.MOSAIC_PROBES if n in names]
    got = batch_err = None
    if batch:
        x = torch.from_numpy(probe_input(batch[0])).to(device)
        try:
            got = probes.probe_mosaic_batch(batch, x)
            if x.is_cuda:
                torch.cuda.synchronize()  # a fault shows at the batch
        except Exception as e:  # noqa: BLE001 -- every probe of it fails
            batch_err = e
            if os.environ.get("PROBE_TB"):
                traceback.print_exc()
    lines = []
    for nm in names:
        err = None
        try:
            if nm not in batch:
                check(nm, device)
            elif batch_err is not None:
                err = batch_err
            else:
                for f, fill in enumerate(probes.FILLS):
                    _held(nm, got[f, batch.index(nm)], x, fill)
        except Exception as e:  # noqa: BLE001 -- every failure is a line
            err = e
            if os.environ.get("PROBE_TB"):
                traceback.print_exc()
        lines.append(_line(nm, err))
        print(lines[-1], flush=True)
    return lines


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or PROBES
    dev = card()
    lines = probe(names, dev)
    return int(any(": FAIL " in line for line in lines))


if __name__ == "__main__":
    raise SystemExit(main())
