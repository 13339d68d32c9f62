"""Build the port's libraries ahead of a run.

Port of ``tools/precompile_cache.py``.  The JAX tool compiles a bench
configuration ahead of time into JAX's persistent compilation cache, so
the first run on the chip skips a compile of minutes.  A CUDA graph
cannot be cached across processes: the port captures its steps when a
process first runs them, in milliseconds.  What a run would otherwise
build first is its libraries, so this tool builds them: the kernels of
``csrc/`` (``kernels.build()``, nvcc, one process per source) and the
``cc/`` library (``native.build()``, g++), each into
``build/piet_tpu_torch/`` under a name keyed by its sources and flags,
where every later process finds it.  Prints the seconds each build took
and where it went.  Runs where the card is, as the other tools do
(without one it raises); a missing compiler raises too.

Usage: python -m piet_tpu_torch.tools.precompile_cache
"""

from __future__ import annotations

import json
import time

from .. import kernels, native
from . import card


def build_all() -> list:
    """(name, seconds, path, built now) of each library."""
    out = []
    for name, lib in (("kernels", kernels), ("native", native)):
        fresh = not lib.library_path().exists()
        t0 = time.perf_counter()
        path = lib.build()
        out.append((name, time.perf_counter() - t0, path, fresh))
    return out


def main(argv=None) -> int:
    card()
    for name, sec, path, fresh in build_all():
        print(json.dumps({"library": name, "seconds": round(sec, 3),
                          "path": str(path), "built": fresh}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
