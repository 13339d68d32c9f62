"""Generate the native library's layout headers from the layout modules.

Usage:  python -m piet_tpu_torch.layout [--check]

Writes ``piet_scene_gen.h``, ``piet_ptcl_gen.h`` and ``piet_srgb_gen.h``
into ``build/piet_tpu_torch/gen/`` at the repository root; never under
``cc/``, which belongs to the JAX package (``native.py`` builds from it
without writing there).  With ``--check`` it writes nothing and exits
nonzero if the checked-in ``cc/gen/`` headers differ from what the
modules generate."""

from __future__ import annotations

import os
import sys

from .emit_cpp import emit_cpp, emit_srgb_header
from .modules import ptcl_module, scene_module

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
#: Where a default run writes.
GEN_DIR = os.path.join(_ROOT, "build", "piet_tpu_torch", "gen")
#: The checked-in headers that ``--check`` compares against.
CHECK_DIR = os.path.join(_ROOT, "cc", "gen")


def generate() -> dict:
    return {
        "piet_scene_gen.h": emit_cpp(scene_module()),
        "piet_ptcl_gen.h": emit_cpp(ptcl_module()),
        "piet_srgb_gen.h": emit_srgb_header(),
    }


def main(argv) -> int:
    if "--check" in argv:
        stale = []
        for fname, content in generate().items():
            path = os.path.join(CHECK_DIR, fname)
            old = open(path).read() if os.path.exists(path) else None
            if old != content:
                stale.append(fname)
        if stale:
            print(f"stale generated files in {CHECK_DIR}: {stale}")
            return 1
        return 0
    os.makedirs(GEN_DIR, exist_ok=True)
    for fname, content in generate().items():
        path = os.path.join(GEN_DIR, fname)
        with open(path, "w") as f:
            f.write(content)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
