"""Is the card's coarse pass bitwise the CPU pass?  Compare, then bisect
by kernel.

Port of ``tools/engine_probe.py``.  On the reference's headline scene
(the 19.2x tiger at 3840x2160) the coarse pass runs on the CPU, where
every kernel's plain version runs (the JAX tool's "xla" setting), and on
the card, where every kernel runs (its "pallas"); the five leaves
(stream, first, n_entries, counts, solid) are compared bit for bit.
Then each kernel of the pass runs alone on the CPU pass's own inputs,
moved to the card, against its plain version (tools/engines.py), so a
diverging kernel is named with its first differing word.

Each setting runs in its own process, as in the JAX tool: an illegal
address poisons a process's CUDA context as a Mosaic crash took down the
JAX process, and one setting's failure must not take the others down.
The CPU pass hands the bisect its inputs through a temporary directory.

The last line is ``{"engines_bit_identical": ..., "bisect": {...}}``.

Usage: python -m piet_tpu_torch.tools.engine_probe
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..config import RenderConfig
from ..renderer.capacity import fit_capacities
from ..scene.svg import make_tiger
from . import card, engines

SCALE, WIDTH, HEIGHT = 19.2, 3840, 2160
ROOT = Path(__file__).resolve().parents[2]
#: Seconds a setting's process may take.
CHILD_TIMEOUT = 2400


def config(scale=SCALE, width=WIDTH, height=HEIGHT):
    scene = make_tiger(scale=scale)
    cfg = fit_capacities(scene, RenderConfig(
        width=width, height=height, tile_height=32, tile_width=128,
        cmd_capacity=1024))
    return scene, cfg


def run_child(setting: str, out_dir: str, size=None) -> None:
    """One setting: "cpu" (the pass on the CPU; its leaves and the
    kernels' inputs saved), "cuda" (the pass on the card; its leaves
    saved) or "bisect" (each kernel alone on the saved inputs).
    ``size`` (scale, width, height) replaces the headline scene."""
    out = Path(out_dir)
    scene, cfg = config(*(size or ()))
    if setting == "bisect":
        taps = torch.load(out / "taps.pt", weights_only=False)
        res = engines.bisect(taps, card())
        (out / "bisect.json").write_text(json.dumps(res))
        return
    taps = {} if setting == "cpu" else None
    dev = "cpu" if setting == "cpu" else card()
    np.savez(out / f"{setting}.npz",
             **engines.leaves(engines.run_pass(scene, cfg, dev, taps=taps)))
    if taps is not None:
        torch.save(taps, out / "taps.pt")


def child(setting: str, out_dir: str) -> bool:
    """Run one setting in its own process; False (with its last lines of
    errors printed) when it failed."""
    cmd = [sys.executable, "-m", "piet_tpu_torch.tools.engine_probe",
           "--child", setting, out_dir]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT)
    if r.returncode != 0:
        print(f"  {setting}: CHILD FAILED rc={r.returncode}")
        print("\n".join(r.stderr.splitlines()[-6:]))
        return False
    return True


def probe() -> dict:
    """The probe's verdict; prints the tool's lines on the way."""
    print(f"== engine probe: {WIDTH}x{HEIGHT} tiger coarse outputs, "
          f"bitwise ==", flush=True)
    with tempfile.TemporaryDirectory() as d:
        if not child("cpu", d):
            raise RuntimeError("the CPU pass failed")
        base = dict(np.load(Path(d) / "cpu.npz"))
        verdict = {"engines_bit_identical": None, "bisect": {}}
        if child("cuda", d):
            ok, lines = engines.compare(base, dict(np.load(Path(d) /
                                                           "cuda.npz")))
            verdict["engines_bit_identical"] = ok
            print(f"  all kernels vs plain: "
                  f"{'IDENTICAL' if ok else 'DIFFER'}", flush=True)
            if lines:
                print("\n".join(lines))
        if child("bisect", d):
            res = json.loads((Path(d) / "bisect.json").read_text())
            print("\n".join(engines.bisect_lines(res)), flush=True)
            verdict["bisect"] = {k: r["words_off"] == 0
                                 for k, r in res.items()}
        else:
            verdict["bisect"] = {k: "crash" for k in engines.KERNELS}
    return verdict


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        run_child(argv[1], argv[2])
        return 0
    card()
    verdict = probe()
    print(json.dumps(verdict), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
