"""The port imports torch and never jax.

Checked in a subprocess: this test process has already imported jax
(tests/conftest.py)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
import piet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(piet_tpu_torch.__path__,
                                               "piet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
assert not leaked, leaked
print(len(names))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_all_its_modules_import_without_jax():
    proc = _run(["-c", _CHECK], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 10     # every module was seen


def test_port_sources_never_import_jax():
    for path in list((ROOT / "piet_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod != "jax", f"{path}: {line}"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA device: non-zero exit and no result line."""
    probe = _run(["-c", "import torch; print(torch.cuda.is_available())"],
                 ROOT)
    if probe.stdout.strip() == "True":
        pytest.skip("a CUDA device is present")
    proc = _run([str(ROOT / "chip_smoke.py")], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
