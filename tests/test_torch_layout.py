"""The port's copy of the layout codegen (piet_tpu_torch/layout): the
same exports and generated headers as the JAX package's, ``--check``
against the checked-in ``cc/gen/`` headers, and a default run that writes
under ``build/`` and never under ``cc/``.  (The copies' source text is
held by tests/test_torch_hostlayer.py.)"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import piet_tpu.layout as jax_layout
import piet_tpu.layout.__main__ as jax_main
import piet_tpu_torch.layout as layout
import piet_tpu_torch.layout.__main__ as gen

ROOT = Path(__file__).resolve().parent.parent


def test_exports_are_jax_s():
    assert layout.__all__ == jax_layout.__all__
    for name in layout.__all__:
        assert getattr(layout, name).__name__ == getattr(jax_layout,
                                                         name).__name__


def test_generated_headers_equal_jax_s():
    assert gen.generate() == jax_main.generate()


def test_describe_and_packing_equal_jax_s():
    for mod in ("scene_module", "ptcl_module"):
        port, ref = getattr(layout, mod)(), getattr(jax_layout, mod)()
        assert layout.describe(port) == jax_layout.describe(ref)
        assert layout.emit_cpp(port) == jax_layout.emit_cpp(ref)


def test_check_passes_and_writes_nothing(tmp_path, monkeypatch):
    before = {p: p.stat().st_mtime_ns for p in (ROOT / "cc" / "gen").iterdir()}
    monkeypatch.setattr(gen, "GEN_DIR", str(tmp_path / "gen"))
    assert gen.main(["--check"]) == 0
    assert not (tmp_path / "gen").exists()
    assert {p: p.stat().st_mtime_ns
            for p in (ROOT / "cc" / "gen").iterdir()} == before


def test_check_fails_on_a_stale_header(tmp_path, monkeypatch, capsys):
    for name, text in gen.generate().items():
        (tmp_path / name).write_text(text)
    (tmp_path / "piet_ptcl_gen.h").write_text("// stale\n")
    monkeypatch.setattr(gen, "CHECK_DIR", str(tmp_path))
    assert gen.main(["--check"]) == 1
    assert "piet_ptcl_gen.h" in capsys.readouterr().out


def test_default_run_writes_only_under_build():
    """``python -m piet_tpu_torch.layout`` writes the three headers into
    build/piet_tpu_torch/gen/ (equal to cc/gen/'s) and leaves cc/ as it
    was."""
    cc_gen = ROOT / "cc" / "gen"
    before = {p.name: (p.stat().st_mtime_ns, p.read_text())
              for p in cc_gen.iterdir()}
    out = subprocess.run([sys.executable, "-m", "piet_tpu_torch.layout"],
                         cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    gen_dir = Path(gen.GEN_DIR)
    assert gen_dir == ROOT / "build" / "piet_tpu_torch" / "gen"
    written = {line.split(" ", 1)[1] for line in out.stdout.splitlines()}
    assert written == {str(gen_dir / n) for n in gen.generate()}
    for name, text in gen.generate().items():
        assert (gen_dir / name).read_text() == text == before[name][1]
    assert {p.name: (p.stat().st_mtime_ns, p.read_text())
            for p in cc_gen.iterdir()} == before


@pytest.mark.parametrize("argv", [["--check"]])
def test_module_entry_point_check(argv):
    out = subprocess.run([sys.executable, "-m", "piet_tpu_torch.layout",
                          *argv], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stdout + out.stderr
