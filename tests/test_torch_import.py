"""The port imports torch and never jax, and nothing of the JAX package
``piet_tpu`` (not even its numpy modules: the port keeps its own copies)
nor the JAX package's root ``bench.py``.

Checked in a subprocess: this test process has already imported jax
(tests/conftest.py) and piet_tpu."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_CHECK = """
import ast, importlib, pkgutil, sys
import piet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(piet_tpu_torch.__path__,
                                               "piet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# Every import statement of chip_smoke.py, wherever it stands.
tree = ast.parse(open("chip_smoke.py").read())
for node in ast.walk(tree):
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        exec(compile(ast.Module(body=[node], type_ignores=[]),
                     "chip_smoke.py", "exec"), {})
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "piet_tpu", "bench"))
assert not leaked, leaked
print(" ".join(names))
"""

#: Modules the port must have beside the kernels' path: the command line
#: and what it stands on, and the tools (the JAX package's tools/) with
#: their kernels' module.
REQUIRED = {"piet_tpu_torch.cli", "piet_tpu_torch.__main__",
            "piet_tpu_torch.profiling", "piet_tpu_torch.roofline",
            "piet_tpu_torch.native", "piet_tpu_torch.entry",
            "piet_tpu_torch.api", "piet_tpu_torch.scene.wire",
            "piet_tpu_torch.scene.svg_full", "piet_tpu_torch.ops.probes",
            "piet_tpu_torch.tools.div_probe",
            "piet_tpu_torch.tools.mosaic_numerics_probe",
            "piet_tpu_torch.tools.half_experiment",
            "piet_tpu_torch.tools.arg_delivery_bench",
            "piet_tpu_torch.tools.fine_entry_bench",
            "piet_tpu_torch.tools.mosaic_probe",
            "piet_tpu_torch.tools.group_stats",
            "piet_tpu_torch.tools.mesh_balance",
            "piet_tpu_torch.tools.engine_probe",
            "piet_tpu_torch.tools.eng_bisect_probe",
            "piet_tpu_torch.tools.eng_array_probe",
            "piet_tpu_torch.tools.grad_exact_probe",
            "piet_tpu_torch.tools.grad_tile_probe",
            "piet_tpu_torch.tools.dispatch_probe",
            "piet_tpu_torch.tools.precompile_cache",
            "piet_tpu_torch.tools.time_config", "piet_tpu_torch.bench"}

#: What no source of the port imports: jax, the JAX package, and the JAX
#: package's root benchmark script.
FORBIDDEN = ("jax", "jaxlib", "piet_tpu", "bench")


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_all_its_modules_import_without_jax():
    proc = _run(["-c", _CHECK], ROOT)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 35 and REQUIRED <= names, REQUIRED - names


def test_port_sources_never_import_jax():
    """Nor piet_tpu, nor the root bench.py: no import line names them
    (the port's bench.py and tools/time_config.py among the sources)."""
    sources = list((ROOT / "piet_tpu_torch").rglob("*.py"))
    assert {ROOT / "piet_tpu_torch" / "bench.py",
            ROOT / "piet_tpu_torch" / "tools" / "time_config.py"} <= set(
                sources)
    for path in sources + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in FORBIDDEN, f"{path}: {line}"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA device: non-zero exit and no result line."""
    probe = _run(["-c", "import torch; print(torch.cuda.is_available())"],
                 ROOT)
    if probe.stdout.strip() == "True":
        pytest.skip("a CUDA device is present")
    proc = _run([str(ROOT / "chip_smoke.py")], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_every_jax_module_has_a_counterpart():
    """The two packages' module lists: every module of piet_tpu has one
    at the same relative path in piet_tpu_torch, and the JAX driver
    entry's dry run has entry.dryrun_multichip."""
    def modules(pkg):
        return {str(p.relative_to(ROOT / pkg)) for p in
                (ROOT / pkg).rglob("*.py") if "__pycache__" not in p.parts}
    assert modules("piet_tpu") - modules("piet_tpu_torch") == set()
    src = (ROOT / "piet_tpu_torch" / "entry.py").read_text()
    assert "def dryrun_multichip(" in src and "def entry(" in src


#: JAX tools without a counterpart yet, each with what it waits for.
TOOLS_WAITING = {}


def test_root_bench_has_its_counterpart():
    """The JAX package's root bench.py has the port's piet_tpu_torch/
    bench.py, with the JAX script's entry points under the same names
    (its ``_time_renderer``, ``_bench_config``, ``_roofline_split``
    without the underscore)."""
    jax_names = {n.name for n in ast.parse(
        (ROOT / "bench.py").read_text()).body
        if isinstance(n, ast.FunctionDef)}
    port = ROOT / "piet_tpu_torch" / "bench.py"
    assert port.is_file()
    port_names = {n.name for n in ast.parse(port.read_text()).body
                  if isinstance(n, ast.FunctionDef)}
    assert {n.lstrip("_") for n in jax_names} <= port_names


def test_every_jax_tool_has_a_counterpart():
    """Every ``tools/*.py`` has a module of the same name in
    ``piet_tpu_torch/tools/``, but those named as waiting; and no module
    there imports jax or piet_tpu, at any depth of its import lines."""
    jax_tools = {p.name for p in (ROOT / "tools").glob("*.py")}
    port = ROOT / "piet_tpu_torch" / "tools"
    ported = {p.name for p in port.glob("*.py")}
    assert jax_tools - ported == set(TOOLS_WAITING)
    assert not set(TOOLS_WAITING) & ported
    for path in port.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN, (path, m)
