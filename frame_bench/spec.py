"""Load a cell of ``BENCHMARK.json`` and the files it names.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json`` and a per-layer metric the module
``metrics/<name>.py``, its name's dots written as underscores.  The code
behind a traffic file's ``entry`` is the module ``entries/<entry>.py``,
and behind a configuration's scene ``kind`` the module
``scenes/<kind>.py``.  The loaders check names and units against the
characters the benchmark allows.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
STEM_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError(f"bad unit {unit!r}")
    return unit


def load_benchmark(root: Path) -> dict:
    """``BENCHMARK.json`` at ``root``."""
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def load_config(name: str) -> dict:
    with open(HERE / "configs" / f"{check_name(name)}.json",
              encoding="utf-8") as f:
        cfg = json.load(f)
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names {cfg.get('name')!r}")
    return cfg


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{check_name(name)}.json",
              encoding="utf-8") as f:
        return json.load(f)


def find_module(package: str, stem: str):
    """The module ``frame_bench.<package>.<stem>``."""
    if not isinstance(stem, str) or not STEM_RE.match(stem):
        raise ValueError(f"bad module name {stem!r}")
    return importlib.import_module(f"frame_bench.{package}.{stem}")


def metric_module(name: str):
    """The reader of per-layer metric ``name``: a module with ``NAME``,
    ``UNIT``, ``LAYER``, ``SOURCE``, ``MOVES`` and ``read(ctx)``."""
    stem = check_name(name).replace(".", "_").replace("-", "_")
    mod = find_module("metrics", stem)
    if mod.NAME != name:
        raise ValueError(f"metrics/{stem}.py declares {mod.NAME!r}, "
                         f"not {name!r}")
    check_unit(mod.UNIT)
    return mod


def cell(bench: dict, workload: str) -> dict:
    """The cell ``workload`` with what it needs: its entry, configuration,
    traffic, and the end-to-end and per-layer metrics it reports."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]

    def reports(m):
        return workload in m.get("workloads", [workload])

    return {"entry": w, "config": load_config(w["config"]),
            "traffic": load_traffic(w["traffic"]),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}
