"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc``, one
process per ``.cu`` file, all started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
       -prec-div=true -prec-sqrt=true -ftz=false -Xcompiler -fPIC -c

``-fmad=false`` and the IEEE division/sqrt/denormal flags are part of the
renderer's exactness contract: the numpy oracle rounds every multiply and
add separately, and integer payload words travel as float bit patterns
that a denormal flush would destroy.  The library lands in
``build/piet_tpu_torch/`` at the repository root, named by the sha256 of
the sources and flags, so a rebuild happens only when they change.

Dispatch rule shared by every kernel wrapper (:func:`on_cuda`): a CPU
tensor runs the plain PyTorch version; a CUDA tensor launches the kernel
or raises.  Nothing falls back.  :func:`launch` counts each launch in
``tracing.LAUNCHES``, with the port's other counters.

A wrapper counts on the host, when it enqueues its kernel.  Under CUDA
graph capture (renderer/graph.py) nothing runs: the capture's counts are
taken apart (``tracing.launches_apart``) and added back at every replay
(``tracing.add_launches``), so ``tracing.LAUNCHES`` keeps counting the
launches that ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from . import tracing

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "piet_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argument types (the last one is the stream).
_SIGNATURES = {
    "piet_cand_prep": [_P] * 16 + [_I] * 6 + [_P],
    "piet_cand_expand": [_P] * 8 + [_I] * 4 + [_P],
    "piet_cand_stage": [_P] * 19 + [_I] * 7 + [_P],
    "piet_hitfuse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "piet_sort": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P,
                  _P],
    "piet_fine_entries": [_P] * 6 + [_I] * 6 + [_P],
    "piet_expand": [_P, _P, _P, _P, _I, _I, _I, _P],
    "piet_compact_rows": [_P, _P, _P, _P, _I, _P],
    "piet_keyed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _P],
    "piet_gather_rows": [_P] * 6 + [_I] * 4 + [_P],
    "piet_gather_endpoints": [_P] * 5 + [_I] * 2 + [_P],
    "piet_gather_backdrop": [_P] * 4 + [_I, _P],
    "piet_fine_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "piet_dense_tail": [_P] * 9 + [_I] * 5 + [_P],
    "piet_probe_numerics": [_I] + [_P] * 6 + [_I, _P],
    "piet_probe_halfmix": [_P, _P, _I, _I, _I, _I, _P],
    "piet_probe_delivery": [_P, _P, _P, _I, _I, _I, _I, _P],
    "piet_probe_mosaic": [_P, _P, _I, _I, _I, _I, _P],
    "piet_probe_dma16": [_P, _P, _P],
}

_LIB = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


#: Where nvcc is looked for after $CUDA_HOME/bin and $PATH.
NVCC_FALLBACK_PATHS = ("/usr/local/cuda/bin/nvcc",)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", *NVCC_FALLBACK_PATHS]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpiet_kernels_{h.hexdigest()[:16]}.so"


def run_all(cmds) -> None:
    """Run the commands in parallel; once all have ended, raise with the
    command line and output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{os.path.basename(c[0])} failed "
                               f"({p.returncode}): {' '.join(c)}\n{out}\n"
                               f"{err}")


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built:
    one nvcc per source, all at once, then one link.  Raises with nvcc's
    output if a step fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, compiles = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        compiles.append([nvcc] + NVCC_FLAGS + ["-c", str(src), "-o",
                                               str(obj)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        run_all(compiles)
        run_all([[nvcc, "-shared", "-o", str(tmp)]
                  + [str(o) for o in objs]])
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return out


def resource_usage(lib=None) -> dict:
    """Each kernel's resources in a built library (the port's by default),
    as the toolkit's ``cuobjdump --dump-resource-usage`` reports them:
    mangled name -> {"REG": registers a thread, "STACK": stack (local
    memory) bytes a thread, "SHARED": static shared bytes, "LOCAL": ...}.
    """
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-resource-usage", str(lib or build())],
                         capture_output=True, text=True, check=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in
                           re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line)}
            name = None
    return usage


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on the current CUDA device (launch the
    kernel on its current stream), False when they lie on the CPU (run
    the plain version).  Raises for any other device, a mix of devices,
    or a CUDA device that is not the current one (a caller on another
    card runs under ``torch.cuda.device``, as renderer/graph.py's steps
    do)."""
    devices = {t.device for t in tensors}
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return False
    if types != {"cuda"}:
        raise ValueError(f"kernel inputs on unsupported devices: {types}")
    current = torch.device("cuda", torch.cuda.current_device())
    if devices != {current}:
        raise ValueError(f"kernel inputs on {sorted(map(str, devices))}, "
                         f"but the current device is {current}")
    return True


def check_cuda_tensor(t: torch.Tensor, dtype: torch.dtype, name: str,
                      shape=None) -> None:
    """Raise unless ``t`` has ``dtype``, ``shape`` (when given) and a
    contiguous layout -- what a kernel assumes of its pointer."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` (its last argument, the current stream,
    is appended here), raise on a CUDA error, and count the launch."""
    rc = getattr(library(), entry)(*args, stream())
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    tracing.LAUNCHES[kernel] += 1
