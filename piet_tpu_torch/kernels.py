"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
       -prec-div=true -prec-sqrt=true -ftz=false -shared -Xcompiler -fPIC

``-fmad=false`` and the IEEE division/sqrt/denormal flags are part of the
renderer's exactness contract: the numpy oracle rounds every multiply and
add separately, and integer payload words travel as float bit patterns
that a denormal flush would destroy.  The library lands in
``build/piet_tpu_torch/`` at the repository root, named by the sha256 of
the sources and flags, so a rebuild happens only when they change.

Dispatch rule shared by every kernel wrapper (:func:`on_cuda`): a CPU
tensor runs the plain PyTorch version; a CUDA tensor launches the kernel
or raises.  Nothing falls back.  Each wrapper counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "piet_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-shared", "-Xcompiler", "-fPIC"]

#: Launches per kernel wrapper (one per wrapper call that launched its
#: kernel).  Plain-version calls never count.
LAUNCHES = {"candfuse": 0, "hitfuse": 0, "sort": 0, "fine": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argument types (the last one is the stream).
_SIGNATURES = {
    "piet_candfuse": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "piet_hitfuse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "piet_sort_f32_i32": [_P, _P, _I, _P],
    "piet_fine_entries": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built;
    raises with nvcc's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ([_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)]
           + [str(p) for p in _sources() if p.suffix == ".cu"])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


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
    """True when the tensors lie on a CUDA device (launch the kernel),
    False when they lie on the CPU (run the plain version).  Raises for
    any other device or a mix of devices."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs on unsupported devices: {types}")


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
    LAUNCHES[kernel] += 1
