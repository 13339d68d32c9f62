"""ctypes bindings for the native ``cc/`` library, built by the port.

Port of ``piet_tpu/native.py``, with the same functions and signatures:
``init_scene_from_svg`` (SVG document -> wire bytes), ``flatten_cubics``,
``animated_frame`` (the animated fixture's SoA arrays at ``t``) and
``render_golden`` (the C++ golden rasterizer).

The port builds its own copy of the library and never writes under
``cc/``: the sources ``cc/src/*.cc`` are compiled with the flags of
``cc/Makefile`` (``-ffp-contract=off -fno-fast-math`` keep every
multiply and add rounded on its own, as the numpy oracle rounds them),
one ``g++`` per source, all started together, into ``build/piet_tpu_torch/``
at the repository root, named by the sha256 of the sources, headers and
flags.  The library is linked to a temporary name and renamed into
place, so processes that build at once never load a half-written file.
Where ``g++`` is missing or the build fails, :func:`available` is False
and every function raises :class:`NativeUnavailable`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .kernels import run_all

CC_DIR = Path(__file__).resolve().parent.parent / "cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "piet_tpu_torch"

#: cc/Makefile's CXXFLAGS and include paths.
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-ffp-contract=off", "-fno-fast-math"]
INCLUDES = ["include", "."]

_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _sources():
    return sorted((CC_DIR / "src").glob("*.cc"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in (_sources() + sorted((CC_DIR / "include").glob("*.h"))
              + sorted((CC_DIR / "gen").glob("*.h"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS + INCLUDES).encode())
    return BUILD_DIR / f"libpiet_cc_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile cc/src/*.cc into the library unless it is already built."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise NativeUnavailable("no C++ compiler: set CXX or put g++ on "
                                "PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    inc = [f"-I{CC_DIR / d}" for d in INCLUDES]
    # Objects and the linked library in a directory of this build's own,
    # the library then renamed into place.
    work = Path(tempfile.mkdtemp(prefix=f".{out.stem}.", dir=BUILD_DIR))
    try:
        objs = [work / f"{src.stem}.o" for src in _sources()]
        run_all([[cxx] + CXX_FLAGS + inc + ["-c", str(src), "-o", str(obj)]
                  for src, obj in zip(_sources(), objs)])
        run_all([[cxx, "-shared", "-o", str(work / out.name)]
                  + [str(o) for o in objs]])
        os.replace(work / out.name, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load(rebuild: bool = False) -> ctypes.CDLL:
    """Load (building if needed) the native library.  ``rebuild`` builds
    it again."""
    global _lib
    if _lib is not None and not rebuild:
        return _lib
    try:
        if rebuild:
            library_path().unlink(missing_ok=True)
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        raise NativeUnavailable(f"cannot build/load the cc/ library: "
                                f"{e}") from e
    P, I64, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    I32 = ctypes.c_int32
    for name, res, args in (
            ("pm_init_scene_from_svg", I64, [ctypes.c_char_p, D, P, I64]),
            ("pm_flatten_cubics", I64, [P, I64, D, P, I64, P]),
            ("pm_render_golden", I64, [ctypes.c_char_p, I64, I32, I32, I32,
                                       I32, I32, P]),
            ("pm_animated_frame", I64, [D, I32] + [P] * 13),
            ("pm_version", ctypes.c_char_p, [])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def init_scene_from_svg(svg_text: str, scale: float,
                        buf_size: int = 16 << 20) -> bytes:
    """Native scene build: SVG document -> wire-format bytes, byte for
    byte those of ``scene/svg.py`` + ``scene/wire.py::encode_scene``."""
    lib = load()
    buf = np.zeros(buf_size, np.uint8)
    n = lib.pm_init_scene_from_svg(svg_text.encode(), scale, _ptr(buf),
                                   buf_size)
    if n < 0:
        raise RuntimeError("pm_init_scene_from_svg failed (buffer too small?)")
    return buf[:n].tobytes()


def flatten_cubics(cubics: np.ndarray, accuracy: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Native batch flattener; the contract of
    ``geometry.flatten_cubics_batch``."""
    lib = load()
    cubics = np.ascontiguousarray(cubics, np.float64).reshape(-1, 4, 2)
    n = len(cubics)
    cap = 64 + n * 64
    while True:
        pts = np.zeros((cap, 2), np.float64)
        counts = np.zeros(n, np.int32)
        total = lib.pm_flatten_cubics(_ptr(cubics), n, accuracy, _ptr(pts),
                                      cap, _ptr(counts))
        if total >= 0:
            return pts[:total], counts
        cap *= 4


def animated_frame(t: float, centers: np.ndarray, radii: np.ndarray,
                   phases: np.ndarray, color_hi: np.ndarray):
    """Native per-frame build of the animated fixture: the SoA ``Scene``
    arrays of ``scene/fixtures.py::make_animated_frame``, bit for bit.
    The seeded draws do not depend on ``t`` and are passed in."""
    from .scene.scene import Scene

    lib = load()
    n = len(radii)
    centers = np.ascontiguousarray(centers, np.float64)
    radii = np.ascontiguousarray(radii, np.float64)
    phases = np.ascontiguousarray(phases, np.float64)
    color_hi = np.ascontiguousarray(color_hi, np.uint32)
    tags = np.zeros(n, np.int32)
    colors = np.zeros(n, np.uint32)
    widths = np.zeros(n, np.float32)
    bboxes = np.zeros((n, 4), np.int32)
    pt_offset = np.zeros(n, np.int32)
    n_pts = np.zeros(n, np.int32)
    points = np.zeros((13 * n, 2), np.float32)
    flags = np.zeros(n, np.uint32)
    clips = np.zeros((n, 4), np.float32)
    total = lib.pm_animated_frame(
        t, n, *(_ptr(a) for a in (centers, radii, phases, color_hi, tags,
                                  colors, widths, bboxes, pt_offset, n_pts,
                                  points, flags, clips)))
    return Scene(tags=tags, colors=colors, widths=widths, bboxes=bboxes,
                 pt_offset=pt_offset, n_pts=n_pts, points=points[:total],
                 flags=flags, clips=clips)


def render_golden(scene_wire: bytes, width: int, height: int,
                  tile_w: int = 128, tile_h: int = 16,
                  cmd_capacity: int = 512) -> Tuple[np.ndarray, int]:
    """Native golden render: wire bytes -> ((H, W, 4) u8 RGBA, overflow)."""
    lib = load()
    out = np.zeros((height, width, 4), np.uint8)
    ov = lib.pm_render_golden(scene_wire, len(scene_wire), width, height,
                              tile_w, tile_h, cmd_capacity, _ptr(out))
    if ov < 0:
        raise RuntimeError("pm_render_golden failed")
    return out, int(ov)
