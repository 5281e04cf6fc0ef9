"""The native (C++) host reader of the port: the counterpart of
`sfa3d_tpu/native/`.

`preproc.cpp` (the port's own copy) does the host side of a scan: the range
filter and the fixed-shape pad in one pass (`sfa_filter_pad`), and the
read of a KITTI velodyne `.bin` fused with both, streamed through a 4 MiB
buffer of the calling thread, which holds a KITTI scan whole: one read and
one pass (`sfa_read_filter_pad`). It
is called through ctypes, which releases the GIL, so the loader's thread
pool reads scans in parallel. The results are bit for bit those of the
numpy twin, `ops/bev.py::_filter_and_pad_numpy`: inclusive bounds, NaN rows
dropped, scan order, truncation at max_points with the JAX package's
overflow warning, zero padding and the valid mask.

The library is built with the host's C++ compiler (`$CXX`, else g++) at
first use into `build/native/` at the root of the checkout, under a file
name that carries the source's hash and a tag of the host's CPU (it is
built with -march=native), through a temporary file renamed into place, so
processes that build it at once (spawned ranks) never load half a library.

There is no silent fallback: a failed build raises. SFA3D_TPU_NO_NATIVE=1
(the JAX package's switch) selects the numpy twin instead. The path taken
is logged once per process (logger "sfa3d_tpu_torch.native").
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "preproc.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
POINT_BYTES = 16  # (x, y, z, r) float32

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_logged = set()
_log = logging.getLogger("sfa3d_tpu_torch.native")


def enabled() -> bool:
    """False when SFA3D_TPU_NO_NATIVE is set (the numpy twin is then used)."""
    return not os.environ.get("SFA3D_TPU_NO_NATIVE")


def note_path() -> None:
    """Log, once per process and path, which host reader runs."""
    path = "native" if enabled() else "numpy"
    if path not in _logged:
        _logged.add(path)
        if path == "native":
            _log.info("host reader: native (%s)", library_path())
        else:
            _log.info("host reader: numpy (SFA3D_TPU_NO_NATIVE is set)")


def _host_tag() -> str:
    """The CPU's architecture and flags, hashed: a library built with
    -march=native on one CPU is never loaded on another."""
    bits = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            bits += [line for line in f if line.startswith("flags")][:1]
    except OSError:
        bits.append(platform.processor() or platform.node())
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:8]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"preproc-{digest}-{_host_tag()}.so"


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX, g++ or c++) for sfa3d_tpu_torch/native/preproc.cpp; "
                           "set SFA3D_TPU_NO_NATIVE=1 to read scans with numpy")
    return cxx


def build() -> Path:
    """Compile preproc.cpp unless its library is built; returns its path.
    Raises RuntimeError with the compiler's output on a failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {res.returncode}):\n{res.stdout}{res.stderr}\n"
                           "set SFA3D_TPU_NO_NATIVE=1 to read scans with numpy")
    os.replace(tmp, out)  # atomic: a process building or loading it at the same time never sees half a library
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built at first use)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                fptr, u8ptr = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
                lib.sfa_filter_pad.restype = ctypes.c_int64
                lib.sfa_filter_pad.argtypes = [fptr, ctypes.c_int64, fptr, ctypes.c_int64, fptr, u8ptr]
                lib.sfa_read_filter_pad.restype = ctypes.c_int64
                lib.sfa_read_filter_pad.argtypes = [ctypes.c_char_p, fptr, ctypes.c_int64, fptr, u8ptr]
                _lib = lib
    return _lib


def _bounds(boundary: Dict[str, float]) -> np.ndarray:
    return np.asarray([boundary["minX"], boundary["maxX"], boundary["minY"], boundary["maxY"],
                       boundary["minZ"], boundary["maxZ"]], np.float32)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _finish(kept: int, max_points: int, out: np.ndarray, valid: np.ndarray):
    from sfa3d_tpu_torch.ops.bev import warn_point_overflow

    warn_point_overflow(kept, max_points, stacklevel=5)
    return out, valid.view(bool)


def filter_pad_points(points: np.ndarray, max_points: int,
                      boundary: Dict[str, float]) -> Tuple[np.ndarray, np.ndarray]:
    """Range filter + pad of an (N, 4) float32 scan in one native pass:
    (max_points, 4) float32 and a (max_points,) bool mask, bit for bit the
    numpy twin's. Warns when in-range points are dropped."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"expected an (N, 4) scan; got shape {pts.shape}")
    out = np.empty((max_points, 4), np.float32)
    valid = np.empty((max_points,), np.uint8)
    kept = library().sfa_filter_pad(_fptr(pts), pts.shape[0], _fptr(_bounds(boundary)), max_points, _fptr(out),
                                    valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return _finish(kept, max_points, out, valid)


def read_velodyne_filtered(path: str, max_points: int,
                           boundary: Dict[str, float]) -> Tuple[np.ndarray, np.ndarray]:
    """Read a velodyne .bin ((N, 4) float32) fused with the range filter and
    the pad, in one native pass over the file's chunks. Raises OSError for a file
    that cannot be read and ValueError for one that is not a whole number of
    points (as np.fromfile(...).reshape(-1, 4) does)."""
    size = os.path.getsize(path)
    if size % POINT_BYTES:
        raise ValueError(f"{path}: {size} bytes is not a whole number of (x, y, z, r) float32 points")
    out = np.empty((max_points, 4), np.float32)
    valid = np.empty((max_points,), np.uint8)
    kept = library().sfa_read_filter_pad(os.fsencode(path), _fptr(_bounds(boundary)), max_points, _fptr(out),
                                         valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if kept < 0:
        raise OSError(f"{path}: the scan could not be read")
    return _finish(kept, max_points, out, valid)
