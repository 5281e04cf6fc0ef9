"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with `nvcc`
for Hopper (`sm_90a`) into a shared library under `build/kernels/` at the
root of the checkout on first use, and loaded with `ctypes`. The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. Extra nvcc flags (`flags`,
for instrumented builds) give a library of their own.

Nothing is built or loaded when a module is imported: the first launch of a
kernel (or `build_libraries`, which `chip_smoke.py` calls to time the build)
does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, else RuntimeError."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of sfa3d_tpu_torch need the CUDA toolkit"
    )


def library_path(name: str, flags: Sequence[str] = ()) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join((*NVCC_FLAGS, *flags)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start_build(name: str, nvcc: str, flags: Sequence[str]) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(name, flags)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build_libraries(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all of `csrc/*.cu`) that has no
    up-to-date library yet, one `nvcc` per source, all started together.
    Returns {name: seconds} for the builds run (0.0 for a library that was
    already built). Raises RuntimeError with nvcc's output on a failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    names = list(names)
    with _lock:
        return _build_locked(names)


def _build_locked(names: Sequence[str], flags: Sequence[str] = ()) -> Dict[str, float]:
    times = {n: 0.0 for n in names}
    todo = [n for n in names if not library_path(n, flags).exists()]
    if not todo:
        return times
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {n: _start_build(n, nvcc, flags) for n in todo}
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load_library(name: str, signatures: Dict[str, Tuple[object, Sequence[object]]],
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` (with the extra nvcc `flags`) if needed, load
    it once per process, and declare `restype`/`argtypes` from `signatures`
    {fn: (restype, argtypes)}."""
    key = " ".join((name, *flags))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            _build_locked([name], flags)
            lib = ctypes.CDLL(str(library_path(name, flags)))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _loaded[key] = lib
        return lib


def finish_launch(fn, name: str, err: int) -> None:
    """After a kernel wrapper's C call: raise on a CUDA error (the launch
    never ran; there is no fallback), else add one to `fn.launches`."""
    if err != 0:
        raise RuntimeError(f"{name} CUDA launch failed: cudaError {err}")
    with _count_lock:
        fn.launches += 1


def check_op_device(name: str, tensor) -> None:
    """A kernel op's fake implementation runs for fake tensors (tracing,
    export) and for meta tensors; the kernels run on cuda or cpu only, so a
    meta tensor is refused here as the real implementation refuses any
    other device."""
    if tensor.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {tensor.device}")
