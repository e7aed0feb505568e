"""Build-at-first-use and ctypes binding of the port's CUDA kernels.

The sources in ``svin_tpu_torch/csrc/*.cu`` compile with ``nvcc`` into one
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o svin_tpu_torch/_build/libsvin_kernels.so csrc/*.cu

The build runs the first time a kernel is launched in a process (or when a
source is newer than the library) and writes into ``svin_tpu_torch/_build/``;
the compiler's register/shared-memory report (``-Xptxas -v``) goes to
``_build/build.log``. Nothing here runs at import time: the CPU tests import
every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libsvin_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def build() -> float:
    """Compile the kernels into LIB_PATH; returns the build's wall seconds."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(BUILD_LOG, "w") as log:
        log.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built if missing or stale (once per process)."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    if _stale():
        build_seconds = build()
    lib = ctypes.CDLL(LIB_PATH)
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spd_solve_gj.restype = ci
    lib.spd_solve_gj.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.hamming_matrix.restype = ci
    lib.hamming_matrix.argtypes = [vp, vp, vp, ci, ci, ci, ci, cll, cll, vp]
    lib.hamming_max_words.restype = ci
    lib.hamming_max_words.argtypes = []
    lib.svin_cuda_error_string.restype = ctypes.c_char_p
    lib.svin_cuda_error_string.argtypes = [ci]
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.svin_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
