"""Build-at-first-use and ctypes binding of the port's CUDA kernels.

The sources in ``svin_tpu_torch/csrc/*.cu`` compile with ``nvcc``, one
process per source, all started together, and link into one shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o _build/<name>.o csrc/<name>.cu    # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o svin_tpu_torch/_build/libsvin_kernels.so _build/*.o

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

COMPILE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

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
    """Compile every source into an object, all ``nvcc`` processes started
    together, then link them into LIB_PATH; returns the build's wall
    seconds."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + ".o")
        cmd = [_nvcc(), *COMPILE_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    link = [_nvcc(), *LINK_FLAGS, "-o", tmp, *objs]
    failed = []
    with open(BUILD_LOG, "w") as log:
        for cmd, proc in procs:
            out = proc.communicate()[0]
            log.write(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
        if not failed:
            res = subprocess.run(link, capture_output=True, text=True)
            log.write(" ".join(link) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
    lib.hamming_matrix.restype = ci
    lib.hamming_matrix.argtypes = [vp, vp, vp, ci, ci, ci, ci, cll, cll, vp]
    lib.hamming_max_words.restype = ci
    lib.hamming_max_words.argtypes = []
    lib.spd_solve_chol.restype = ci
    lib.spd_solve_chol.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.spd_solve_chol_max_d.restype = ci
    lib.spd_solve_chol_max_d.argtypes = []
    lib.hamming_match.restype = ci
    lib.hamming_match.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, cll, cll, ci, ci,
                                  ctypes.c_float, ci, ci, ci, vp, vp, vp, vp]
    for name in ("hamming_match_max_words", "hamming_match_cluster", "hamming_match_chunk",
                 "hamming_match_max_cols_per_cta"):
        getattr(lib, name).restype = ci
        getattr(lib, name).argtypes = []
    lib.hamming_nearest.restype = ci
    lib.hamming_nearest.argtypes = [vp, vp, vp, ci, ci, ci, ci, cll, vp]
    lib.hamming_nearest_max_words.restype = ci
    lib.hamming_nearest_max_words.argtypes = []
    pi = ctypes.POINTER(ci)
    lib.spd_solve_cluster.restype = ci
    lib.spd_solve_cluster.argtypes = [vp, vp, vp, ci, ci, pi, vp]
    lib.spd_solve_cluster_max_active.restype = ci
    lib.spd_solve_cluster_max_active.argtypes = [ci, pi, pi]
    lib.svin_cuda_error_string.restype = ctypes.c_char_p
    lib.svin_cuda_error_string.argtypes = [ci]
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.svin_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
