"""Dense SPD solve of the reduced camera system: two hand-written CUDA
kernels (``csrc/spd_solve_chol.cu``, ``csrc/spd_solve_cluster.cu``) with
their plain PyTorch version beside them.

Counterpart of the JAX package's ``ops/solve.py``, whose ``solve_spd``
runs its Pallas kernel for float32 systems up to D = 1024 on the TPU and
Cholesky everywhere else. ``solve_spd`` copies that rule by shape and
dtype; each route keeps a launch count:

- a float32 CUDA system of D ≤ ``spd_solve_chol_max_d()`` (320 on the
  H100, one block's shared memory): the one-block blocked Cholesky,
  ``spd_solve_chol``;
- a float32 CUDA system of that D < D ≤ 1024: the cluster kernel,
  ``spd_solve_cluster`` (one thread-block cluster per system, the matrix in
  L2);
- anything else on CUDA (D > 1024, float64, which keeps Cholesky for its
  precision as the reference does): ``solve_spd_library``, the plain
  version counted as the library route;
- a CPU tensor: ``solve_spd_plain``.

This is dispatch by shape and dtype, as the reference's; there is no
fallback from a kernel that fails to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

# the largest D the JAX package's Pallas kernel takes (svin_tpu/ops/solve.py)
KERNEL_MAX_D = 1024


def solve_spd_plain(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H⁻¹ b by Cholesky (``torch.linalg.cholesky_ex`` +
    ``cholesky_solve``). H (..., D, D), b (..., D). A system that does not
    factor gives NaN, as the JAX ``cho_factor`` path does, so the LM loop
    rejects the step."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))


def solve_spd_library(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The library route of ``solve_spd`` on the card (float64, or D past
    the kernels): ``solve_spd_plain``, counted."""
    solve_spd_library.launches += 1
    return solve_spd_plain(H, b)


solve_spd_library.launches = 0


def _check(name: str, H: torch.Tensor, b: torch.Tensor) -> None:
    if H.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{name} is float32 only, got {H.dtype}, {b.dtype}")
    if H.dim() not in (2, 3) or H.shape[-1] != H.shape[-2] or b.shape != H.shape[:-1]:
        raise ValueError(f"{name} shapes: H {tuple(H.shape)}, b {tuple(b.shape)}")
    if not (H.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} needs contiguous H and b")
    if not (H.is_cuda and b.is_cuda and H.device == b.device):
        raise ValueError(f"{name} needs CUDA tensors on one device, got {H.device}, {b.device}")


def spd_solve_chol(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H⁻¹ b for SPD H by the blocked-Cholesky CUDA kernel: H (D, D) or
    (B, D, D) f32 contiguous on a CUDA device (only its lower triangle is
    read), b (D,) or (B, D). A system with a pivot ≤ 0 or not finite gives
    an all-NaN x, as ``solve_spd_plain``. One thread block per system, its
    triangle in shared memory: a D past ``spd_solve_chol_max_d()`` raises
    the launch's CUDA error. Launches on the current stream, does not
    synchronise."""
    _check("spd_solve_chol", H, b)
    D = H.shape[-1]
    batch = 1 if H.dim() == 2 else H.shape[0]
    x = torch.empty_like(b)
    if x.numel() == 0:
        return x
    lib = cuda_lib.load()
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.spd_solve_chol(
            ctypes.c_void_p(H.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(x.data_ptr()), batch, D, ctypes.c_void_p(stream),
        )
    cuda_lib.check(lib, err, "spd_solve_chol")
    spd_solve_chol.launches += 1
    return x


spd_solve_chol.launches = 0

_chol_max_d: dict = {}  # device index -> spd_solve_chol's largest D


def spd_solve_chol_max_d(device: torch.device) -> int:
    """The largest D ``spd_solve_chol`` takes on ``device`` (its triangle
    must fit one block's shared memory: 320 on the H100)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _chol_max_d:
        lib = cuda_lib.load()
        with torch.cuda.device(idx):
            _chol_max_d[idx] = int(lib.spd_solve_chol_max_d())
    return _chol_max_d[idx]


def spd_solve_cluster(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H⁻¹ b for SPD H by the cluster CUDA kernel: one thread-block
    cluster of 8 CTAs per system, its working matrix in an L2-resident
    workspace. H (D, D) or (B, D, D) f32 contiguous on a CUDA device (only
    its lower triangle is read), b (D,) or (B, D), 1 ≤ D ≤ 1024; a system
    with a pivot ≤ 0 or not finite gives an all-NaN x. Launches on the
    current stream, does not synchronise."""
    _check("spd_solve_cluster", H, b)
    D = H.shape[-1]
    batch = 1 if H.dim() == 2 else H.shape[0]
    x = torch.empty_like(b)
    if x.numel() == 0:
        return x
    lib = cuda_lib.load()
    if D > lib.spd_solve_cluster_max_d():
        raise ValueError(f"spd_solve_cluster: D={D} past {lib.spd_solve_cluster_max_d()}")
    work = torch.empty(batch * lib.spd_solve_cluster_workspace(D), dtype=torch.float32,
                       device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.spd_solve_cluster(
            ctypes.c_void_p(H.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(work.data_ptr()), batch, D,
            ctypes.c_void_p(stream),
        )
    cuda_lib.check(lib, err, "spd_solve_cluster")
    spd_solve_cluster.launches += 1
    return x


spd_solve_cluster.launches = 0


def solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense SPD solve, routed as the JAX package routes it: float32 CUDA
    systems up to D = 1024 through a CUDA kernel (the one-block kernel while
    the triangle fits a block's shared memory, the cluster kernel past it),
    other CUDA systems through the library Cholesky, CPU tensors through the
    plain Cholesky (full f64 precision in the CPU tests)."""
    if H.device.type == "cuda":
        D = H.shape[-1]
        if H.dtype == torch.float32 and D <= KERNEL_MAX_D:
            if D <= spd_solve_chol_max_d(H.device):
                return spd_solve_chol(H, b)
            return spd_solve_cluster(H, b)
        return solve_spd_library(H, b)
    if H.device.type == "cpu":
        return solve_spd_plain(H, b)
    raise ValueError(f"solve_spd: unsupported device {H.device}")
