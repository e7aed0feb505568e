"""Dense SPD solve of the reduced camera system: hand-written CUDA kernel
(``csrc/spd_solve_gj.cu``) with its plain PyTorch version beside it.

Counterpart of the JAX package's ``ops/solve.py``. The JAX package solves with a
Pallas Gauss–Jordan kernel on the TPU and Cholesky elsewhere; here
``solve_spd`` launches the Gauss–Jordan CUDA kernel for a CUDA tensor and
runs the plain version (Cholesky, the JAX package's non-TPU path) for a CPU
tensor. There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

# largest augmented (D, D+1) f32 system (+ staging) one block's shared
# memory holds on Hopper: 227 KB
MAX_SMEM_BYTES = 232448


def smem_bytes(D: int) -> int:
    return (D * (D + 1) + D + (D + 1)) * 4


def solve_spd_plain(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H⁻¹ b by Cholesky (``torch.linalg.cholesky_ex`` +
    ``cholesky_solve``). H (..., D, D), b (..., D). A system that does not
    factor gives NaN, as the JAX ``cho_factor`` path does, so the LM loop
    rejects the step."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))


def spd_solve_gj(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H⁻¹ b for SPD H by the Gauss–Jordan CUDA kernel: H (D, D) or
    (B, D, D) f32 contiguous on a CUDA device, b (D,) or (B, D). One thread
    block per system; launches on the current stream, does not synchronise."""
    if not (H.is_cuda and b.is_cuda and H.device == b.device):
        raise ValueError(f"spd_solve_gj needs CUDA tensors on one device, got {H.device}, {b.device}")
    if H.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"spd_solve_gj is float32 only, got {H.dtype}, {b.dtype}")
    if H.dim() not in (2, 3) or H.shape[-1] != H.shape[-2] or b.shape != H.shape[:-1]:
        raise ValueError(f"spd_solve_gj shapes: H {tuple(H.shape)}, b {tuple(b.shape)}")
    if not (H.is_contiguous() and b.is_contiguous()):
        raise ValueError("spd_solve_gj needs contiguous H and b")
    D = H.shape[-1]
    if D < 1 or smem_bytes(D) > MAX_SMEM_BYTES:
        raise ValueError(f"spd_solve_gj: D={D} does not fit one block's shared memory")
    batch = 1 if H.dim() == 2 else H.shape[0]
    x = torch.empty_like(b)
    if batch == 0:
        return x
    lib = cuda_lib.load()
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.spd_solve_gj(
            ctypes.c_void_p(H.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(x.data_ptr()), batch, D, ctypes.c_void_p(stream),
        )
    cuda_lib.check(lib, err, "spd_solve_gj")
    spd_solve_gj.launches += 1
    return x


spd_solve_gj.launches = 0


def solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense SPD solve: the CUDA kernel for CUDA tensors, Cholesky for CPU
    tensors (full f64 precision in the CPU tests)."""
    if H.device.type == "cuda":
        return spd_solve_gj(H, b)
    if H.device.type == "cpu":
        return solve_spd_plain(H, b)
    raise ValueError(f"solve_spd: unsupported device {H.device}")
