"""Hamming-distance matching: XOR + popcount distance matrix (hand-written
CUDA kernel ``csrc/hamming.cu`` with its plain PyTorch version beside it),
best-match selection with distance threshold, ratio test and mutual
consistency.

Counterpart of the JAX package's ``ops/hamming.py``. Descriptors are packed 32-bit
words held as **int32** (bit-identical to the JAX package's uint32 words:
``numpy.ndarray.view(np.int32)``); torch on the CPU has no uint32 shifts
and no popcount op. The JAX package's MXU matmul form is a TPU device and
has no counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib

# popcount of every byte value
_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def hamming_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Na, W) x (..., Nb, W) int32 words → (..., Na, Nb) int32, by XOR
    and a 256-entry byte popcount table (exact)."""
    x = a[..., :, None, :] ^ b[..., None, :, :]
    lut = _POPCOUNT8.to(x.device)
    cnt = (
        lut[x & 0xFF] + lut[(x >> 8) & 0xFF]
        + lut[(x >> 16) & 0xFF] + lut[(x >> 24) & 0xFF]
    )
    return cnt.sum(dim=-1, dtype=torch.int32)


def hamming_matrix_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: a (Na, W) or (B, Na, W), b (Nb, W) (shared by the
    batch) or (B, Nb, W), int32 contiguous on one CUDA device, W ≤ 8.
    Launches on the current stream, does not synchronise."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"hamming_matrix_cuda needs CUDA tensors on one device, got {a.device}, {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"hamming_matrix_cuda takes int32 words, got {a.dtype}, {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or a.shape[-1] != b.shape[-1]:
        raise ValueError(f"hamming_matrix_cuda shapes: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if b.dim() == 3 and (a.dim() != 3 or b.shape[0] != a.shape[0]):
        raise ValueError(f"hamming_matrix_cuda batch mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("hamming_matrix_cuda needs contiguous a and b")
    lib = cuda_lib.load()
    W = a.shape[-1]
    if W < 1 or W > lib.hamming_max_words():
        raise ValueError(f"hamming_matrix_cuda: W={W} words not supported")
    Na, Nb = a.shape[-2], b.shape[-2]
    batch = a.shape[0] if a.dim() == 3 else 1
    out = torch.empty(a.shape[:-2] + (Na, Nb), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    b_bstride = Nb * W if b.dim() == 3 else 0
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.hamming_matrix(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), batch, Na, Nb, W,
            Na * W, b_bstride, ctypes.c_void_p(stream),
        )
    cuda_lib.check(lib, err, "hamming_matrix")
    hamming_matrix_cuda.launches += 1
    return out


hamming_matrix_cuda.launches = 0


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance matrix: the CUDA kernel for CUDA tensors, the byte-table
    version for CPU tensors."""
    if a.device.type == "cuda":
        return hamming_matrix_cuda(a, b)
    if a.device.type == "cpu":
        return hamming_matrix_plain(a, b)
    raise ValueError(f"hamming_matrix: unsupported device {a.device}")


class MatchResult(NamedTuple):
    idx_b: torch.Tensor  # (..., Na) matched column in B, -1 if none
    dist: torch.Tensor  # (..., Na) best distance
    valid: torch.Tensor  # (..., Na) bool


BIG = 1 << 20


def match(
    dist: torch.Tensor,  # (..., Na, Nb) int32 distances
    mask: torch.Tensor = None,  # (..., Na, Nb) bool allowed pairs (gating)
    max_distance: int = 60,
    ratio: float = 0.0,
    mutual: bool = True,
) -> MatchResult:
    """Best-match selection: distance threshold, optional best/second-best
    ratio, and mutual (cross-check) consistency. Ties resolve to the lowest
    index, as ``jnp.argmin`` does."""
    d = dist
    if mask is not None:
        d = torch.where(mask, d, torch.full_like(d, BIG))
    Na = d.shape[-2]
    best = torch.argmin(d, dim=-1)
    best_d = torch.gather(d, -1, best[..., None])[..., 0]
    ok = best_d <= max_distance
    if ratio > 0.0:
        d2 = d.scatter(-1, best[..., None], BIG)
        second = torch.amin(d2, dim=-1)
        ok = ok & (best_d.to(torch.float32) <= ratio * second.to(torch.float32))
    if mutual:
        col_best = torch.argmin(d, dim=-2)  # (..., Nb)
        rows = torch.arange(Na, device=d.device)
        ok = ok & (torch.gather(col_best, -1, best) == rows)
    return MatchResult(
        idx_b=torch.where(ok, best, torch.full_like(best, -1)).to(torch.int32),
        dist=best_d.to(torch.int32),
        valid=ok,
    )


def match_descriptors(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    mask: torch.Tensor = None,
    max_distance: int = 60,
    ratio: float = 0.0,
    mutual: bool = True,
    hamming=hamming_matrix,
) -> MatchResult:
    """Distance matrix + selection. ``desc_a`` may carry a batch dim
    (B, Na, W) against a shared ``desc_b`` (Nb, W). ``hamming`` picks the
    distance-matrix function (the dispatching wrapper by default; the plain
    version to compare with it on the card)."""
    d = hamming(desc_a, desc_b)
    m = valid_a[..., :, None] & valid_b[..., None, :]
    if mask is not None:
        m = m & mask
    return match(d, m, max_distance=max_distance, ratio=ratio, mutual=mutual)
