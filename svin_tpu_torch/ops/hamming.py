"""Hamming-distance matching: XOR + popcount distance matrix (hand-written
CUDA kernel ``csrc/hamming.cu`` with its plain PyTorch version beside it),
best-match selection with distance threshold, ratio test and mutual
consistency, the fused matcher (hand-written CUDA kernel
``csrc/hamming_match.cu``: distances, mask and selection in one launch,
one thread-block cluster per batch element, launch plan ``match_plan``)
that the engine's three matchers and loop verification run on the card,
and the nearest codeword (hand-written CUDA kernel
``csrc/hamming_nearest.cu``: distances and the
first-index argmin in one pass) that every word assignment of the loop
closer runs on the card.

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


def popcount(x: torch.Tensor) -> torch.Tensor:
    """The set bits of each int32 word (the sign bit counts), by a 256-entry
    byte table (exact)."""
    lut = _POPCOUNT8.to(x.device)
    return lut[x & 0xFF] + lut[(x >> 8) & 0xFF] + lut[(x >> 16) & 0xFF] + lut[(x >> 24) & 0xFF]


def hamming_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Na, W) x (..., Nb, W) int32 words → (..., Na, Nb) int32, by XOR
    and ``popcount`` (exact)."""
    return popcount(a[..., :, None, :] ^ b[..., None, :, :]).sum(dim=-1, dtype=torch.int32)


def hamming_matrix_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: a (Na, W) or (B, Na, W), b (Nb, W) (shared by the
    batch) or (B, Nb, W), int32 contiguous on one CUDA device, W ≤ 8.
    Launches on the current stream, does not synchronise."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"hamming_matrix_cuda takes int32 words, got {a.dtype}, {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or a.shape[-1] != b.shape[-1]:
        raise ValueError(f"hamming_matrix_cuda shapes: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if b.dim() == 3 and (a.dim() != 3 or b.shape[0] != a.shape[0]):
        raise ValueError(f"hamming_matrix_cuda batch mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("hamming_matrix_cuda needs contiguous a and b")
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"hamming_matrix_cuda needs CUDA tensors on one device, got {a.device}, {b.device}")
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


def nearest_codeword_plain(desc: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """(..., K, W) x (..., V, W) int32 words → (..., K) int64: the first
    index of the minimum Hamming distance, ``argmin`` of
    ``hamming_matrix_plain``."""
    return torch.argmin(hamming_matrix_plain(desc, vocab), dim=-1)


def nearest_codeword_cuda(desc: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: desc (K, W) or (B, K, W), vocab (V, W) (shared by the
    batch) or (B, V, W), int32 contiguous on one CUDA device, W ≤ 8, V ≥ 1;
    bit for bit ``nearest_codeword_plain``, ties to the lowest index,
    without the distance matrix. Launches on the current stream, does not
    synchronise."""
    a, b = desc, vocab
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"nearest_codeword_cuda takes int32 words, got {a.dtype}, {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or a.shape[-1] != b.shape[-1]:
        raise ValueError(f"nearest_codeword_cuda shapes: desc {tuple(a.shape)}, vocab {tuple(b.shape)}")
    if b.dim() == 3 and (a.dim() != 3 or b.shape[0] != a.shape[0]):
        raise ValueError(f"nearest_codeword_cuda batch mismatch: desc {tuple(a.shape)}, vocab "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("nearest_codeword_cuda needs contiguous desc and vocab")
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"nearest_codeword_cuda needs CUDA tensors on one device, got {a.device}, "
                         f"{b.device}")
    K, V, W = a.shape[-2], b.shape[-2], a.shape[-1]
    if V < 1:
        raise ValueError("nearest_codeword_cuda: an empty codebook")
    lib = cuda_lib.load()
    if W < 1 or W > lib.hamming_nearest_max_words():
        raise ValueError(f"nearest_codeword_cuda: W={W} words not supported")
    batch = a.shape[0] if a.dim() == 3 else 1
    out = torch.empty(a.shape[:-1], dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.hamming_nearest(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), batch, K, V, W, V * W if b.dim() == 3 else 0,
            ctypes.c_void_p(stream),
        )
    cuda_lib.check(lib, err, "hamming_nearest")
    nearest_codeword_cuda.launches += 1
    return out


nearest_codeword_cuda.launches = 0


def nearest_codeword(desc: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per descriptor: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if desc.device.type == "cuda":
        return nearest_codeword_cuda(desc, vocab)
    if desc.device.type == "cpu":
        return nearest_codeword_plain(desc, vocab)
    raise ValueError(f"nearest_codeword: unsupported device {desc.device}")


# The fused matcher's launch plan (csrc/hamming_match.cu): one cluster of
# MATCH_CLUSTER CTAs per batch element, a's rows split over them, b in
# chunks of MATCH_CHUNK columns, each column's minimum owned by one CTA in a
# table of at most MATCH_MAX_COLS_PER_CTA entries.
MATCH_CLUSTER = 16
MATCH_CHUNK = 256
MATCH_MAX_COLS_PER_CTA = 2048
MATCH_MAX_WORDS = 8
MATCH_MAX_NB = MATCH_CLUSTER * MATCH_MAX_COLS_PER_CTA  # 32,768: the tables' cap
MATCH_MAX_NA = (1 << 23) - 1  # a column minimum's 32-bit key: distance over 23 bits of row


class MatchPlan(NamedTuple):
    rows_per_cta: int  # CTA q of MATCH_CLUSTER matches rows [q r, (q + 1) r) of a
    cols_per_cta: int  # CTA q owns the column minima of columns [q c, (q + 1) c)


def match_plan(Na: int, Nb: int, W: int) -> MatchPlan:
    """The fused matcher's launch plan for (Na, W) x (Nb, W) words; raises
    for W outside 1..8, for Na past ``MATCH_MAX_NA`` and for Nb outside
    1..``MATCH_MAX_NB`` (the column minima live in the cluster's shared
    memory). Na = 0 is an empty call, which launches nothing."""
    if not 1 <= W <= MATCH_MAX_WORDS:
        raise ValueError(f"match_descriptors_cuda: W={W} words not supported (1..{MATCH_MAX_WORDS})")
    if not 0 <= Na <= MATCH_MAX_NA:
        raise ValueError(f"match_descriptors_cuda: Na={Na} outside 0..{MATCH_MAX_NA} (a column "
                         f"minimum's key keeps 23 bits of row)")
    if not 1 <= Nb <= MATCH_MAX_NB:
        raise ValueError(f"match_descriptors_cuda: Nb={Nb} outside 1..{MATCH_MAX_NB} (the column "
                         f"minima of {MATCH_CLUSTER} CTAs' shared memory)")
    return MatchPlan(rows_per_cta=max(1, -(-Na // MATCH_CLUSTER)), cols_per_cta=-(-Nb // MATCH_CLUSTER))


_match_lib_checked = False


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


def match_descriptors_plain(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    mask: torch.Tensor = None,
    max_distance: int = 60,
    ratio: float = 0.0,
    mutual: bool = True,
) -> MatchResult:
    """Distance matrix + selection, the plain version: ``match`` of
    ``hamming_matrix_plain`` under the mask valid_a ⊗ valid_b (& ``mask``).
    ``desc_a`` may carry a batch dim (B, Na, W) against a shared ``desc_b``
    (Nb, W) or a batch of them (B, Nb, W)."""
    d = hamming_matrix_plain(desc_a, desc_b)
    m = valid_a[..., :, None] & valid_b[..., None, :]
    if mask is not None:
        m = m & mask
    return match(d, m, max_distance=max_distance, ratio=ratio, mutual=mutual)


def match_descriptors_cuda(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    mask: torch.Tensor = None,
    max_distance: int = 60,
    ratio: float = 0.0,
    mutual: bool = True,
) -> MatchResult:
    """The fused CUDA matcher (``csrc/hamming_match.cu``): bit for bit
    ``match_descriptors_plain``, without the distance matrix in device
    memory. ``desc_a`` (Na, W) or (B, Na, W) int32, ``desc_b`` (Nb, W)
    (shared by the batch) or (B, Nb, W), ``valid_a`` ``desc_a.shape[:-1]``
    bool, ``valid_b`` (Nb,) or (B, Nb) bool, ``mask`` ``desc_a.shape[:-1] +
    (Nb,)`` bool or None; all contiguous on one CUDA device, W ≤ 8, 1 ≤ Nb ≤
    ``MATCH_MAX_NB`` (``match_plan``). One kernel launch on the current
    stream, no scratch; does not synchronise."""
    a, b, va, vb = desc_a, desc_b, valid_a, valid_b
    tensors = (a, b, va, vb) + (() if mask is None else (mask,))
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"match_descriptors_cuda takes int32 words, got {a.dtype}, {b.dtype}")
    if any(t.dtype != torch.bool for t in tensors[2:]):
        raise TypeError("match_descriptors_cuda takes bool valid flags and mask")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or a.shape[-1] != b.shape[-1]:
        raise ValueError(f"match_descriptors_cuda shapes: a {tuple(a.shape)}, b {tuple(b.shape)}")
    batched_b = b.dim() == 3
    if batched_b and (a.dim() != 3 or b.shape[0] != a.shape[0]):
        raise ValueError(f"match_descriptors_cuda batch mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}")
    Na, Nb, W = a.shape[-2], b.shape[-2], a.shape[-1]
    if va.shape != a.shape[:-1] or vb.shape not in ((Nb,), b.shape[:-1]):
        raise ValueError(f"match_descriptors_cuda valid shapes: {tuple(va.shape)}, {tuple(vb.shape)}")
    if mask is not None and mask.shape != a.shape[:-1] + (Nb,):
        raise ValueError(f"match_descriptors_cuda mask shape {tuple(mask.shape)}")
    plan = match_plan(Na, Nb, W)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("match_descriptors_cuda needs contiguous inputs")
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError(f"match_descriptors_cuda needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    lib = _match_lib()
    batch = a.shape[0] if a.dim() == 3 else 1
    idx = torch.empty(a.shape[:-1], dtype=torch.int32, device=a.device)
    dist = torch.empty_like(idx)
    valid = torch.empty(a.shape[:-1], dtype=torch.bool, device=a.device)
    if idx.numel() == 0:
        return MatchResult(idx_b=idx, dist=dist, valid=valid)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.hamming_match(
            ptr(a), ptr(b), ptr(va), ptr(vb), ctypes.c_void_p(None if mask is None else mask.data_ptr()),
            batch, Na, Nb, W, Nb * W if batched_b else 0, Nb if vb.dim() == 2 else 0,
            int(max_distance), int(ratio > 0.0), float(ratio), int(bool(mutual)),
            plan.rows_per_cta, plan.cols_per_cta, ptr(idx), ptr(dist), ptr(valid),
            ctypes.c_void_p(stream),
        )
    cuda_lib.check(lib, err, "hamming_match")
    match_descriptors_cuda.launches += 1
    return MatchResult(idx_b=idx, dist=dist, valid=valid)


def _match_lib():
    """The kernel library, its matcher's constants checked once against
    ``match_plan``'s."""
    global _match_lib_checked
    lib = cuda_lib.load()
    if not _match_lib_checked:
        got = (lib.hamming_match_cluster(), lib.hamming_match_chunk(),
               lib.hamming_match_max_cols_per_cta(), lib.hamming_match_max_words())
        want = (MATCH_CLUSTER, MATCH_CHUNK, MATCH_MAX_COLS_PER_CTA, MATCH_MAX_WORDS)
        if got != want:
            raise RuntimeError(f"csrc/hamming_match.cu's plan constants {got} != ops/hamming.py's {want}")
        _match_lib_checked = True
    return lib


match_descriptors_cuda.launches = 0


def match_descriptors(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    mask: torch.Tensor = None,
    max_distance: int = 60,
    ratio: float = 0.0,
    mutual: bool = True,
) -> MatchResult:
    """Descriptor matching: the fused CUDA matcher for CUDA tensors, the
    plain version for CPU tensors."""
    if desc_a.device.type == "cuda":
        return match_descriptors_cuda(desc_a, desc_b, valid_a, valid_b, mask,
                                      max_distance=max_distance, ratio=ratio, mutual=mutual)
    if desc_a.device.type == "cpu":
        return match_descriptors_plain(desc_a, desc_b, valid_a, valid_b, mask,
                                       max_distance=max_distance, ratio=ratio, mutual=mutual)
    raise ValueError(f"match_descriptors: unsupported device {desc_a.device}")
