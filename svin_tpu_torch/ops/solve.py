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
  the cluster's shared memory; its launch plan is ``cluster_plan``);
- anything else on CUDA (D > 1024, float64, which keeps Cholesky for its
  precision as the reference does): ``solve_spd_library``, the plain
  version counted as the library route;
- a CPU tensor: ``solve_spd_plain``.

This is dispatch by shape and dtype, as the reference's; there is no
fallback from a kernel that fails to the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import cuda_lib

# the largest D the JAX package's Pallas kernel takes (svin_tpu/ops/solve.py)
KERNEL_MAX_D = 1024

# The cluster kernel's launch plan (csrc/spd_solve_cluster.cu reads it as
# ints): 32 x 32 tiles of the padded lower triangle, each block row whole in
# one CTA's shared memory.
TILE = 32
TILE_BYTES = TILE * TILE * 4
SMEM_PER_CTA = 232_448  # the H100's opt-in shared memory per block
STATIC_SMEM_RESERVE = 2048  # the kernel's static shared memory (1,312 B), left out of the plan
# per CTA beside its tiles and ring: Linv, the back substitution's partials
# (32 x 32), the diagonal scratch (32 x 33), the cluster's partials of one
# block (16 x 32), y_k and a flag word; plus 32 floats per row slot
FIXED_SMEM = TILE_BYTES + TILE * TILE * 4 + TILE * (TILE + 1) * 4 + 16 * TILE * 4 + TILE * 4 + 16
# ring slots for the panel tiles pulled from other CTAs: two halves, a chunk
# of up to 8 tiles landing in one while the other's are used
MIN_RING, MAX_RING = 4, 16
CLUSTER_SIZES = (8, 16)  # 8 is portable; 16 only when 8 cannot hold the triangle
MAX_NT = KERNEL_MAX_D // TILE


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """How ``spd_solve_cluster`` lays a D x D system over one cluster."""
    D: int
    nt: int  # block rows of 32 (the padded D over 32)
    cluster: int  # CTAs per system
    owner: tuple  # per block row, the CTA that holds it
    base: tuple  # per block row r, the index of tile (r, 0) in its owner's tiles
    slot: tuple  # per block row, its row slot (b, y, x) in its owner
    ntiles: int  # tiles per CTA (the most any CTA holds)
    nslots: int  # row slots per CTA
    ring: int  # ring slots for pulled panel tiles (even: two halves)
    smem_bytes: int  # dynamic shared memory per CTA

    def as_ints(self) -> list:
        pad = [0] * (MAX_NT - self.nt)
        return ([self.cluster, self.ntiles, self.ring, self.smem_bytes] + list(self.owner) + pad
                + list(self.slot) + pad + list(self.base) + pad)


def _pack(nt: int, cluster: int) -> list:
    """Block rows 0..nt-1 (row r holds r + 1 tiles) over ``cluster`` CTAs:
    first-fit decreasing into CTAs of a capacity raised from the lower bound
    (the larger of the largest row and the even share) until every row fits.
    With as many CTAs as row pairs this gives the pairs (r, nt-1-r)."""
    cap = max(nt, -(-nt * (nt + 1) // 2 // cluster))
    while True:
        rows, load = [[] for _ in range(cluster)], [0] * cluster
        for r in reversed(range(nt)):
            c = next((q for q in range(cluster) if load[q] + r + 1 <= cap), None)
            if c is None:
                break
            rows[c].append(r)
            load[c] += r + 1
        else:
            return rows
        cap += 1


@functools.lru_cache(maxsize=None)
def cluster_plan(D: int) -> ClusterPlan:
    """The launch plan of the cluster kernel for a D x D system, 1 ≤ D ≤
    1024: block row r (32 rows, r + 1 tiles) goes whole to one CTA, by
    first-fit decreasing under the least per-CTA tile count that fits
    (``_pack``); 8 CTAs while that leaves room for at least ``MIN_RING``
    ring slots in every CTA, else 16. Raises if neither fits."""
    if not 1 <= D <= KERNEL_MAX_D:
        raise ValueError(f"cluster_plan: D={D} outside 1..{KERNEL_MAX_D}")
    nt = -(-D // TILE)
    budget = SMEM_PER_CTA - STATIC_SMEM_RESERVE
    for cluster in CLUSTER_SIZES:
        rows = _pack(nt, cluster)
        load = [sum(r + 1 for r in mine) for mine in rows]
        owner, base, slot = [0] * nt, [0] * nt, [0] * nt
        for c, mine in enumerate(rows):
            at = 0
            for s, r in enumerate(sorted(mine)):
                owner[r], base[r], slot[r] = c, at, s
                at += r + 1
        ntiles, nslots = max(load), max(len(m) for m in rows)
        fixed = ntiles * TILE_BYTES + FIXED_SMEM + nslots * TILE * 4
        ring = min(MAX_RING, (budget - fixed) // TILE_BYTES // 2 * 2)
        if ring >= MIN_RING:
            return ClusterPlan(D=D, nt=nt, cluster=cluster, owner=tuple(owner), base=tuple(base),
                               slot=tuple(slot), ntiles=ntiles, nslots=nslots, ring=ring,
                               smem_bytes=fixed + ring * TILE_BYTES)
    raise ValueError(f"cluster_plan: D={D} does not fit a cluster of {CLUSTER_SIZES[-1]}")


@functools.lru_cache(maxsize=None)
def _plan_array(D: int):
    """``cluster_plan(D)`` as the kernel's int array (read only by it)."""
    return (ctypes.c_int * (4 + 3 * MAX_NT))(*cluster_plan(D).as_ints())


def cluster_max_active(D: int, device=None) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``cluster_plan(D)`` on
    ``device``: how many such clusters the card holds at once (0: it cannot
    schedule one)."""
    lib = cuda_lib.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.spd_solve_cluster_max_active(D, _plan_array(D), ctypes.byref(out))
    cuda_lib.check(lib, err, "spd_solve_cluster_max_active")
    return out.value


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
    cluster per system (``cluster_plan``: 8 CTAs, or 16 where the triangle
    needs them), the matrix held in the cluster's shared memory. H (D, D) or
    (B, D, D) f32 contiguous on a CUDA device (only its lower triangle is
    read), b (D,) or (B, D), 1 ≤ D ≤ 1024; a system with a pivot ≤ 0 or not
    finite gives an all-NaN x. A cluster the card cannot schedule raises the
    launch's CUDA error. Launches on the current stream, does not
    synchronise."""
    _check("spd_solve_cluster", H, b)
    D = H.shape[-1]
    batch = 1 if H.dim() == 2 else H.shape[0]
    x = torch.empty_like(b)
    if x.numel() == 0:
        return x
    plan = _plan_array(D)
    lib = cuda_lib.load()
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.spd_solve_cluster(
            ctypes.c_void_p(H.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(x.data_ptr()), batch, D, plan, ctypes.c_void_p(stream),
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
