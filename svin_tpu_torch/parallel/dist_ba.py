"""Global bundle adjustment: the flat and the bucketed observation layouts,
each solved by Gauss-Newton on the Schur-reduced camera system, on one
device or sharded over a process mesh.

Counterpart of the JAX package's ``parallel/dist_ba.py``. Each GN iteration
assembles the normal equations with ``index_add_`` (the JAX package's
segment sums, and in the bucketed layout its one-hot matmuls, which exist to
keep scatters off the TPU), eliminates the 3x3 landmark blocks, forms the
reduced system H = Hpp − Wᵀ Hll⁻¹ W of D = 6K as one (D, 3L) x (3L, D)
matmul, damps it and solves it with ``solve`` (``ops.solve.solve_spd`` by
default: a float32 CUDA system of D ≤ 1024 goes to a hand-written kernel,
the one-block kernel to D = 320 and the cluster kernel past it; see its
route counts). The GN loops make no host synchronisation. On CUDA the entry
points run float32 products in full float32 (TF32 off).

Sharded (``make_sharded_ba``, ``make_sharded_ba_bucketed``): landmarks and
their observations are cut into one block per rank of a
``runtime.ProcessMesh``, poses are replicated. Each rank eliminates its
landmarks; the undamped reduced system H, b and the cost are summed over
the mesh (``ProcessMesh.psum``, three ``all_reduce`` per GN iteration where
the JAX package has three ``psum``), then every rank damps and solves the
same system and back-substitutes its own landmarks.

``partition_problem`` and ``bucket_problem`` are host numpy re-layouts, as
in the JAX package; their tensors land on the problem's device.
"""
from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..cameras import project, project_jacobian
from ..estimator.rig import RigParams
from ..kinematics import quaternion as quat
from ..ops.linalg3 import inv3x3
from ..ops.solve import solve_spd
from ..pipeline.vio import _float32_matmuls
from .runtime import ProcessMesh, _host, shard


class GlobalMapProblem(NamedTuple):
    """Global BA problem: K poses, L landmarks, O observations (flat)."""

    pose_r: torch.Tensor  # (K,3)
    pose_q: torch.Tensor  # (K,4)
    pose_fixed: torch.Tensor  # (K,) bool, gauge anchors
    lm: torch.Tensor  # (L,3)
    lm_valid: torch.Tensor  # (L,)
    obs_uv: torch.Tensor  # (O,2)
    obs_pose: torch.Tensor  # (O,) int
    obs_lm: torch.Tensor  # (O,) int, global landmark index
    obs_cam: torch.Tensor  # (O,) int
    obs_valid: torch.Tensor  # (O,)


class BucketedProblem(NamedTuple):
    """Global BA problem with per-landmark observation buckets (L, R)."""

    pose_r: torch.Tensor  # (K,3)
    pose_q: torch.Tensor  # (K,4)
    pose_fixed: torch.Tensor  # (K,)
    lm: torch.Tensor  # (L,3)
    lm_valid: torch.Tensor  # (L,)
    obs_uv: torch.Tensor  # (L,R,2)
    obs_pose: torch.Tensor  # (L,R) int, global pose index
    obs_cam: torch.Tensor  # (L,R) int
    obs_valid: torch.Tensor  # (L,R)


def _reproj(r_WS, q_WS, fixed, p_W, lm_ok, uv, ci, ok, rig: RigParams):
    """Whitened reprojection residuals (..., 2) and Jacobians wrt the pose
    [dr, dα] (..., 2, 6) and the landmark (..., 2, 3), batched over the
    leading dims; a Huber-style IRLS weight at 3 px, zero where invalid or
    behind 0.2 m, and no pose columns for fixed poses."""
    dtype = r_WS.dtype
    C_SW = quat.to_rotation_matrix(q_WS).transpose(-1, -2)
    C_CS = quat.to_rotation_matrix(rig.T_SC_q[ci]).transpose(-1, -2)
    d = p_W - r_WS
    p_S = (C_SW @ d[..., None])[..., 0]
    p_C = (C_CS @ (p_S - rig.T_SC_r[ci])[..., None])[..., 0]
    cam = rig.camera(ci)
    uv_hat, _ = project(cam, p_C)
    ok = ok & (p_C[..., 2] > 0.2) & lm_ok
    Juv = project_jacobian(cam, p_C)
    C_CW = C_CS @ C_SW
    Jp = -Juv @ torch.cat([-C_CW, C_CW @ quat.cross_mx(d)], dim=-1)
    Jp = Jp * (1.0 - fixed.to(dtype))[..., None, None]  # gauge: no update to fixed poses
    Jl = -Juv @ C_CW
    r = uv - uv_hat
    n = torch.linalg.norm(r, dim=-1)
    w = torch.sqrt(torch.where(n > 3.0, 3.0 / n, torch.ones_like(n)))
    w = torch.where(ok, w, torch.zeros_like(w))
    return w[..., None] * r, w[..., None, None] * Jp, w[..., None, None] * Jl


def _reproj_eval(prob: GlobalMapProblem, rig: RigParams, lm_base: int = 0):
    """(r, Jp, Jl, local landmark index) per flat observation; ``lm_base``
    is the global index of the problem's first landmark. Invalid
    observations (a shard's padding, whose landmark lies on shard 0) take
    local landmark 0 and add zeros."""
    pi, ci = prob.obs_pose.long(), prob.obs_cam.long()
    li = prob.obs_lm.long() - lm_base
    li = torch.where(prob.obs_valid, li, torch.zeros_like(li))
    r, Jp, Jl = _reproj(prob.pose_r[pi], prob.pose_q[pi], prob.pose_fixed[pi], prob.lm[li],
                        prob.lm_valid[li], prob.obs_uv, ci, prob.obs_valid, rig)
    return r, Jp, Jl, li


def _pose_blocks(r, Jp, Jl, pose, lm_row, K: int, L: int):
    """Hpp (K,6,6), bp (K,6) and W as the flat (3L, 6K) matrix, summed over
    observations by ``index_add_`` (rows by pose, W by landmark x pose)."""
    JpT = Jp.transpose(-1, -2)
    z = lambda *s: torch.zeros(s, dtype=r.dtype, device=r.device)  # noqa: E731
    Hpp = z(K, 6, 6).index_add_(0, pose, JpT @ Jp)
    bp = z(K, 6).index_add_(0, pose, (JpT @ r[..., None])[..., 0])
    W = z(L * K, 3, 6).index_add_(0, lm_row * K + pose, Jl.transpose(-1, -2) @ Jp)
    Wf = W.view(L, K, 3, 6).permute(0, 2, 1, 3).reshape(L * 3, K * 6)
    return Hpp, bp, Wf


def _local_normal_eqs(prob: GlobalMapProblem, rig: RigParams, lm_base: int, K: int, L: int):
    r, Jp, Jl, li = _reproj_eval(prob, rig, lm_base)
    Hpp, bp, Wf = _pose_blocks(r, Jp, Jl, prob.obs_pose.long(), li, K, L)
    JlT = Jl.transpose(-1, -2)
    Hll = torch.zeros(L, 3, 3, dtype=r.dtype, device=r.device).index_add_(0, li, JlT @ Jl)
    bl = torch.zeros(L, 3, dtype=r.dtype, device=r.device).index_add_(
        0, li, (JlT @ r[..., None])[..., 0])
    return Hpp, bp, Hll, bl, Wf, _cost(r)


def _eliminate(Hpp, bp, Hll, bl, Wf, lm_valid, lam: float):
    """Eliminate the landmarks: the undamped reduced camera system H (D, D),
    b (D,) and the damped landmark blocks' inverses Hll⁻¹ (L, 3, 3)."""
    K, L = Hpp.shape[0], Hll.shape[0]
    D = K * 6
    damp_l = lam * torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1), min=1e-6) + (
        ~lm_valid).to(Hpp.dtype)[:, None]
    Hll_inv = inv3x3(Hll + torch.diag_embed(damp_l))
    HiW = (Hll_inv @ Wf.view(L, 3, D)).reshape(L * 3, D)
    Hib = (Hll_inv @ bl[..., None]).reshape(L * 3)
    H = -(Wf.T @ HiW)
    H.view(K, 6, K, 6).diagonal(dim1=0, dim2=2).add_(Hpp.permute(1, 2, 0))  # + the Hpp blocks
    return H, bp.reshape(D) - Wf.T @ Hib, Hll_inv


def _solve_reduced(H, b, Hll_inv, bl, Wf, pose_fixed, lam: float, solve: Callable):
    """Damp the reduced system, solve it with ``solve`` and back-substitute
    the landmarks: (dx (K,6), dl (L,3))."""
    L, K = Hll_inv.shape[0], pose_fixed.shape[0]
    dtype = H.dtype
    dH = torch.diagonal(H)
    damp = (lam * torch.clamp(dH, min=1e-6) + pose_fixed.repeat_interleave(6).to(dtype)
            + (dH < 1e-9).to(dtype))  # the last term: unobserved poses
    dx = -solve(H + torch.diag(damp), b)
    dl = -(Hll_inv @ (bl + (Wf @ dx).view(L, 3))[..., None])[..., 0]
    return dx.view(K, 6), dl


def _gn_iteration(prob: GlobalMapProblem, rig: RigParams, lm_base: int, K: int, L: int,
                  lam: float, solve: Callable = solve_spd, psum: Optional[Callable] = None):
    """One GN iteration: (dx, dl, cost). With ``psum`` (a mesh's reduction)
    the reduced system and the cost are summed over the mesh before the
    damping."""
    Hpp, bp, Hll, bl, Wf, cost = _local_normal_eqs(prob, rig, lm_base, K, L)
    H, b, Hll_inv = _eliminate(Hpp, bp, Hll, bl, Wf, prob.lm_valid, lam)
    if psum is not None:
        H, b, cost = psum(H), psum(b), psum(cost)
    dxk, dl = _solve_reduced(H, b, Hll_inv, bl, Wf, prob.pose_fixed, lam, solve)
    return dxk, dl, cost


def _cost(r: torch.Tensor) -> torch.Tensor:
    """The GN cost ½‖r‖² of whitened residuals."""
    return 0.5 * torch.sum(r * r)


def _apply(prob, dxk, dl):
    """The GN update of either layout (``_apply_bucketed`` in the JAX
    package is the same): fixed poses and invalid landmarks stay."""
    fixed = prob.pose_fixed[:, None]
    r_new = torch.where(fixed, prob.pose_r, prob.pose_r + dxk[:, :3])
    q_new = torch.where(fixed, prob.pose_q,
                        quat.normalize(quat.multiply(quat.exp(dxk[:, 3:6]), prob.pose_q)))
    lm_new = torch.where(prob.lm_valid[:, None], prob.lm + dl, prob.lm)
    return prob._replace(pose_r=r_new, pose_q=q_new, lm=lm_new)


@_float32_matmuls()
def ba_solve_local(prob: GlobalMapProblem, rig: RigParams, iters: int = 10, lam: float = 1e-3,
                   solve: Callable = solve_spd) -> Tuple[GlobalMapProblem, torch.Tensor]:
    """Single-device GN on the flat layout: (problem, final cost)."""
    K, L = prob.pose_r.shape[0], prob.lm.shape[0]
    for _ in range(iters):
        dxk, dl, _ = _gn_iteration(prob, rig, 0, K, L, lam, solve)
        prob = _apply(prob, dxk, dl)
    return prob, _cost(_reproj_eval(prob, rig)[0])


def partition_problem(prob: GlobalMapProblem, n: int) -> GlobalMapProblem:
    """Re-order observations so each lives on its landmark's shard of
    ``n`` and pad the shards' observation counts to a common multiple of 8
    (host numpy)."""
    L = prob.lm.shape[0]
    if L % n:
        raise ValueError(f"partition_problem: {L} landmarks do not split into {n} shards")
    obs_shard = _host(prob.obs_lm) // (L // n)
    valid = _host(prob.obs_valid)
    per = [np.nonzero((obs_shard == s) & valid)[0] for s in range(n)]
    cap = -(-max(len(i) for i in per) // 8) * 8
    dev = prob.obs_uv.device

    def gather_pad(x, fill=0):
        x = _host(x)
        blocks = [np.concatenate([x[idx], np.full((cap - len(idx),) + x.shape[1:], fill, x.dtype)])
                  for idx in per]
        return torch.from_numpy(np.concatenate(blocks)).to(dev)

    return prob._replace(obs_uv=gather_pad(prob.obs_uv), obs_pose=gather_pad(prob.obs_pose),
                         obs_lm=gather_pad(prob.obs_lm), obs_cam=gather_pad(prob.obs_cam),
                         obs_valid=gather_pad(prob.obs_valid, fill=False))


def bucket_problem(prob: GlobalMapProblem, R: int = 0) -> BucketedProblem:
    """Host re-layout: observations grouped by landmark into (L, R) buckets
    (R = the most observations of a landmark, rounded up to a multiple of 4;
    observations past a given R are dropped, with a log note)."""
    L = prob.lm.shape[0]
    valid = _host(prob.obs_valid)
    lm_idx = _host(prob.obs_lm)[valid]
    counts = np.bincount(lm_idx, minlength=L)
    r_needed = int(counts.max()) if counts.size else 1
    if R <= 0:
        R = max(4, -(-r_needed // 4) * 4)
    elif r_needed > R:
        logging.getLogger(__name__).info(
            "bucket_problem: dropping %d observations beyond bucket size %d",
            int(np.sum(np.maximum(counts - R, 0))), R)
    uv_all = _host(prob.obs_uv)
    uv = np.zeros((L, R, 2), uv_all.dtype)
    pose = np.zeros((L, R), np.int64)
    cam = np.zeros((L, R), np.int64)
    ok = np.zeros((L, R), bool)
    # slot = rank within the landmark's run after a stable sort by landmark
    order = np.argsort(lm_idx, kind="stable")
    lm_sorted = lm_idx[order]
    run_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_sorted = np.arange(lm_sorted.shape[0]) - run_start[lm_sorted]
    keep = slot_sorted < R
    li, si, oi = lm_sorted[keep], slot_sorted[keep], order[keep]
    uv[li, si] = uv_all[valid][oi]
    pose[li, si] = _host(prob.obs_pose)[valid][oi]
    cam[li, si] = _host(prob.obs_cam)[valid][oi]
    ok[li, si] = True
    dev = prob.obs_uv.device
    return BucketedProblem(
        pose_r=prob.pose_r, pose_q=prob.pose_q, pose_fixed=prob.pose_fixed,
        lm=prob.lm, lm_valid=prob.lm_valid, obs_uv=torch.from_numpy(uv).to(dev),
        obs_pose=torch.from_numpy(pose).to(dev), obs_cam=torch.from_numpy(cam).to(dev),
        obs_valid=torch.from_numpy(ok).to(dev))


def _reproj_eval_bucketed(prob: BucketedProblem, rig: RigParams):
    """(r, Jp, Jl) over the (L, R) buckets; a bucket's landmark is its row."""
    pi = prob.obs_pose.long()
    L, R = pi.shape
    return _reproj(prob.pose_r[pi], prob.pose_q[pi], prob.pose_fixed[pi],
                   prob.lm[:, None, :].expand(L, R, 3), prob.lm_valid[:, None], prob.obs_uv,
                   prob.obs_cam.long(), prob.obs_valid, rig)


def _normal_eqs_bucketed(prob: BucketedProblem, rig: RigParams, K: int):
    """The landmark blocks as sums over the bucket axis; the pose blocks
    and W by ``index_add_`` over the flattened buckets."""
    L, R = prob.obs_pose.shape
    r, Jp, Jl = _reproj_eval_bucketed(prob, rig)
    JlT = Jl.transpose(-1, -2)
    Hll = (JlT @ Jl).sum(1)
    bl = (JlT @ r[..., None])[..., 0].sum(1)
    rows = torch.arange(L, device=r.device).repeat_interleave(R)
    Hpp, bp, Wf = _pose_blocks(r.reshape(L * R, 2), Jp.reshape(L * R, 2, 6),
                               Jl.reshape(L * R, 2, 3), prob.obs_pose.reshape(-1).long(), rows,
                               K, L)
    return Hpp, bp, Hll, bl, Wf, _cost(r)


def _gn_iteration_bucketed(prob: BucketedProblem, rig: RigParams, K: int, lam: float,
                           solve: Callable = solve_spd, psum: Optional[Callable] = None):
    Hpp, bp, Hll, bl, Wf, cost = _normal_eqs_bucketed(prob, rig, K)
    H, b, Hll_inv = _eliminate(Hpp, bp, Hll, bl, Wf, prob.lm_valid, lam)
    if psum is not None:
        H, b, cost = psum(H), psum(b), psum(cost)
    dxk, dl = _solve_reduced(H, b, Hll_inv, bl, Wf, prob.pose_fixed, lam, solve)
    return dxk, dl, cost


@_float32_matmuls()
def ba_solve_bucketed(prob: BucketedProblem, rig: RigParams, iters: int = 10, lam: float = 1e-3,
                      solve: Callable = solve_spd) -> Tuple[BucketedProblem, torch.Tensor]:
    """Single-device GN on the bucketed layout: (problem, final cost)."""
    K = prob.pose_r.shape[0]
    for _ in range(iters):
        dxk, dl, _ = _gn_iteration_bucketed(prob, rig, K, lam, solve)
        prob = _apply(prob, dxk, dl)
    return prob, _cost(_reproj_eval_bucketed(prob, rig)[0])


def _check_divides(what: str, n: int, **sizes) -> None:
    for name, v in sizes.items():
        if v % n:
            raise ValueError(f"{what}: {name} = {v} does not divide over {n} ranks")


def make_sharded_ba(mesh: ProcessMesh, rig: RigParams, K: int, L: int, O: int, iters: int = 10,
                    lam: float = 1e-3):
    """The sharded flat-layout BA step on ``mesh``: ``(step, shard)``.

    ``shard(prob)`` cuts this rank's block of a problem laid out by
    ``partition_problem(prob, mesh.size)`` (each observation on its
    landmark's shard; ``obs_lm`` global). ``step(local)`` runs ``iters`` GN
    iterations and returns (the local problem, the cost summed over the
    mesh); ``runtime.gather`` rebuilds the whole problem. The final cost is
    the last problem's, as ``ba_solve_local`` reports it (one sum; the JAX
    step runs a further GN iteration for it). The reduced system is solved
    by ``solve_spd``."""
    _check_divides("make_sharded_ba", mesh.size, L=L, O=O)
    Lloc = L // mesh.size
    lm_base = mesh.rank * Lloc

    @_float32_matmuls()
    def step(local: GlobalMapProblem) -> Tuple[GlobalMapProblem, torch.Tensor]:
        p = local
        for _ in range(iters):
            dxk, dl, _ = _gn_iteration(p, rig, lm_base, K, Lloc, lam, solve_spd, mesh.psum)
            p = _apply(p, dxk, dl)
        return p, mesh.psum(_cost(_reproj_eval(p, rig, lm_base)[0]))

    return step, lambda prob: shard(mesh, prob)


def make_sharded_ba_bucketed(mesh: ProcessMesh, rig: RigParams, K: int, L: int, iters: int = 10,
                             lam: float = 1e-3):
    """The sharded bucketed BA step on ``mesh``: ``(step, shard)``. The
    (L, ...) fields are cut into one block per rank (observations travel
    with their landmark's bucket); ``step(local)`` returns (the local
    problem, the cost summed over the mesh), as ``make_sharded_ba``."""
    _check_divides("make_sharded_ba_bucketed", mesh.size, L=L)

    @_float32_matmuls()
    def step(local: BucketedProblem) -> Tuple[BucketedProblem, torch.Tensor]:
        p = local
        for _ in range(iters):
            dxk, dl, _ = _gn_iteration_bucketed(p, rig, K, lam, solve_spd, mesh.psum)
            p = _apply(p, dxk, dl)
        return p, mesh.psum(_cost(_reproj_eval_bucketed(p, rig)[0]))

    return step, lambda prob: shard(mesh, prob)
