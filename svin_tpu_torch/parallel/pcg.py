"""Matrix-free preconditioned-CG solvers for graphs and maps past the dense
solves' reach: the 4-DoF and 6-DoF pose graphs and the bucketed bundle
adjustment, on one device.

Counterpart of the JAX package's ``parallel/pcg.py`` (its sharded factories,
``make_sharded_*`` and ``sharded_pose_major_index``, are not ported). Each
Gauss-Newton step solves its normal equations by ``_pcg``, a fixed number of
CG iterations from zero whose guards are ``torch.where``s, so the GN and CG
loops make no host synchronisation:

- pose graph: block-Jacobi (4x4 / 6x6 node blocks) plus a coarse level over
  groups of ``coarse_group`` consecutive nodes (additive two-level
  Schwarz), the exact Galerkin operator Hc = Pᵀ H P inverted once per GN
  step through ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve``
  (the JAX package's ``cho_factor`` / ``cho_solve`` in its PCG, ``inv`` in
  its banded solver, outside any kernel there too) and applied as one
  matvec. The matvec gathers both
  ends of every edge at once and sums back with one ``index_add_``. The
  4-DoF Jacobian is the analytic one of ``loopclosure.posegraph``, the
  6-DoF one forward mode, as there;
- BA: the Schur-reduced camera system (Hpp_damped − Wᵀ Hll⁻¹ W) is never
  formed; its matvec runs over the (L, R) observation buckets, with the
  per-pose sums by ``index_add_`` or, given ``pose_major_index``, by a
  gather and a sum.

On CUDA the entry points run float32 products in full float32 (TF32 off).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..estimator.rig import RigParams
from ..kinematics import quaternion as quat
from ..loopclosure.posegraph import (
    PoseGraph6Edges,
    PoseGraph6Nodes,
    PoseGraphEdges,
    PoseGraphNodes,
    _edge_jacobian_4dof,
    _edge_jacobian_6dof,
    _huber_sqrt_weight,
)
from ..ops.linalg3 import inv3x3
from ..pipeline.vio import _float32_matmuls
from .dist_ba import BucketedProblem, _apply, _cost, _host, _reproj_eval_bucketed


# ---------------------------------------------------------------------- PCG
def _pcg(matvec: Callable, b: torch.Tensor, precond: Callable, iters: int) -> torch.Tensor:
    """PCG on SPD ``A x = b`` from x0 = 0 for a fixed ``iters``; a vanishing
    residual freezes the iteration through the alpha/beta guards (no early
    exit, no host synchronisation)."""

    def dot(a, c):
        return torch.vdot(a.reshape(-1), c.reshape(-1))

    x = torch.zeros_like(b)
    r = b
    p = z = precond(r)
    rz = dot(r, z)
    for _ in range(iters):
        Ap = matvec(p)
        pAp = dot(p, Ap)
        ok = (pAp > 0) & (rz > 0)
        alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, Ap, value=-1.0)
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(ok, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = torch.addcmul(z, beta, p)
        rz = rz_new
    return x


def _inv_blocks(M: torch.Tensor) -> torch.Tensor:
    """Inverses of a batch of small SPD blocks (..., d, d): an unrolled
    Cholesky M = L Lᵀ and M⁻¹ = L⁻ᵀ L⁻¹, elementwise over the batch (the
    JAX package solves against the identity by LU)."""
    d = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(d):
        s = M[..., j:, j] - (L[..., j:, :j] @ L[..., j, :j, None])[..., 0]
        ljj = torch.sqrt(s[..., :1])
        L[..., j:j + 1, j] = ljj
        L[..., j + 1:, j] = s[..., 1:] / ljj
    X = torch.zeros_like(M)  # L⁻¹, lower triangular, row by row
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    for i in range(d):
        X[..., i, :] = (eye[i] - (L[..., i, None, :i] @ X[..., :i, :])[..., 0, :]) / L[..., i, i, None]
    return X.transpose(-1, -2) @ X


# ------------------------------------------------------------ BA (bucketed)
def pose_major_index(obs_pose, obs_valid, K: int, pad_mult: int = 8) -> torch.Tensor:
    """(K, Rp) index into the flattened (L·R) observation slots, row k
    listing the valid slots of pose k, padded with the sentinel L·R (host
    numpy, once per problem; on ``obs_pose``'s device). With it every
    per-pose reduction is a gather and a sum (the JAX package's TPU form;
    on the card ``index_add_`` serves as well)."""
    flat_pose = _host(obs_pose).reshape(-1)
    ok = _host(obs_valid).reshape(-1)
    n_slots = flat_pose.shape[0]
    nnz = int(ok.sum())
    order = np.argsort(np.where(ok, flat_pose, K), kind="stable")  # invalid slots last
    valid_order = order[:nnz]
    poses_sorted = flat_pose[valid_order]
    counts = np.bincount(poses_sorted, minlength=K)
    Rp = max(pad_mult, -(-int(counts.max() if nnz else 1) // pad_mult) * pad_mult)
    run_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(nnz) - run_start[poses_sorted]
    perm = np.full((K, Rp), n_slots, np.int64)
    perm[poses_sorted, slot] = valid_order
    return torch.from_numpy(perm).to(obs_pose.device if torch.is_tensor(obs_pose) else "cpu")


def _pose_reduce(g_flat, flat_pose, K: int, pose_perm: Optional[torch.Tensor]):
    """Σ over observations per pose: a gather and a sum with a pose-major
    index, else ``index_add_``."""
    if pose_perm is None:
        return torch.zeros((K,) + g_flat.shape[1:], dtype=g_flat.dtype,
                           device=g_flat.device).index_add_(0, flat_pose, g_flat)
    pad = torch.cat([g_flat, torch.zeros_like(g_flat[:1])])
    return pad[pose_perm].sum(1)


def _ba_assemble_pcg(prob: BucketedProblem, rig: RigParams, K: int, lam: float, pose_perm=None):
    """Evaluate the factors once: (r, Jp, Jl, Hll_inv, Hpp_damped, Minv,
    b_red, bl, cost), everything a PCG step needs."""
    L, R = prob.obs_pose.shape
    dtype = prob.pose_r.dtype
    r, Jp, Jl = _reproj_eval_bucketed(prob, rig)  # (L,R,2), (L,R,2,6), (L,R,2,3)
    JlT, JpT = Jl.transpose(-1, -2), Jp.transpose(-1, -2)
    Hll = (JlT @ Jl).sum(1)
    bl = (JlT @ r[..., None])[..., 0].sum(1)
    damp_l = lam * torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1), min=1e-6) + (
        ~prob.lm_valid).to(dtype)[:, None]
    Hll_inv = inv3x3(Hll + torch.diag_embed(damp_l))
    flat_pose = prob.obs_pose.reshape(L * R).long()
    Hpp = _pose_reduce((JpT @ Jp).reshape(L * R, 6, 6), flat_pose, K, pose_perm)
    bp = _pose_reduce((JpT @ r[..., None]).reshape(L * R, 6), flat_pose, K, pose_perm)
    # the RHS's Schur correction −Wᵀ Hll⁻¹ bl, matrix-free
    u = (Hll_inv @ bl[..., None])[..., 0]
    s = (Jl @ u[:, None, :, None])[..., 0]
    corr = _pose_reduce((JpT @ s[..., None]).reshape(L * R, 6), flat_pose, K, pose_perm)
    cost = _cost(r)
    dHpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    damp = (lam * torch.clamp(dHpp, min=1e-6) + prob.pose_fixed.to(dtype)[:, None]
            + (dHpp < 1e-9).to(dtype))  # the last term: unobserved poses
    Hpp_d = Hpp + torch.diag_embed(damp)
    return r, Jp, Jl, Hll_inv, Hpp_d, _inv_blocks(Hpp_d), bp - corr, bl, cost


def _ba_gn_step_pcg(prob: BucketedProblem, rig: RigParams, K: int, lam: float, cg_iters: int,
                    pose_perm=None):
    L, R = prob.obs_pose.shape
    r, Jp, Jl, Hll_inv, Hpp_d, Minv, b_red, bl, cost = _ba_assemble_pcg(
        prob, rig, K, lam, pose_perm)
    pose = prob.obs_pose.long()
    flat_pose = pose.reshape(L * R)
    JlT, JpT = Jl.transpose(-1, -2), Jp.transpose(-1, -2)

    def matvec(v):  # (K,6)
        t = (Jp @ v[pose][..., None])[..., 0]  # (L,R,2)
        u = (JlT @ t[..., None])[..., 0].sum(1)  # (L,3)
        u = (Hll_inv @ u[..., None])[..., 0]
        s = (Jl @ u[:, None, :, None])[..., 0]
        y2 = _pose_reduce((JpT @ s[..., None]).reshape(L * R, 6), flat_pose, K, pose_perm)
        return (Hpp_d @ v[..., None])[..., 0] - y2

    dx = _pcg(matvec, -b_red, lambda v: (Minv @ v[..., None])[..., 0], cg_iters)
    # landmark back-substitution: dl = −Hll⁻¹ (bl + W dx)
    t = (Jp @ dx[pose][..., None])[..., 0]
    w = (JlT @ t[..., None])[..., 0].sum(1)
    dl = -(Hll_inv @ (bl + w)[..., None])[..., 0]
    return dx, dl, cost


@_float32_matmuls()
def ba_solve_pcg(prob: BucketedProblem, rig: RigParams, iters: int = 10, cg_iters: int = 48,
                 lam: float = 1e-3, pose_perm=None) -> Tuple[BucketedProblem, torch.Tensor]:
    """Matrix-free GN + PCG on the bucketed layout: nothing scales with K².
    ``pose_perm`` (``pose_major_index``) turns the per-pose sums into
    gathers. Returns (problem, final cost)."""
    K = prob.pose_r.shape[0]
    for _ in range(iters):
        dxk, dl, _ = _ba_gn_step_pcg(prob, rig, K, lam, cg_iters, pose_perm)
        prob = _apply(prob, dxk, dl)
    return prob, _cost(_reproj_eval_bucketed(prob, rig)[0])


# ------------------------------------------------------------- pose graphs
def _pg_system(r, Ji, Jj, ei, ej, free, N: int, G: int):
    """The two-level PCG's pieces for one GN step of a pose graph whose
    whitened, free-masked edge terms are r (E,m), Ji, Jj (E,m,d): the
    right-hand side −b, the matvec, the preconditioner (the fine level's
    block inverses plus the inverse of the coarse Galerkin operator over
    groups of G consecutive nodes, damped, flat (Nc·d)²) and the cost."""
    d = Ji.shape[-1]
    dtype, dev = r.dtype, r.device
    E = ei.shape[0]
    idx = torch.cat([ei, ej])
    J2 = torch.cat([Ji, Jj])  # both ends' blocks, one row each
    J2T = J2.transpose(-1, -2)
    JtJ = J2T @ J2
    Hd = torch.zeros(N, d, d, dtype=dtype, device=dev).index_add_(0, idx, JtJ)
    b = torch.zeros(N, d, dtype=dtype, device=dev).index_add_(
        0, idx, (J2T @ torch.cat([r, r])[..., None])[..., 0])
    cost = _cost(r)
    Nc = -(-N // G)
    coarse = torch.arange(N, device=dev) // G
    ci, cj = coarse[ei], coarse[ej]
    Hij = Ji.transpose(-1, -2) @ Jj
    Hc = torch.zeros(Nc * Nc, d, d, dtype=dtype, device=dev).index_add_(
        0, torch.cat([ci * Nc + ci, cj * Nc + cj, ci * Nc + cj, cj * Nc + ci]),
        torch.cat([JtJ, Hij, Hij.transpose(-1, -2)]))
    freef = free.to(dtype)[:, None]
    damp = 1e-6 * torch.clamp(torch.diagonal(Hd, dim1=-2, dim2=-1), min=1.0) + (1.0 - freef)
    Minv = _inv_blocks(Hd + torch.diag_embed(damp))
    damp_c = torch.zeros(Nc, d, dtype=dtype, device=dev).index_add_(0, coarse, damp)
    Dc = Nc * d
    Hc_flat = Hc.view(Nc, Nc, d, d).permute(0, 2, 1, 3).reshape(Dc, Dc)
    Hc_flat = Hc_flat + torch.diag(damp_c.reshape(Dc) + 1e-9)
    # the coarse inverse, by Cholesky once per GN step: each CG iteration then
    # applies it as one matvec (two triangular solves of one vector each
    # iteration cost the card ~40 µs more)
    Lc, _ = torch.linalg.cholesky_ex(Hc_flat)
    Hc_inv = torch.cholesky_solve(torch.eye(Dc, dtype=dtype, device=dev), Lc)

    def matvec(v):  # (N,d)
        t = (J2 @ v[idx][..., None])[..., 0]
        t = t[:E] + t[E:]
        y = torch.zeros_like(v).index_add_(0, idx, (J2T @ torch.cat([t, t])[..., None])[..., 0])
        # the block-diagonal damping (identity on fixed coordinates) lies
        # outside the edge sum
        return torch.addcmul(y, damp, v)

    def precond(v):
        vr = torch.zeros(Nc, d, dtype=dtype, device=dev).index_add_(0, coarse, v * freef)
        uc = (Hc_inv @ vr.reshape(Dc)).view(Nc, d)
        return torch.addcmul((Minv @ v[..., None])[..., 0], uc[coarse], freef)

    return -b * freef, matvec, precond, cost


def _two_level_pcg(r, Ji, Jj, ei, ej, free, N: int, cg_iters: int, G: int):
    """One pose-graph GN step's update (N, d) and cost."""
    rhs, matvec, precond, cost = _pg_system(r, Ji, Jj, ei, ej, free, N, G)
    return _pcg(matvec, rhs, precond, cg_iters), cost


def _pg4_eval(nd: PoseGraphNodes, edges: PoseGraphEdges, free):
    """Whitened 4-DoF edge residuals (E,4) and Jacobians (E,4,4) per end,
    Huber on loop edges, the columns of fixed nodes zeroed."""
    ei, ej = edges.i.long(), edges.j.long()
    r, J = _edge_jacobian_4dof(nd, ei, ej, edges.t_ij, edges.yaw_ij)
    wt = torch.where(edges.valid, edges.weight * _huber_sqrt_weight(r, edges.is_loop),
                     torch.zeros_like(edges.weight))
    fr = free.to(r.dtype)
    Ji = J[..., :4] * (wt * fr[ei])[:, None, None]
    Jj = J[..., 4:] * (wt * fr[ej])[:, None, None]
    return wt[:, None] * r, Ji, Jj


def _free(valid, fix_before):
    return valid & (torch.arange(valid.shape[0], device=valid.device) >= fix_before)


def _pg4_gn_step_pcg(nd: PoseGraphNodes, edges: PoseGraphEdges, fix_before, N: int,
                     cg_iters: int, coarse_group: int = 16):
    """One 4-DoF GN step by two-level PCG: block-Jacobi alone moves a loop
    correction one edge-hop per CG iteration along a chain; the coarse
    level carries the long-wavelength drift in one application."""
    free = _free(nd.valid, fix_before)
    r, Ji, Jj = _pg4_eval(nd, edges, free)
    return _two_level_pcg(r, Ji, Jj, edges.i.long(), edges.j.long(), free, N, cg_iters,
                          coarse_group)


@_float32_matmuls()
def optimize_4dof_pcg(nodes: PoseGraphNodes, edges: PoseGraphEdges, fix_before,
                      iters: int = 10, cg_iters: int = 64,
                      coarse_group: int = 16) -> PoseGraphNodes:
    """Matrix-free 4-DoF pose-graph GN, the semantics of ``optimize_4dof``
    (Huber loop edges, nodes below ``fix_before`` fixed) with nothing
    scaling as N²."""
    N = nodes.p.shape[0]
    nd = nodes
    for _ in range(iters):
        dx, _ = _pg4_gn_step_pcg(nd, edges, fix_before, N, cg_iters, coarse_group)
        nd = nd._replace(p=nd.p + dx[:, :3], yaw=nd.yaw + dx[:, 3])
    return nd


def _pg6_eval(nd: PoseGraph6Nodes, edges: PoseGraph6Edges, free):
    """Whitened SE(3) edge residuals (E,6) and Jacobians (E,6,6) per end,
    Huber on loop edges, the columns of fixed nodes zeroed."""
    ei, ej = edges.i.long(), edges.j.long()
    r, J = _edge_jacobian_6dof(
        (nd.r[ei], nd.q[ei], nd.r[ej], nd.q[ej], edges.t_ij, edges.q_ij, edges.sqrt_info))
    il = edges.is_loop if edges.is_loop is not None else torch.zeros_like(edges.valid)
    w = torch.where(edges.valid, _huber_sqrt_weight(r, il), torch.zeros_like(r[:, 0]))
    fr = free.to(r.dtype)
    return (w[:, None] * r, J[..., :6] * (w * fr[ei])[:, None, None],
            J[..., 6:] * (w * fr[ej])[:, None, None])


def _pg6_gn_step_pcg(nd: PoseGraph6Nodes, edges: PoseGraph6Edges, fix_before, N: int,
                     cg_iters: int, coarse_group: int = 16):
    """One SE(3) GN step by the 4-DoF step's two-level PCG on 6x6 blocks."""
    free = _free(nd.valid, fix_before)
    r, Ji, Jj = _pg6_eval(nd, edges, free)
    return _two_level_pcg(r, Ji, Jj, edges.i.long(), edges.j.long(), free, N, cg_iters,
                          coarse_group)


@_float32_matmuls()
def optimize_6dof_pcg(nodes: PoseGraph6Nodes, edges: PoseGraph6Edges, fix_before,
                      iters: int = 5, cg_iters: int = 96,
                      coarse_group: int = 16) -> PoseGraph6Nodes:
    """Matrix-free SE(3) pose-graph GN, the semantics of ``optimize_6dof``
    with nothing scaling as N²."""
    N = nodes.r.shape[0]
    nd = nodes
    for _ in range(iters):
        dx, _ = _pg6_gn_step_pcg(nd, edges, fix_before, N, cg_iters, coarse_group)
        nd = PoseGraph6Nodes(r=nd.r + dx[:, :3],
                             q=quat.normalize(quat.multiply(quat.exp(dx[:, 3:6]), nd.q)),
                             valid=nd.valid)
    return nd
