"""Pose-graph optimization: 4-DoF (yaw + position) and 6-DoF Gauss-Newton.

Counterpart of the JAX package's ``loopclosure/posegraph.py``: fixed-capacity
node and edge tables with validity masks, per-edge residuals and Jacobians
evaluated for all edges at once, normal equations scatter-added into one
flat (dN, dN) matrix with ``index_add_``, and a Jacobi-equilibrated dense
Cholesky solve (``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``; the
JAX package solves it with ``cho_solve`` outside any Pallas kernel, so the
library call is its counterpart). The GN loops are Python loops with no
host synchronisation.

Nodes below ``fix_before`` (and invalid ones) are held fixed; loop edges
carry a Huber(0.1) weight (IRLS on the whitened residual norm). The 4-DoF
Jacobian is analytic; the 6-DoF one is forward mode (``torch.func.jvp``
of the residuals of all edges, one tangent per perturbation coordinate), as
the JAX package takes it by ``jax.jacfwd``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kinematics import quaternion as quat


class PoseGraphNodes(NamedTuple):
    p: torch.Tensor  # (N,3) position
    yaw: torch.Tensor  # (N,)
    pitch: torch.Tensor  # (N,) fixed (gravity-observable from VIO)
    roll: torch.Tensor  # (N,) fixed
    valid: torch.Tensor  # (N,)


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor  # (E,) int32 from-node
    j: torch.Tensor  # (E,) int32 to-node
    t_ij: torch.Tensor  # (E,3) p_j - p_i expressed in node i's frame
    yaw_ij: torch.Tensor  # (E,) relative yaw [rad]
    weight: torch.Tensor  # (E,) scalar information weight
    is_loop: torch.Tensor  # (E,) bool (loop edges get Huber)
    valid: torch.Tensor  # (E,)


def ypr_to_matrix(yaw, pitch, roll) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll), batched: (...,) angles → (..., 3, 3)."""
    yaw, pitch, roll = torch.broadcast_tensors(*(torch.as_tensor(a) for a in (yaw, pitch, roll)))
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    rows = (
        (cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr),
        (sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr),
        (-sp, cp * sr, cp * cr),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matrix_to_ypr(R: torch.Tensor):
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(-R[..., 2, 0], torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll


def normalize_angle(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


# numpy twins for the host bookkeeping path (per-keyframe logic emits no
# device work)
def ypr_to_matrix_np(yaw, pitch, roll):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def matrix_to_ypr_np(R):
    R = np.asarray(R)
    yaw = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = np.arctan2(-R[..., 2, 0], np.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    roll = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll


def normalize_angle_np(a):
    return np.arctan2(np.sin(a), np.cos(a))


YAW_WEIGHT = 0.3  # relative yaw scaling of the 4-DoF residual (FourDOFWeightError)
HUBER_DELTA = 0.1


def _edge_residual(nodes: PoseGraphNodes, e_i, e_j, t_ij, yaw_ij, delta=None):
    """4-DoF residuals (E, 4) of edges (e_i, e_j) given per-node updates
    delta (N, 4) = [dp, dyaw] (None: zero)."""
    p, yaw = nodes.p, nodes.yaw
    if delta is not None:
        p, yaw = p + delta[:, :3], yaw + delta[:, 3]
    ei, ej = e_i.long(), e_j.long()
    R_i = ypr_to_matrix(yaw[ei], nodes.pitch[ei], nodes.roll[ei])
    r_t = (R_i.transpose(-1, -2) @ (p[ej] - p[ei])[..., None])[..., 0] - t_ij
    r_y = normalize_angle(yaw[ej] - yaw[ei] - yaw_ij)
    return torch.cat([r_t, r_y[:, None] * YAW_WEIGHT], dim=-1)


def _huber_sqrt_weight(r: torch.Tensor, is_loop: torch.Tensor) -> torch.Tensor:
    """IRLS square-root Huber weight per edge on the whitened residual norm
    (loop edges only)."""
    n = torch.linalg.norm(r, dim=-1)
    hub = torch.sqrt(HUBER_DELTA / torch.clamp(n, min=1e-12))
    return torch.where(is_loop & (n > HUBER_DELTA), hub, torch.ones_like(n))


def _solve_normal_equations(J: torch.Tensor, r: torch.Tensor, ei, ej, N: int, d: int,
                            free: torch.Tensor, damp_before: bool) -> torch.Tensor:
    """Scatter the per-edge blocks of J (E, m, 2d) and r (E, m) into the flat
    (dN, dN) normal equations, hold the nodes outside ``free`` fixed, damp
    and Jacobi-equilibrate, and solve by Cholesky: the update (N, d)."""
    dtype, dev = r.dtype, r.device
    Ji, Jj = J[..., :d], J[..., d:]
    blocks = (
        (ei, ei, torch.einsum("era,erb->eab", Ji, Ji)),
        (ej, ej, torch.einsum("era,erb->eab", Jj, Jj)),
        (ei, ej, torch.einsum("era,erb->eab", Ji, Jj)),
    )
    ar = torch.arange(d, device=dev)
    D = d * N
    H = torch.zeros(D * D, dtype=dtype, device=dev)
    for a, b, blk in blocks:
        ra = a.long()[:, None] * d + ar
        rb = b.long()[:, None] * d + ar
        H.index_add_(0, (ra[:, :, None] * D + rb[:, None, :]).reshape(-1), blk.reshape(-1))
        if a is ei and b is ej:  # the transposed off-diagonal block
            H.index_add_(0, (rb[:, :, None] * D + ra[:, None, :]).reshape(-1),
                         blk.transpose(-1, -2).reshape(-1))
    H = H.reshape(D, D)
    bf = torch.zeros(D, dtype=dtype, device=dev)
    bf.index_add_(0, (ei.long()[:, None] * d + ar).reshape(-1),
                  torch.einsum("era,er->ea", Ji, r).reshape(-1))
    bf.index_add_(0, (ej.long()[:, None] * d + ar).reshape(-1),
                  torch.einsum("era,er->ea", Jj, r).reshape(-1))
    freed = free.repeat_interleave(d).to(dtype)
    fixed = 1.0 - freed
    if damp_before:  # the 4-DoF order: damp, then cut the fixed rows
        H = H + torch.diag(1e-6 * torch.clamp(torch.diagonal(H), min=1.0) + fixed)
        H = H * freed[:, None] * freed[None, :] + torch.diag(fixed)
    else:  # the 6-DoF order: cut, then damp
        H = H * freed[:, None] * freed[None, :]
        H = H + torch.diag(1e-6 * torch.clamp(torch.diagonal(H), min=1.0) + fixed)
    bf = bf * freed
    # Jacobi-equilibrated Cholesky: keeps a float32 factorization stable when
    # node coordinates are large (|p| ~ 1e2 m squares into the equations)
    s = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-20))
    L, _ = torch.linalg.cholesky_ex(H * (s[:, None] * s[None, :]))
    x = torch.cholesky_solve((s * bf)[:, None], L)[:, 0]
    return -(s * x).reshape(N, d)


def optimize_4dof(nodes: PoseGraphNodes, edges: PoseGraphEdges, fix_before,
                  iters: int = 10) -> PoseGraphNodes:
    """``iters`` GN steps on the 4-DoF graph (position + yaw per node; pitch
    and roll held); nodes below ``fix_before`` (int or 0-d tensor) fixed."""
    N = nodes.p.shape[0]
    dtype, dev = nodes.p.dtype, nodes.p.device
    ei, ej = edges.i.long(), edges.j.long()
    free = nodes.valid & (torch.arange(N, device=dev) >= fix_before)
    E = ei.shape[0]
    z1 = torch.zeros(E, 1, 1, dtype=dtype, device=dev)
    z3 = torch.zeros(E, 1, 3, dtype=dtype, device=dev)
    wy = torch.full((E, 1, 1), YAW_WEIGHT, dtype=dtype, device=dev)
    yaw_row = torch.cat([z3, -wy, z3, wy], dim=-1)  # d r_yaw / d[p_i, yaw_i, p_j, yaw_j]
    nd = nodes
    for _ in range(iters):
        r = _edge_residual(nd, ei, ej, edges.t_ij, edges.yaw_ij)
        Rt = ypr_to_matrix(nd.yaw[ei], nd.pitch[ei], nd.roll[ei]).transpose(-1, -2)
        dp = nd.p[ej] - nd.p[ei]
        # d(R_iᵀ dp)/dyaw_i = R_iᵀ Kzᵀ dp, Kz the yaw generator: Kzᵀ dp = (dp_y, -dp_x, 0)
        kd = torch.stack([dp[:, 1], -dp[:, 0], torch.zeros_like(dp[:, 0])], dim=-1)
        J = torch.cat([torch.cat([-Rt, Rt @ kd[..., None], Rt, z1.expand(E, 3, 1)], dim=-1),
                       yaw_row], dim=1)  # (E, 4, 8) over [p_i, yaw_i, p_j, yaw_j]
        w = torch.where(edges.valid, edges.weight * _huber_sqrt_weight(r, edges.is_loop),
                        torch.zeros_like(edges.weight))
        dx = _solve_normal_equations(w[:, None, None] * J, w[:, None] * r, ei, ej, N, 4, free,
                                     damp_before=True)
        nd = nd._replace(p=nd.p + dx[:, :3], yaw=nd.yaw + dx[:, 3])
    return nd


# ------------------------------------------------------------------ 6-DoF
class PoseGraph6Nodes(NamedTuple):
    r: torch.Tensor  # (N,3)
    q: torch.Tensor  # (N,4)
    valid: torch.Tensor  # (N,)


class PoseGraph6Edges(NamedTuple):
    i: torch.Tensor
    j: torch.Tensor
    t_ij: torch.Tensor  # (E,3) in i frame
    q_ij: torch.Tensor  # (E,4)
    # (E,6,6) sqrt information: sequential edges diag(20,20,20,100,100,57.3),
    # loop edges diag(20,20,20,100,100,100)
    sqrt_info: torch.Tensor
    valid: torch.Tensor
    # loop edges carry a Huber(0.1) robust loss; None = no loop edges
    is_loop: Optional[torch.Tensor] = None


def _edge_residual_6dof(d, r_i, q_i, r_j, q_j, t_ij, q_ij, W):
    """Whitened SE(3) residuals (E, 6) under the perturbations d (E, 12) =
    [dr_i, dα_i, dr_j, dα_j] (q ← normalize(exp(dα) ⊗ q))."""
    ri = r_i + d[:, :3]
    rj = r_j + d[:, 6:9]
    qi = quat.normalize(quat.multiply(quat.exp(d[:, 3:6]), q_i))
    qj = quat.normalize(quat.multiply(quat.exp(d[:, 9:12]), q_j))
    r_t = (quat.to_rotation_matrix(qi).transpose(-1, -2) @ (rj - ri)[..., None])[..., 0] - t_ij
    q_rel = quat.multiply(quat.conjugate(qi), qj)
    r_q = quat.log(quat.multiply(quat.conjugate(q_ij), q_rel))
    return (W @ torch.cat([r_t, r_q], dim=-1)[..., None])[..., 0]


def _edge_jacobian_6dof(args) -> tuple:
    """(r (E, 6), J (E, 6, 12)) at zero perturbation: forward mode, one
    tangent per perturbation coordinate for all edges at once (``vmap`` over
    the 12 tangents of ``jvp``; the edges stay a plain batch dimension)."""
    E = args[0].shape[0]
    zero = torch.zeros(E, 12, dtype=args[0].dtype, device=args[0].device)
    basis = torch.eye(12, dtype=zero.dtype, device=zero.device)[:, None, :].expand(12, E, 12)
    f = lambda d: _edge_residual_6dof(d, *args)  # noqa: E731
    J = torch.func.vmap(lambda t: torch.func.jvp(f, (zero,), (t,))[1])(basis)  # (12, E, 6)
    return f(zero), J.permute(1, 2, 0)


def optimize_6dof(nodes: PoseGraph6Nodes, edges: PoseGraph6Edges, fix_before,
                  iters: int = 5) -> PoseGraph6Nodes:
    """``iters`` GN steps on the full SE(3) graph; nodes below ``fix_before``
    fixed."""
    N = nodes.r.shape[0]
    dtype, dev = nodes.r.dtype, nodes.r.device
    ei, ej = edges.i.long(), edges.j.long()
    E = ei.shape[0]
    il = edges.is_loop if edges.is_loop is not None else torch.zeros(E, dtype=torch.bool, device=dev)
    free = nodes.valid & (torch.arange(N, device=dev) >= fix_before)
    nd = nodes
    for _ in range(iters):
        r, J = _edge_jacobian_6dof(
            (nd.r[ei], nd.q[ei], nd.r[ej], nd.q[ej], edges.t_ij, edges.q_ij, edges.sqrt_info))
        w = torch.where(edges.valid, _huber_sqrt_weight(r, il), torch.zeros(E, dtype=dtype, device=dev))
        dx = _solve_normal_equations(w[:, None, None] * J, w[:, None] * r, ei, ej, N, 6, free,
                                     damp_before=False)
        nd = PoseGraph6Nodes(
            r=nd.r + dx[:, :3],
            q=quat.normalize(quat.multiply(quat.exp(dx[:, 3:6]), nd.q)),
            valid=nd.valid,
        )
    return nd
