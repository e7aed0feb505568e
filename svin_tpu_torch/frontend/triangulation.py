"""Two-view triangulation with validity/parallax classification.

Counterpart of the JAX package's ``frontend/triangulation.py``: closed-form
midpoint of the common perpendicular between two rays, parallel-ray
handling, and the two-view landmark covariance, all broadcasting over
leading dims. The 3x3 inverses are the adjugate closed forms of
``ops/linalg3.py`` (no host synchronisation).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.linalg3 import inv3x3


class TriangulationResult(NamedTuple):
    hp: torch.Tensor  # (...,4) homogeneous point in frame A
    valid: torch.Tensor  # (...,) rays (nearly) intersect in front
    parallel: torch.Tensor  # (...,) rays are (nearly) parallel


def triangulate_fast(p1, e1, p2, e2, sigma) -> TriangulationResult:
    """Midpoint triangulation of rays (p1, e1) and (p2, e2) (origins and
    unit directions (..., 3), angular uncertainty sigma (...,)). For parallel
    rays returns a far point along the mean direction with w→0 and flags
    ``parallel``."""
    t12 = p2 - p1
    d = torch.sum(e1 * e2, dim=-1)
    denom = 1.0 - d * d  # |e1 x e2|^2
    parallel = denom < torch.clamp(sigma * sigma, min=1e-12)

    b1 = torch.sum(t12 * e1, dim=-1)
    b2 = torch.sum(t12 * e2, dim=-1)
    denom_safe = torch.where(parallel, torch.ones_like(denom), denom)
    lam1 = (b1 - d * b2) / denom_safe
    lam2 = (d * b1 - b2) / denom_safe
    x1 = p1 + lam1[..., None] * e1
    x2 = p2 + lam2[..., None] * e2
    midpoint = 0.5 * (x1 + x2)

    # parallel fallback: far point along the bisecting direction
    mean_dir = e1 + e2
    far = 0.5 * (p1 + p2) + mean_dir * 1e6
    xyz = torch.where(parallel[..., None], far, midpoint)
    one = torch.ones_like(denom)
    w = torch.where(parallel, one * 1e-6, one)
    hp = torch.cat([xyz * w[..., None], w[..., None]], dim=-1)

    # validity: both depths positive and gap small vs distance
    gap = torch.linalg.norm(x2 - x1, dim=-1)
    dist = torch.linalg.norm(midpoint - p1, dim=-1)
    max_gap = torch.clamp(4.0 * sigma * dist, min=1e-3)
    valid = (lam1 > 0) & (lam2 > 0) & (gap < max_gap)
    valid = torch.where(parallel, torch.sum(e1 * e2, dim=-1) > 0.999, valid)
    return TriangulationResult(hp=hp, valid=valid, parallel=parallel)


def point_from_homogeneous(hp: torch.Tensor) -> torch.Tensor:
    w = hp[..., 3:4]
    return hp[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def triangulation_covariance(p_W, c1, c2, sigma1, sigma2, pose_var) -> torch.Tensor:
    """3×3 landmark covariance from the two-view Gauss-Newton system with a
    relative-pose prior, Schur-marginalizing the second camera's center:

        H_pp = Σ_i P_i / (σ_i² d_i²),  H_pc = −P_2 / (σ_2² d_2²),
        H_cc = P_2 / (σ_2² d_2²) + I / pose_var,
        cov  = (H_pp − H_pc H_cc⁻¹ H_cp)⁻¹

    with P_i = I − e_i e_iᵀ the projector perpendicular to view i's bearing.
    Point and centers (..., 3), sigmas and pose_var (...,)."""
    eye = torch.eye(3, dtype=p_W.dtype, device=p_W.device)
    d1v = p_W - c1
    d2v = p_W - c2
    d1 = torch.linalg.norm(d1v, dim=-1)
    d2 = torch.linalg.norm(d2v, dim=-1)
    e1 = d1v / torch.clamp(d1, min=1e-9)[..., None]
    e2 = d2v / torch.clamp(d2, min=1e-9)[..., None]
    P1 = eye - e1[..., :, None] * e1[..., None, :]
    P2 = eye - e2[..., :, None] * e2[..., None, :]
    w1 = 1.0 / torch.clamp(sigma1 * sigma1 * d1 * d1, min=1e-18)
    w2 = 1.0 / torch.clamp(sigma2 * sigma2 * d2 * d2, min=1e-18)
    Hpp = w1[..., None, None] * P1 + w2[..., None, None] * P2
    Hcc = w2[..., None, None] * P2 + (1.0 / torch.clamp(pose_var, min=1e-12))[..., None, None] * eye
    Hpc = -w2[..., None, None] * P2
    Hcc_inv = inv3x3(Hcc + 1e-12 * eye)
    Hs = Hpp - Hpc @ Hcc_inv @ Hpc.transpose(-1, -2)
    return inv3x3(Hs + 1e-9 * eye)
