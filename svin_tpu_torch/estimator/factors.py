"""Batched residual + minimal-Jacobian evaluation for every factor type.

Counterpart of the JAX package's ``estimator/factors.py``: reprojection with Cauchy
IRLS, IMU, water depth, sonar range, pose/speed-bias priors, landmark prior
and extrinsics prior, evaluated over the fixed-shape factor tables. The JAX
package vmaps a per-observation function; here the batch dimension is
written out. Residuals are weighted (sqrt-information applied); Jacobians
are in minimal coordinates ordered [δp, δα, δv, δb_g, δb_a] per state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras.pinhole import project, project_jacobian
from ..imu import ImuParameters, error_and_jacobians
from ..kinematics import Transformation, quaternion as quat
from .rig import RigParams
from .window import Factors, WindowConfig, WindowState

# points closer than 0.2 m are treated as invalid (Jacobians zeroed)
MIN_LANDMARK_DEPTH = 0.2


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _mask(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """1.0 where ok else 0.0, in x's dtype."""
    return ok.to(x.dtype)


class ReprojEval(NamedTuple):
    res: torch.Tensor  # (O,2) weighted residual
    J_pose: torch.Tensor  # (O,2,6) weighted d res / d [δp, δα]
    J_lm: torch.Tensor  # (O,2,3) weighted d res / d δl
    J_ext: torch.Tensor  # (O,2,6) weighted d res / d [δp_SC, δα_SC]
    valid: torch.Tensor  # (O,) effective validity (input mask ∧ in-front)
    rho_cost: torch.Tensor  # (O,) robustified cost contribution (0.5·ρ)
    weight: torch.Tensor  # (O,) IRLS robust weight ρ'(s)


def eval_reprojection(
    window: WindowState, factors: Factors, rig: RigParams, cfg: WindowConfig
) -> ReprojEval:
    """Extrinsics T_SC are read from the window; rig supplies intrinsics."""
    f = factors.reproj
    s = f.state_idx.long()
    l = f.lm_idx.long()
    c = f.cam_idx.long()
    r_WS, q_WS = window.r[s], window.q[s]
    r_SC, q_SC = window.ext_r[c], window.ext_q[c]
    p_W = window.hp_W[l, :3]
    # p_C = C_CS (C_SW (p_W - r_WS) - r_SC)
    C_SW = quat.to_rotation_matrix(q_WS).transpose(-1, -2)
    p_S = _mv(C_SW, p_W - r_WS)
    C_CS = quat.to_rotation_matrix(q_SC).transpose(-1, -2)
    p_C = _mv(C_CS, p_S - r_SC)
    cam = rig.camera(c)
    uv_hat, _ = project(cam, p_C)
    in_front = p_C[:, 2] > MIN_LANDMARK_DEPTH
    ok = f.valid & in_front & window.state_valid[s] & window.lm_valid[l]

    Juv = project_jacobian(cam, p_C)  # (O,2,3)
    C_CW = C_CS @ C_SW
    J_pC_dp = -C_CW
    J_pC_da = C_CW @ quat.cross_mx(p_W - r_WS)
    # minimal perturbation of T_SC: d p_C / d δp_SC = -C_CS,
    # d p_C / d δα_SC = C_CS (p_S - r_SC)^
    J_pC_dpe = -C_CS
    J_pC_dae = C_CS @ quat.cross_mx(p_S - r_SC)
    # residual = measured - predicted → J_res = -J_pred
    Jp = -Juv @ torch.cat([J_pC_dp, J_pC_da], dim=-1)  # (O,2,6)
    Je = -Juv @ torch.cat([J_pC_dpe, J_pC_dae], dim=-1)  # (O,2,6)
    Jl = -Juv @ C_CW  # (O,2,3)
    r = f.uv - uv_hat
    # robust (Cauchy) IRLS weight on the squared weighted norm
    w_info = f.sqrt_info
    s2 = (w_info * w_info) * torch.sum(r * r, dim=-1)
    c2 = cfg.cauchy_c * cfg.cauchy_c
    rho_p = 1.0 / (1.0 + s2 / c2)
    rho = c2 * torch.log1p(s2 / c2)
    w_tot = w_info * torch.sqrt(rho_p)
    w_tot = torch.where(ok, w_tot, torch.zeros_like(w_tot))
    return ReprojEval(
        res=w_tot[:, None] * r,
        J_pose=w_tot[:, None, None] * Jp,
        J_lm=w_tot[:, None, None] * Jl,
        J_ext=w_tot[:, None, None] * Je,
        valid=ok,
        rho_cost=torch.where(ok, 0.5 * rho, torch.zeros_like(rho)),
        weight=rho_p,
    )


class ImuEval(NamedTuple):
    res: torch.Tensor  # (S-1,15)
    J0: torch.Tensor  # (S-1,15,15)
    J1: torch.Tensor  # (S-1,15,15)
    valid: torch.Tensor  # (S-1,)


def eval_imu(window: WindowState, factors: Factors, params: ImuParameters) -> ImuEval:
    """IMU links between consecutive slots i → i+1."""
    f = factors.imu
    T0 = Transformation(r=window.r[:-1], q=window.q[:-1])
    T1 = Transformation(r=window.r[1:], q=window.q[1:])
    e, F0, F1 = error_and_jacobians(
        T0, window.speed_bias[:-1], T1, window.speed_bias[1:], f.pre, params
    )
    ok = f.valid & window.state_valid[:-1] & window.state_valid[1:]
    w = _mask(ok, e)
    W = f.sqrt_info
    return ImuEval(
        res=w[:, None] * _mv(W, e),
        J0=w[:, None, None] * (W @ F0),
        J1=w[:, None, None] * (W @ F1),
        valid=ok,
    )


class ScalarEval(NamedTuple):
    res: torch.Tensor  # (S,) weighted scalar residual
    J_p: torch.Tensor  # (S,3) d res / d δp
    valid: torch.Tensor  # (S,)


def eval_depth(window: WindowState, factors: Factors) -> ScalarEval:
    """e = z_WS − (−depth + first_depth), weighted."""
    f = factors.depth
    ok = f.valid & window.state_valid
    w = torch.where(ok, f.sqrt_info, torch.zeros_like(f.sqrt_info))
    e = w * (window.r[:, 2] - (-f.depth + f.first_depth))
    J = torch.zeros_like(window.r)
    J[:, 2] = w
    return ScalarEval(res=e, J_p=J, valid=ok)


def eval_sonar(window: WindowState, factors: Factors) -> ScalarEval:
    """e = range − ‖r_WS − target_W‖ (Jacobian wrt position only)."""
    f = factors.sonar
    ok = f.valid & window.state_valid
    w = torch.where(ok, f.sqrt_info, torch.zeros_like(f.sqrt_info))
    d = window.r - f.target_W
    n = torch.linalg.norm(d, dim=-1)
    n_safe = torch.clamp(n, min=1e-9)
    e = w * (f.range - n)
    J = -w[:, None] * d / n_safe[:, None]
    return ScalarEval(res=e, J_p=J, valid=ok)


class PriorEval(NamedTuple):
    pose_res: torch.Tensor  # (S,6)
    pose_J: torch.Tensor  # (S,6,6)
    pose_valid: torch.Tensor  # (S,)
    sb_res: torch.Tensor  # (S,9)
    sb_J: torch.Tensor  # (S,9,9)
    sb_valid: torch.Tensor  # (S,)


def eval_priors(window: WindowState, factors: Factors) -> PriorEval:
    """Pose / speed-bias Gaussian priors: e_pose = [r − r̄, log(q q̄⁻¹)]."""
    p = factors.priors
    dq = quat.multiply(window.q, quat.conjugate(p.pose_mean_q))
    e_pose = torch.cat([window.r - p.pose_mean_r, quat.log(dq)], dim=-1)
    ok_p = p.pose_valid & window.state_valid
    wp = _mask(ok_p, e_pose)[:, None]
    pose_res = wp * _mv(p.pose_sqrt_info, e_pose)
    pose_J = wp[..., None] * p.pose_sqrt_info

    e_sb = window.speed_bias - p.sb_mean
    ok_s = p.sb_valid & window.state_valid
    ws = _mask(ok_s, e_sb)[:, None]
    sb_res = ws * _mv(p.sb_sqrt_info, e_sb)
    sb_J = ws[..., None] * p.sb_sqrt_info
    return PriorEval(
        pose_res=pose_res, pose_J=pose_J, pose_valid=ok_p,
        sb_res=sb_res, sb_J=sb_J, sb_valid=ok_s,
    )


class LmPriorEval(NamedTuple):
    res: torch.Tensor  # (L,3)
    J: torch.Tensor  # (L,3,3)
    valid: torch.Tensor  # (L,)


def eval_lm_prior(window: WindowState, factors: Factors) -> LmPriorEval:
    """3-dim landmark position prior: e = p_W − p̄, J = sqrt_info."""
    p = factors.lm_prior
    e = window.hp_W[:, :3] - p.mean
    ok = p.valid & window.lm_valid
    w = _mask(ok, e)[:, None]
    return LmPriorEval(res=w * _mv(p.sqrt_info, e), J=w[..., None] * p.sqrt_info, valid=ok)


class ExtPriorEval(NamedTuple):
    res: torch.Tensor  # (C,6)
    J: torch.Tensor  # (C,6,6)
    valid: torch.Tensor  # (C,)


def eval_ext_prior(window: WindowState, factors: Factors) -> ExtPriorEval:
    """Absolute extrinsics prior on each camera's T_SC."""
    p = factors.ext_prior
    dq = quat.multiply(window.ext_q, quat.conjugate(p.mean_q))
    e = torch.cat([window.ext_r - p.mean_r, quat.log(dq)], dim=-1)
    w = _mask(p.valid, e)[:, None]
    return ExtPriorEval(res=w * _mv(p.sqrt_info, e), J=w[..., None] * p.sqrt_info, valid=p.valid)


def marg_delta(window: WindowState, factors: Factors) -> torch.Tensor:
    """χ ⊟ χ_lin over the full minimal state + extrinsics, (Dx,): S·15 state
    coords then C·6 extrinsics coords (the layout of MarginalPrior.H)."""
    m = factors.marg
    dq = quat.multiply(window.q, quat.conjugate(m.lin_q))
    d = torch.cat([window.r - m.lin_r, quat.log(dq), window.speed_bias - m.lin_sb], dim=-1)
    dqe = quat.multiply(window.ext_q, quat.conjugate(m.lin_ext_q))
    de = torch.cat([window.ext_r - m.lin_ext_r, quat.log(dqe)], dim=-1)
    return torch.cat([d.reshape(-1), de.reshape(-1)])
