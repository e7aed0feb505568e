"""The VIO backend's per-frame device programs, lifted out of the engine.

Counterparts of two closures in ``VioEngine.__init__`` of the JAX package's
``pipeline/vio.py``, as pure functions of tensors with the same inputs
and outputs:

- ``gate_match_all`` (``_gate_match_all``): projection-gated map matching.
  Every keypoint of every camera is gated against the landmark table with
  the χ²(2) 99.9% ellipse of the projected landmark covariance, then
  matched by Hamming distance (the B2 kernel on CUDA).
- ``opt_program`` (``_make_opt_program``): optimize (the B1 kernel solves
  each LM step on CUDA) → marginalize the host-chosen victim slot → the
  octave-normalized reprojection error of every observation for outlier
  pruning.

``BackendStep`` chains the two for one frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..cameras import PinholeCamera, back_project, project, project_jacobian
from ..estimator import (
    Factors,
    RigParams,
    WindowConfig,
    WindowState,
    eval_reprojection,
    marginalize_slot,
    optimize,
)
from ..imu import ImuParameters
from ..kinematics import Transformation, compose, inverse, quaternion as quat, transform_point
from ..ops.hamming import hamming_matrix, match_descriptors
from ..ops.solve import solve_spd
from ..problems import Frame

# per-keypoint sqrt information at octave 0 (sigma = 1 px)
KP_SQRT_INFO = 1.0
# χ²(2) 99.9% quantile: the gating ellipse
CHI2_2_999 = 13.816


def reproj_px_err(w: WindowState, f: Factors, rig: RigParams, cfg: WindowConfig):
    """(valid (O,), octave-normalized pixel error (O,)) of every
    observation: the robust-weighted residual divided by the base sqrt
    information and the IRLS weight."""
    ev = eval_reprojection(w, f, rig, cfg)
    wt = torch.sqrt(torch.clamp(ev.weight, min=1e-9))
    err = torch.linalg.norm(ev.res, dim=-1) / (KP_SQRT_INFO * wt)
    return ev.valid, err


def _rig_cameras(rig: RigParams) -> PinholeCamera:
    """All rig cameras as one camera with (C, 1) intrinsics, to broadcast
    against (C, N) points."""
    return PinholeCamera(
        fu=rig.fu[:, None], fv=rig.fv[:, None], cu=rig.cu[:, None], cv=rig.cv[:, None],
        dist_params=rig.dist[:, None, :], width=rig.width, height=rig.height,
        model=rig.model,
    )


def gate_match_all(
    rig: RigParams,
    uv, desc, kp_valid,  # (C,K,...) stacked over cameras
    hp_W, lm_valid, lm_desc,
    lm_cov,  # (L,3,3) world-frame landmark position covariance
    T_WS_r, T_WS_q, ext_r, ext_q,
    kp_sigma,  # (C,K) per-keypoint pixel std
    pos_var,  # () pose translation variance
    hamming=hamming_matrix,
):
    """Projection gating with projected covariance: the search region
    around each predicted landmark projection is the χ²(2) 99.9% ellipse of
    J (Σ_lm + pos_var·I) Jᵀ + σ_kp² I, with a 3 px floor and a 150 px cap,
    then mutual best-match Hamming matching (threshold 60).

    Returns (match valid (C,K), landmark slot (C,K) int32 or -1, unit
    bearing of every keypoint (C,K,3))."""
    dtype = hp_W.dtype
    eye3 = torch.eye(3, dtype=dtype, device=hp_W.device)
    T_WC = compose(Transformation(r=T_WS_r, q=T_WS_q), Transformation(r=ext_r, q=ext_q))
    T_CW = inverse(T_WC)  # (C,...)
    p_C = transform_point(
        Transformation(r=T_CW.r[:, None, :], q=T_CW.q[:, None, :]), hp_W[None, :, :3]
    )  # (C,L,3)
    cam = _rig_cameras(rig)
    uv_pred, proj_ok = project(cam, p_C)
    proj_ok = proj_ok & lm_valid
    J = project_jacobian(cam, p_C)  # (C,L,2,3)
    C_CW = quat.to_rotation_matrix(T_CW.q)[:, None]  # (C,1,3,3)
    Sig_C = C_CW @ (lm_cov + pos_var * eye3) @ C_CW.transpose(-1, -2)  # (C,L,3,3)
    S = J @ Sig_C @ J.transpose(-1, -2)  # (C,L,2,2) projected covariance
    r = uv[:, :, None, :] - uv_pred[:, None, :, :]  # (C,K,L,2)
    s2 = (kp_sigma * kp_sigma)[:, :, None]  # (C,K,1)
    a = S[:, None, :, 0, 0] + s2
    bq = S[:, None, :, 0, 1]
    cq = S[:, None, :, 1, 1] + s2
    det = torch.clamp(a * cq - bq * bq, min=1e-12)
    r0, r1 = r[..., 0], r[..., 1]
    mahal = (cq * r0**2 - 2.0 * bq * r0 * r1 + a * r1**2) / det
    d2 = torch.sum(r * r, dim=-1)
    mask = (
        ((mahal < CHI2_2_999) | (d2 < 9.0))
        & (d2 < 150.0**2)
        & proj_ok[:, None, :]
    )
    res = match_descriptors(
        desc, lm_desc, kp_valid, lm_valid, mask=mask, max_distance=60,
        mutual=True, hamming=hamming,
    )
    return res.valid, res.idx_b, back_project(cam, uv)


class OptOutput(NamedTuple):
    result: object  # estimator.OptimizeResult (window before marginalization)
    window: WindowState  # after marginalization
    factors: Factors
    prune_valid: torch.Tensor  # (O,)
    prune_err: torch.Tensor  # (O,)


def optimize_marginalize_prune(w, f, n_it, victim, rig, imu_p, cfg, solve=solve_spd) -> OptOutput:
    """optimize → marginalize ``victim`` at the post-optimize estimates →
    reprojection error for pruning (the fused engine program)."""
    res = optimize(w, f, rig, imu_p, cfg, n_iters=n_it, solve=solve)
    w2, f2 = marginalize_slot(res.window, f, victim, rig, imu_p, cfg)
    pv, pe = reproj_px_err(w2, f2, rig, cfg)
    return OptOutput(res, w2, f2, pv, pe)


def opt_program(rig: RigParams, imu_p: ImuParameters, cfg: WindowConfig,
                with_marg: bool, solve=solve_spd):
    """The engine's optimize(+marginalize)+prune program at the LM bound
    ``cfg.max_iterations``. With ``with_marg``: prog(w, f, n_it, victim) →
    (window, factors, cost, iterations, lm_cov, prune_valid, prune_err);
    without: prog(w, f, n_it) → (window, cost, iterations, lm_cov,
    prune_valid, prune_err)."""
    if with_marg:
        def prog(w, f, n_it, victim):
            o = optimize_marginalize_prune(w, f, n_it, victim, rig, imu_p, cfg, solve)
            r = o.result
            return (o.window, o.factors, r.cost, r.iterations, r.lm_cov,
                    o.prune_valid, o.prune_err)
    else:
        def prog(w, f, n_it):
            r = optimize(w, f, rig, imu_p, cfg, n_iters=n_it, solve=solve)
            pv, pe = reproj_px_err(r.window, f, rig, cfg)
            return (r.window, r.cost, r.iterations, r.lm_cov, pv, pe)
    return prog


class StepOutput(NamedTuple):
    match_valid: torch.Tensor  # (C,K) bool
    match_idx: torch.Tensor  # (C,K) int32 landmark slot or -1
    rays: torch.Tensor  # (C,K,3) keypoint bearings
    window: WindowState  # after optimize + marginalize
    factors: Factors
    cost0: torch.Tensor  # () cost before the LM loop
    cost: torch.Tensor  # () cost after the LM loop
    iterations: torch.Tensor  # () accepted LM steps
    lm_cov: torch.Tensor  # (L,3,3)
    prune_valid: torch.Tensor  # (O,)
    prune_err: torch.Tensor  # (O,)


class BackendStep(nn.Module):
    """The per-frame backend: projection-gated map matching of the frame,
    then optimize + marginalize ``victim`` + prune errors.

    The rig's intrinsics and extrinsics and the IMU model's float
    parameters are buffers (they move with ``.to()``; the IMU ones start in
    float64 and so keep their values exactly until cast). ``solve`` and
    ``hamming`` pick the dense solver and the distance-matrix function: the
    dispatching wrappers by default (CUDA kernels for CUDA tensors), or the
    plain versions."""

    def __init__(self, rig: RigParams, imu_p: ImuParameters, cfg: WindowConfig,
                 solve=solve_spd, hamming=hamming_matrix):
        super().__init__()
        for name in ("T_SC_r", "T_SC_q", "fu", "fv", "cu", "cv", "dist"):
            self.register_buffer(name, getattr(rig, name).clone())
        self.width, self.height, self.model = rig.width, rig.height, rig.model
        self._imu_fields = {}  # the non-float IMU fields (the nominal rate)
        for name, value in imu_p._asdict().items():
            if isinstance(value, float):
                self.register_buffer("imu_" + name, torch.tensor(value, dtype=torch.float64))
            else:
                self._imu_fields[name] = value
        self.cfg = cfg
        self.solve = solve
        self.hamming = hamming

    @property
    def imu_p(self) -> ImuParameters:
        return ImuParameters(**{
            name: self._imu_fields[name] if name in self._imu_fields
            else getattr(self, "imu_" + name)
            for name in ImuParameters._fields
        })

    @property
    def rig(self) -> RigParams:
        return RigParams(
            T_SC_r=self.T_SC_r, T_SC_q=self.T_SC_q, fu=self.fu, fv=self.fv,
            cu=self.cu, cv=self.cv, dist=self.dist, width=self.width,
            height=self.height, model=self.model,
        )

    def forward(self, window: WindowState, factors: Factors, frame: Frame,
                n_iters, victim) -> StepOutput:
        rig = self.rig
        mv, midx, rays = gate_match_all(
            rig, frame.uv, frame.desc, frame.valid,
            window.hp_W, window.lm_valid, frame.lm_desc, frame.lm_cov,
            frame.T_WS_r, frame.T_WS_q, window.ext_r, window.ext_q,
            frame.sigma, frame.pos_var, hamming=self.hamming,
        )
        o = optimize_marginalize_prune(
            window, factors, n_iters, victim, rig, self.imu_p, self.cfg, self.solve
        )
        r = o.result
        return StepOutput(
            match_valid=mv, match_idx=midx, rays=rays, window=o.window,
            factors=o.factors, cost0=r.cost0, cost=r.cost, iterations=r.iterations,
            lm_cov=r.lm_cov, prune_valid=o.prune_valid, prune_err=o.prune_err,
        )
