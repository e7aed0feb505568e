"""The VIO engine's device programs, lifted out of the engine.

Counterparts of the device programs of the JAX package's
``pipeline/vio.py``, as pure functions of tensors with the same inputs and
outputs (the engine in ``pipeline/vio.py`` keeps its bookkeeping on the host
and calls these):

- ``frontend_batch`` (``_frontend_batch``): preprocess + detect + describe
  every camera's image.
- ``preint_prop`` and ``gravity_dirs``: IMU preintegration + propagation of
  the newest state, and the per-camera gravity direction for the descriptor.
- ``gate_match_all`` (``_gate_match_all``): projection-gated map matching.
  Every keypoint of every camera is gated against the landmark table with
  the χ²(2) 99.9% ellipse of the projected landmark covariance, then
  matched by Hamming distance (the fused B2 matcher kernel on CUDA).
- ``match_stage`` (``_match_stage``): ``gate_match_all`` + 3D-2D RANSAC on
  camera 0 + reprojection acceptance through the fitted pose.
- ``stereo_match_tri`` and ``temporal_match_tri``
  (``_make_stereo_match_tri``, ``_make_temporal_match_tri``): stereo and
  temporal matching (the fused B2 matcher on CUDA) + triangulation + gates +
  map dedup.
- ``opt_program`` (``_make_opt_program``): optimize (the B1 kernel solves
  each LM step on CUDA) → marginalize the host-chosen victim slot → the
  octave-normalized reprojection error of every observation for outlier
  pruning.

The RANSAC stages take a ``draw(valid, num_hypotheses, sample_size)``
callable that returns the (H, s) sample indices on the device (the JAX
programs take a PRNG key). ``BackendStep`` chains map matching and the opt
program for one frame.
"""
from __future__ import annotations

import math
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
from ..frontend import (
    absolute_pose_ransac,
    point_from_homogeneous,
    relative_pose_ransac,
    rotation_only_ransac,
    triangulate_fast,
    triangulation_covariance,
)
from ..imu import ImuParameters, preintegrate, propagate, sqrt_information
from ..kinematics import Transformation, compose, inverse, quaternion as quat, transform_point
from ..ops import descriptor as desc_ops, detection, image as image_ops
from ..ops.hamming import match_descriptors
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
    matcher=match_descriptors,
):
    """Projection gating with projected covariance: the search region
    around each predicted landmark projection is the χ²(2) 99.9% ellipse of
    J (Σ_lm + pos_var·I) Jᵀ + σ_kp² I, with a 3 px floor and a 150 px cap,
    then mutual best-match Hamming matching (threshold 60) by ``matcher``
    (the fused B2 kernel on CUDA by default).

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
    res = matcher(desc, lm_desc, kp_valid, lm_valid, mask=mask, max_distance=60, mutual=True)
    return res.valid, res.idx_b, back_project(cam, uv)


def frontend_batch(
    imgs: torch.Tensor,  # (C,H,W) raw images, uint8 (or float in [0, 1])
    g_C: torch.Tensor,  # (C,3) gravity direction per camera frame
    threshold,  # detector response threshold
    *,
    max_keypoints: int,
    octaves: int,
    histogram_method: str,
    clahe_clip_limit: float,
    resize_factor: float = 1.0,
    clahe_tiles: int = 4,
):
    """Preprocess + detect + describe for all cameras (float32). Returns
    (uv (C,K,2), desc (C,K,8) int32, valid, score, octave, cam0's processed
    image as uint8)."""
    im = image_ops.preprocess(
        imgs, resize_factor=resize_factor, histogram_method=histogram_method,
        clahe_clip_limit=clahe_clip_limit, clahe_tiles=clahe_tiles,
    )
    thr = torch.full((), threshold, dtype=im.dtype, device=im.device)
    kp = detection.detect(im, max_keypoints=max_keypoints, octaves=octaves, threshold=thr)
    g = g_C.to(im.dtype)
    d = torch.stack([
        desc_ops.describe(im[c], kp.uv[c], desc_ops.gravity_angles(kp.uv[c], g[c]), kp.valid[c],
                          octave=kp.octave[c], max_octave=octaves)
        for c in range(im.shape[0])
    ])
    im8 = torch.clamp(im[0] * 255.0, 0.0, 255.0).to(torch.uint8)
    return kp.uv, d, kp.valid, kp.score, kp.octave, im8


def preint_prop(ts, gy, ac, mask, t0, t1, r, q, sb, imu_p: ImuParameters):
    """Preintegrate the IMU slice over [t0, t1] at the state's bias and
    propagate the state: (preintegral, predicted T_WS, predicted speed/bias,
    the factor's square-root information)."""
    pre = preintegrate(ts, gy, ac, mask, t0, t1, sb[3:9], imu_p)
    T_pred, sb_pred = propagate(Transformation(r=r, q=q), sb, pre, imu_p)
    return pre, T_pred, sb_pred, sqrt_information(pre)


def gravity_dirs(q_WS: torch.Tensor, ext_q: torch.Tensor) -> torch.Tensor:
    """(C,3) world down (−z) in each camera frame, q_WC = q_WS ⊗ q_SC."""
    q_WC = quat.multiply(q_WS, ext_q)
    down = torch.tensor([0.0, 0.0, -1.0], dtype=q_WS.dtype, device=q_WS.device)
    return quat.rotate(quat.conjugate(q_WC), down)


def match_stage(
    rig: RigParams,
    focal0: float,  # camera 0's focal length [px] (the RANSAC's angular threshold)
    uv, desc, kp_valid, free,  # (C,K,...) stacked over cameras
    hp_W, lm_valid, lm_desc, lm_cov,
    T_WS_r, T_WS_q, ext_r, ext_q, kp_sigma, pos_var,
    draw,
    matcher=match_descriptors,
):
    """The whole data-association stage: projection-gated matching, 3D-2D
    RANSAC over camera 0's candidates, and reprojection acceptance of every
    candidate through the fitted pose. Returns (accept (C,K), landmark slot
    (C,K), candidate count, RANSAC success, fitted T_WS r and q)."""
    mv, midx, rays = gate_match_all(
        rig, uv, desc, kp_valid, hp_W, lm_valid, lm_desc, lm_cov,
        T_WS_r, T_WS_q, ext_r, ext_q, kp_sigma, pos_var, matcher=matcher,
    )
    cand = mv & free  # (C,K) gated, unassociated keypoints
    n_cand = cand.sum()
    p_cand = hp_W[midx.long(), :3]  # (C,K,3)

    # cam0 RANSAC for a pose model (prior-seeded GP3P analog)
    T_ext0 = Transformation(r=ext_r[0], q=ext_q[0])
    T_WC0 = compose(Transformation(r=T_WS_r, q=T_WS_q), T_ext0)
    n0 = cand[0].sum()
    rr = absolute_pose_ransac(
        draw(cand[0], 50, 3), p_cand[0], rays[0], cand[0], T_WC0,
        focal_px=focal0, threshold_px=4.0, min_inliers=torch.clamp(n0 // 3, min=8),
    )
    success = rr.success & (n0 >= 6)
    T_fit = compose(rr.T, inverse(T_ext0))
    fit_r = torch.where(success, T_fit.r, T_WS_r)
    fit_q = torch.where(success, T_fit.q, T_WS_q)
    accept_px = torch.where(success, 4.0, 8.0).to(hp_W.dtype)

    # reprojection acceptance of every candidate through the fitted pose
    T_WC = compose(Transformation(r=fit_r, q=fit_q), Transformation(r=ext_r, q=ext_q))  # (C,...)
    T_CW = inverse(T_WC)
    p_C = transform_point(Transformation(r=T_CW.r[:, None, :], q=T_CW.q[:, None, :]), p_cand)
    uv_hat, ok = project(_rig_cameras(rig), p_C)
    err = torch.linalg.norm(uv_hat - uv, dim=-1)
    accept = cand & ok & (err < accept_px)
    return accept, midx, n_cand, success, fit_r, fit_q


def _rays_and_sigmas(cam_a: PinholeCamera, cam_b: PinholeCamera, ray_sigma_base, uvA, uvB_m,
                     octA, octB_m):
    dtype = uvA.dtype
    sigA = ray_sigma_base * torch.exp2(octA.to(dtype)) / cam_a.fu
    sigB = ray_sigma_base * torch.exp2(octB_m.to(dtype)) / cam_b.fu
    return back_project(cam_a, uvA), back_project(cam_b, uvB_m), sigA, sigB


def _dedup(pts, hp_W, lm_valid, depth):
    """True where a point is farther than max(0.1, 0.04·depth) from every
    live landmark (never spawn a duplicate)."""
    d = torch.linalg.norm(pts[:, None, :] - hp_W[None, :, :3], dim=-1)
    d = torch.where(lm_valid[None, :], d, torch.full_like(d, math.inf))
    return torch.amin(d, dim=1) > torch.clamp(0.04 * depth, min=0.1)


def stereo_match_tri(
    cam_a: PinholeCamera, cam_b: PinholeCamera, ray_sigma_base: float, pose_var: float,
    descA, descB, valA, valB, uvA, uvB, octA, octB,
    T_WS_r, T_WS_q, eAr, eAq, eBr, eBq, hp_W, lm_valid,
    matcher=match_descriptors,
):
    """Stereo intra-frame association + probabilistic triangulation:
    descriptor matching, per-octave ray sigmas, world-frame midpoint
    triangulation with covariance, depth sanity (0.1-60 m) and dedup against
    the map. Returns (matched index in B (K,), points (K,3), good (K,),
    covariances (K,3,3))."""
    T_WS = Transformation(r=T_WS_r, q=T_WS_q)
    TA = compose(T_WS, Transformation(r=eAr, q=eAq))
    TB = compose(T_WS, Transformation(r=eBr, q=eBq))
    res = matcher(descA, descB, valA, valB, max_distance=60, mutual=True)
    ib = res.idx_b.long()
    rays_a, rays_b, sigA, sigB = _rays_and_sigmas(cam_a, cam_b, ray_sigma_base, uvA, uvB[ib],
                                                  octA, octB[ib])
    eA = quat.rotate(TA.q, rays_a)
    eB = quat.rotate(TB.q, rays_b)
    pA = TA.r.expand(eA.shape)
    pB = TB.r.expand(eB.shape)
    tri = triangulate_fast(pA, eA, pB, eB, torch.sqrt(sigA * sigA + sigB * sigB))
    pts = point_from_homogeneous(tri.hp)
    cov = triangulation_covariance(pts, pA, pB, sigA, sigB,
                                   torch.full_like(sigA, pose_var))
    depth = torch.linalg.norm(pts - TA.r, dim=1)
    good = res.valid & tri.valid & ~tri.parallel & (depth > 0.1) & (depth < 60.0)
    good = good & _dedup(pts, hp_W, lm_valid, depth)
    return res.idx_b, pts, good, cov


def flow_mask(uvC, uvP, diag: float):
    """(Kc, Kp) pairs whose keypoints lie within a quarter of the image
    diagonal of each other: the temporal matcher's optical-flow gate."""
    d2_uv = torch.sum((uvC[:, None, :] - uvP[None, :, :]) ** 2, dim=-1)
    return d2_uv < (0.25 * diag) ** 2


def temporal_match_tri(
    cam: PinholeCamera, ray_sigma_base: float, diag: float, focal: float, draw_rot, draw_rel,
    descC, descP, valC, valP, uvC, uvP, octC, octP,
    rA, qA, rB, qB, pose_var, hp_W, lm_valid,
    matcher=match_descriptors,
):
    """Temporal 2D-2D bootstrap for one camera (current frame A against the
    last keyframe B): optical-flow-gated matching, probabilistic
    triangulation, rotation-only vs relative-pose RANSAC disambiguation,
    depth/epipolar/parallax gates, and map dedup. ``draw_rot`` and
    ``draw_rel`` draw the two RANSACs' samples. Returns (matched index in B,
    points, good, covariances, rotation-only decision ())."""
    dtype = uvC.dtype
    res = matcher(descC, descP, valC, valP, mask=flow_mask(uvC, uvP, diag), max_distance=60,
                  mutual=True)
    ib = res.idx_b.long()
    ok = res.valid
    npair = ok.sum()
    rays_a, rays_b, sigA, sigB = _rays_and_sigmas(cam, cam, ray_sigma_base, uvC, uvP[ib],
                                                  octC, octP[ib])
    eA = quat.rotate(qA, rays_a)
    eB = quat.rotate(qB, rays_b)
    pA = rA.expand(eA.shape)
    pB = rB.expand(eB.shape)
    tri = triangulate_fast(pA, eA, pB, eB, torch.sqrt(sigA * sigA + sigB * sigB))
    pts = point_from_homogeneous(tri.hp)
    cov = triangulation_covariance(pts, pA, pB, sigA, sigB, pose_var.expand(sigA.shape))
    good = ok & tri.valid & ~tri.parallel

    # 2D-2D RANSAC disambiguation: a translation-dominated pass uses the
    # relative-pose inlier set as the mismatch filter, a rotation-dominated
    # one defers to the parallax gate below
    bA = quat.rotate(quat.conjugate(qA), eA)
    bB = quat.rotate(quat.conjugate(qB), eB)
    T_AB = compose(inverse(Transformation(r=rA, q=qA)), Transformation(r=rB, q=qB))
    rot_rr = rotation_only_ransac(draw_rot(ok, 32, 2), bA, bB, ok, focal_px=focal)
    rel_rr = relative_pose_ransac(draw_rel(ok, 32, 5), bA, bB, ok, T_AB, focal_px=focal)
    npf = torch.clamp(npair, min=1).to(dtype)
    rot_ratio = rot_rr.num_inliers.to(dtype) / npf
    rel_ratio = rel_rr.num_inliers.to(dtype) / npf
    rot_decision = (rot_ratio > rel_ratio) | (rot_ratio > 0.8)
    enough = npair >= 10
    apply_rel = enough & ~rot_decision & rel_rr.success
    good = good & torch.where(apply_rel, rel_rr.inliers, torch.ones_like(good))

    depth = torch.linalg.norm(pts - rA, dim=1)
    good = good & (depth > 0.1) & (depth < 60.0)
    # epipolar-consistency gate (coplanarity with the baseline)
    t_ab = rB - rA
    t_hat = t_ab / torch.clamp(torch.linalg.norm(t_ab), min=1e-12)
    n_ep = quat.cross(t_hat.expand(eB.shape), eB)
    nn_ = torch.linalg.norm(n_ep, dim=1)
    n_ep = n_ep / torch.clamp(nn_, min=1e-12)[:, None]
    good = good & (nn_ > 1e-6) & (torch.abs(torch.sum(eA * n_ep, dim=1)) < math.sin(math.radians(0.7)))
    # parallax gate (≈1° minimum triangulation angle)
    good = good & (torch.sum(eA * eB, dim=-1) < math.cos(math.radians(1.0)))
    good = good & _dedup(pts, hp_W, lm_valid, depth)
    return res.idx_b, pts, good, cov, enough & rot_decision


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
    ``matcher`` pick the dense solver and the descriptor matcher: the
    dispatching wrappers by default (CUDA kernels for CUDA tensors), or the
    plain versions."""

    def __init__(self, rig: RigParams, imu_p: ImuParameters, cfg: WindowConfig,
                 solve=solve_spd, matcher=match_descriptors):
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
        self.matcher = matcher

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
            frame.sigma, frame.pos_var, matcher=self.matcher,
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
