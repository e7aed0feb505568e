"""Synthetic window problems for tests and the chip check.

Counterpart of the JAX package's ``problems.py`` (``euroc_like_rig``,
``build_window_problem``), with random draws from an explicit
``numpy.random.Generator`` (the JAX package draws from ``jax.random``, so the
two builders give different noise for the same seed; the parity tests feed
both packages the JAX builder's problem through ``convert``). Beyond the JAX
builder, ``attach_depth_and_sonar`` adds the water-depth and sonar-range
factors the engine attaches from its sensor buffers, and ``make_frame``
synthesises one frame of keypoints for the map matcher.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import sim
from .cameras import NCameraSystem, make_camera, project
from .estimator import WindowConfig, empty_factors, empty_window, rig_params
from .imu import ImuParameters, preintegrate, sqrt_information
from .kinematics import Transformation, compose, from_rq, inverse, transform_point, quaternion as quat

IMU_PARAMS = ImuParameters()


def euroc_like_rig(dtype=torch.float64, device=None) -> NCameraSystem:
    """Two 752x480 radial-tangential cameras, 11 cm stereo baseline."""
    cam = make_camera(
        752, 480, 458.654, 457.296, 367.215, 248.375,
        dist_params=[-0.2834, 0.0739, 0.00019, 1.76e-05], dtype=dtype, device=device,
    )
    rig = NCameraSystem()
    rig.add_camera(from_rq([0.0, 0.0, 0.0], [0, 0, 0, 1], dtype, device), cam)
    rig.add_camera(from_rq([0.11, 0.0, 0.0], [0, 0, 0, 1], dtype, device), cam)
    return rig


def _imu_slice(ts: np.ndarray, t0: float, t1: float) -> slice:
    """Samples whose segments overlap (t0, t1): every other segment leaves
    the preintegral unchanged, so integrating the slice is exact."""
    first = max(int(np.searchsorted(ts, t0, side="right")) - 1, 0)
    last = int(np.searchsorted(ts, t1, side="left")) - 1
    return slice(first, max(last + 2, first + 1))


def build_window_problem(
    rng: np.random.Generator,
    cfg: WindowConfig,
    n_landmarks: int = 64,
    dt_state: float = 0.4,
    pix_noise: float = 0.4,
    lm_perturb: float = 0.05,
    state_perturb: float = 0.02,
    imu_rate: float = 200.0,
    imu_noisy: bool = True,
    dtype=torch.float64,
    device=None,
):
    """Synthetic filled (window, factors, rig_params, truth): S states along
    the analytic trajectory, a landmark box ahead of the middle state,
    every in-image projection observed with pixel noise, IMU factors from a
    simulated (noisy) series, and a gauge prior on the first state."""
    S = cfg.num_states
    kw = dict(dtype=dtype, device=device)
    traj = sim.default_trajectory(**kw)
    rig = euroc_like_rig(**kw)
    rig_p = rig_params(rig, **kw)

    times = torch.arange(S, **kw) * dt_state + 0.3
    T_gt = sim.pose(traj, times)  # batched (S,...)
    v_gt = sim.velocity(traj, times)

    T_mid = Transformation(r=T_gt.r[S // 2], q=T_gt.q[S // 2])
    center = transform_point(T_mid, torch.tensor([0.0, 0.0, 4.0], **kw))
    lms = sim.landmark_grid(rng, n_landmarks, center, torch.tensor([8.0, 8.0, 4.0], **kw))

    window = empty_window(cfg, dtype, rig=rig_p, device=device)
    factors = empty_factors(cfg, dtype, device=device)

    r0, q0 = T_gt.r, T_gt.q
    sb0 = torch.cat([v_gt, torch.zeros((S, 6), **kw)], dim=1)
    dp = state_perturb * torch.as_tensor(rng.standard_normal((S, 3)), **kw)
    da = state_perturb * torch.as_tensor(rng.standard_normal((S, 3)), **kw)
    dp[0] = 0.0
    da[0] = 0.0
    window = window._replace(
        r=r0 + dp,
        q=quat.normalize(quat.multiply(quat.exp(da), q0)),
        speed_bias=sb0.clone(),
        state_valid=torch.ones(S, dtype=torch.bool, device=device),
        is_keyframe=torch.ones(S, dtype=torch.bool, device=device),
        timestamp=times.clone(),
        state_id=torch.arange(S, dtype=torch.int32, device=device),
    )

    L = cfg.num_landmarks
    n_lm = min(n_landmarks, L)
    lm_noise = lm_perturb * torch.as_tensor(rng.standard_normal((n_lm, 3)), **kw)
    hp = window.hp_W.clone()
    hp[:n_lm, :3] = lms[:n_lm] + lm_noise
    lm_valid = window.lm_valid.clone()
    lm_valid[:n_lm] = True
    lm_id = window.lm_id.clone()
    lm_id[:n_lm] = torch.arange(n_lm, dtype=torch.int32, device=device)
    window = window._replace(hp_W=hp, lm_valid=lm_valid, lm_id=lm_id)

    obs_s, obs_l, obs_c, obs_uv = [], [], [], []
    for s in range(S):
        T_WS = Transformation(r=r0[s], q=q0[s])
        for c in range(rig.num_cameras):
            p_C = transform_point(inverse(compose(T_WS, rig.T_SC[c])), lms[:n_lm])
            uv, valid = project(rig.cameras[c], p_C)
            idx = torch.nonzero(valid).reshape(-1)
            obs_s += [s] * len(idx)
            obs_c += [c] * len(idx)
            obs_l.append(idx)
            obs_uv.append(uv[idx])
    obs_l = torch.cat(obs_l)
    obs_uv = torch.cat(obs_uv)
    noise = pix_noise * torch.as_tensor(rng.standard_normal((len(obs_s), 2)), **kw)
    n_obs = min(len(obs_s), cfg.num_obs)
    f = factors.reproj
    uv_t, si, li, ci = f.uv.clone(), f.state_idx.clone(), f.lm_idx.clone(), f.cam_idx.clone()
    sq, ok = f.sqrt_info.clone(), f.valid.clone()
    uv_t[:n_obs] = obs_uv[:n_obs] + noise[:n_obs]
    si[:n_obs] = torch.tensor(obs_s[:n_obs], dtype=torch.int32, device=device)
    li[:n_obs] = obs_l[:n_obs].to(torch.int32)
    ci[:n_obs] = torch.tensor(obs_c[:n_obs], dtype=torch.int32, device=device)
    sq[:n_obs] = 1.0 / max(pix_noise, 0.3)
    ok[:n_obs] = True
    f = f._replace(uv=uv_t, state_idx=si, lm_idx=li, cam_idx=ci, sqrt_info=sq, valid=ok)

    series = sim.simulate_imu(
        traj, float(times[0]) - 0.05, float(times[-1]) + 0.05, imu_rate,
        IMU_PARAMS, rng=rng, noisy=imu_noisy,
    )
    ts_np = series.t.cpu().numpy()
    pres = []
    for k in range(S - 1):
        t0, t1 = times[k], times[k + 1]
        sl = _imu_slice(ts_np, float(t0), float(t1))
        pres.append(preintegrate(
            series.t[sl], series.gyro[sl], series.acc[sl],
            torch.ones(series.t[sl].shape, dtype=torch.bool, device=device),
            t0, t1, torch.zeros(6, **kw), IMU_PARAMS,
        ))
    pre_b = type(pres[0])(*(torch.stack(xs) for xs in zip(*pres)))
    imu = factors.imu._replace(
        pre=pre_b, sqrt_info=sqrt_information(pre_b),
        valid=torch.ones(S - 1, dtype=torch.bool, device=device),
    )

    pr = factors.priors
    pose_si = pr.pose_sqrt_info.clone()
    pose_si[0] = torch.diag(torch.tensor([1e4, 1e4, 1e4, 5.0, 5.0, 1e4], **kw))
    sb_si = pr.sb_sqrt_info.clone()
    sb_si[0] = torch.diag(torch.tensor(
        [10.0] * 3 + [1.0 / IMU_PARAMS.sigma_bg] * 3 + [1.0 / IMU_PARAMS.sigma_ba] * 3, **kw))
    first = (torch.arange(S, device=device) == 0)
    pr = pr._replace(
        pose_mean_r=torch.where(first[:, None], r0, pr.pose_mean_r),
        pose_mean_q=torch.where(first[:, None], q0, pr.pose_mean_q),
        pose_sqrt_info=pose_si,
        pose_valid=first.clone(),
        sb_mean=torch.where(first[:, None], sb0, pr.sb_mean),
        sb_sqrt_info=sb_si,
        sb_valid=first.clone(),
    )

    factors = factors._replace(reproj=f, imu=imu, priors=pr)
    truth = {"r": r0, "q": q0, "sb": sb0, "lms": lms[:n_lm], "times": times, "rig": rig}
    return window, factors, rig_p, truth


def attach_depth_and_sonar(factors, truth: dict, window, sonar_slots: Sequence[int],
                           rng: np.random.Generator, depth_noise: float = 0.01,
                           range_noise: float = 0.02):
    """Depth factor on every state and sonar-range factors on
    ``sonar_slots``, from the synthetic truth — what the engine attaches
    from its pressure and sonar buffers: depth = first_depth − z_WS with
    first_depth = 0, and the range from the true position to the landmark
    nearest it, with that landmark's window estimate as the target."""
    r_true = truth["r"]
    S = r_true.shape[0]
    kw = dict(dtype=r_true.dtype, device=r_true.device)
    dep = factors.depth
    depth = -r_true[:, 2] + depth_noise * torch.as_tensor(rng.standard_normal(S), **kw)
    dep = dep._replace(
        depth=depth,
        first_depth=torch.zeros((), **kw),
        valid=window.state_valid.clone(),
    )
    so = factors.sonar
    rng_t, tgt, val = so.range.clone(), so.target_W.clone(), so.valid.clone()
    for s in sonar_slots:
        d = torch.linalg.norm(truth["lms"] - r_true[s], dim=-1)
        l = int(torch.argmin(d))
        tgt[s] = window.hp_W[l, :3]
        rng_t[s] = d[l] + range_noise * float(rng.standard_normal())
        val[s] = True
    so = so._replace(range=rng_t, target_W=tgt, valid=val)
    return factors._replace(depth=dep, sonar=so)


class Frame(NamedTuple):
    """One frame's matcher inputs (C cameras x K keypoints) plus the map-side
    tables the matcher reads beside the window."""

    uv: torch.Tensor  # (C,K,2) keypoint pixels
    desc: torch.Tensor  # (C,K,W) int32 packed descriptors
    valid: torch.Tensor  # (C,K) bool
    sigma: torch.Tensor  # (C,K) per-keypoint pixel std
    pos_var: torch.Tensor  # () pose translation variance [m²]
    T_WS_r: torch.Tensor  # (3,) predicted pose
    T_WS_q: torch.Tensor  # (4,)
    lm_desc: torch.Tensor  # (L,W) int32 landmark descriptors
    lm_cov: torch.Tensor  # (L,3,3) landmark position covariance [m²]


def random_descriptors(rng: np.random.Generator, n: int, words: int = 8) -> np.ndarray:
    """(n, words) int32 views of uniformly random 32-bit words."""
    return rng.integers(0, 2**32, size=(n, words), dtype=np.uint64).astype(np.uint32).view(np.int32)


def make_frame(rng: np.random.Generator, window, truth: dict, rig_p, lm_desc: np.ndarray,
               slot: int, K: int = 400, pix_noise: float = 0.5, flip_bits: int = 4,
               pos_var: float = 1e-2, lm_cov_var: float = 0.25):
    """Keypoints of state ``slot``: the in-image projections of the valid
    landmarks (true positions, true pose) with pixel noise and descriptors
    equal to the landmark's with ``flip_bits`` random bits flipped, padded to
    K per camera with random distractors. Returns (Frame, truth_idx (C,K)
    int64: the landmark slot behind each keypoint, -1 for distractors).
    The predicted pose is the window's estimate of the slot."""
    dtype, device = window.r.dtype, window.r.device
    C = rig_p.num_cameras
    L, W = lm_desc.shape
    lms = truth["lms"]
    n_lm = lms.shape[0]
    T_WS = Transformation(r=truth["r"][slot], q=truth["q"][slot])
    uv_all = np.zeros((C, K, 2))
    desc_all = np.zeros((C, K, W), np.int32)
    tidx = np.full((C, K), -1, np.int64)
    lm_valid = window.lm_valid[:n_lm].cpu().numpy()
    for c in range(C):
        T_SC = Transformation(r=rig_p.T_SC_r[c], q=rig_p.T_SC_q[c])
        p_C = transform_point(inverse(compose(T_WS, T_SC)), lms)
        uv, ok = project(rig_p.camera(c), p_C)
        ok = ok.cpu().numpy() & lm_valid
        idx = np.nonzero(ok)[0][:K]
        n = len(idx)
        uv_all[c, :n] = uv.cpu().numpy()[idx] + pix_noise * rng.standard_normal((n, 2))
        d = lm_desc[idx].view(np.uint32).copy()
        for j in range(n):
            for bit in rng.choice(W * 32, size=flip_bits, replace=False):
                d[j, bit // 32] ^= np.uint32(1 << int(bit % 32))
        desc_all[c, :n] = d.view(np.int32)
        tidx[c, :n] = idx
        m = K - n
        uv_all[c, n:] = rng.uniform(size=(m, 2)) * [rig_p.width - 1, rig_p.height - 1]
        desc_all[c, n:] = random_descriptors(rng, m, W)
    kw = dict(dtype=dtype, device=device)
    frame = Frame(
        uv=torch.as_tensor(uv_all, **kw),
        desc=torch.as_tensor(desc_all, device=device),
        valid=torch.ones((C, K), dtype=torch.bool, device=device),
        sigma=torch.full((C, K), 0.8, **kw),
        pos_var=torch.tensor(pos_var, **kw),
        T_WS_r=window.r[slot].clone(),
        T_WS_q=window.q[slot].clone(),
        lm_desc=torch.as_tensor(lm_desc, device=device),
        lm_cov=(lm_cov_var * torch.eye(3, **kw)).repeat(L, 1, 1),
    )
    return frame, tidx
