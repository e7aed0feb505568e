"""Trajectory evaluation: Umeyama Sim(3)/SE(3) alignment + ATE RMSE.

A copy of the JAX package's ``evaluation.py`` (numpy only).

The evaluation harness the reference lacks in-repo (its COLMAP
pseudo-ground-truth is scale-ambiguous: ``colmap_groundtruth/README.md:5``
mandates ATE after Sim(3)/scale alignment). Also loads/saves TUM-format
trajectories (``#timestamp tx ty tz qx qy qz qw``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class Alignment(NamedTuple):
    scale: float
    R: np.ndarray  # (3,3)
    t: np.ndarray  # (3,)


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True) -> Alignment:
    """Least-squares similarity transform: dst ≈ s R src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return Alignment(scale=s, R=R, t=t)


def apply_alignment(a: Alignment, pts: np.ndarray) -> np.ndarray:
    return a.scale * pts @ a.R.T + a.t


def ate_rmse(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = True
) -> Tuple[float, Alignment]:
    """Absolute trajectory error RMSE after (Sim(3)|SE(3)) alignment.
    ``est``/``gt``: (N,3) associated positions."""
    a = umeyama(est, gt, with_scale=with_scale)
    aligned = apply_alignment(a, est)
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt(np.mean(err**2))), a


def associate(
    t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association; returns index pairs (est_idx, gt_idx)."""
    gi = np.searchsorted(t_gt, t_est)
    gi = np.clip(gi, 1, len(t_gt) - 1)
    prev = gi - 1
    use_prev = np.abs(t_gt[prev] - t_est) < np.abs(t_gt[gi] - t_est)
    gi = np.where(use_prev, prev, gi)
    ok = np.abs(t_gt[gi] - t_est) <= max_dt
    return np.nonzero(ok)[0], gi[ok]


def load_tum(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (t (N,), positions (N,3), quaternions xyzw (N,4))."""
    rows = np.loadtxt(path, comments="#")
    return rows[:, 0], rows[:, 1:4], rows[:, 4:8]


def evaluate_tum(
    est_path: str, gt_path: str, with_scale: bool = True, max_dt: float = 0.02
) -> dict:
    t_e, p_e, _ = load_tum(est_path)
    t_g, p_g, _ = load_tum(gt_path)
    ie, ig = associate(t_e, t_g, max_dt)
    rmse, a = ate_rmse(p_e[ie], p_g[ig], with_scale)
    return {
        "ate_rmse": rmse,
        "n_pairs": int(len(ie)),
        "scale": a.scale,
    }


def rpe(
    t: np.ndarray,
    p_est: np.ndarray,
    q_est: np.ndarray,
    p_gt: np.ndarray,
    q_gt: np.ndarray,
    delta_s: float = 1.0,
) -> dict:
    """Relative pose error over a fixed time delta (the TUM benchmark's
    drift metric, complementing ATE): for each pose i paired with the pose
    nearest t_i + delta, the error transform
    E = (T_gt_i⁻¹ T_gt_j)⁻¹ (T_est_i⁻¹ T_est_j); reports translational RMSE
    [m] and rotational RMSE [deg] per delta. Inputs are time-associated
    arrays (same length); quaternions xyzw."""
    from .kinematics import npq

    n = len(t)
    if n == 0:
        return {
            "rpe_trans_rmse": float("nan"),
            "rpe_rot_rmse_deg": float("nan"),
            "rpe_n_pairs": 0,
        }
    j_idx = np.searchsorted(t, t + delta_s)
    j_idx = np.clip(j_idx, 1, n - 1)
    prev = j_idx - 1
    use_prev = np.abs(t[prev] - (t + delta_s)) < np.abs(t[j_idx] - (t + delta_s))
    j_idx = np.where(use_prev, prev, j_idx)  # nearest grid point to t+delta
    ok = (
        (j_idx > np.arange(n))
        & (np.abs(t[j_idx] - (t + delta_s)) < 0.1 * delta_s)
        & (t + delta_s <= t[-1] + 0.01 * delta_s)  # tail has no valid pair
    )
    terr, rerr = [], []
    for i in np.nonzero(ok)[0]:
        j = int(j_idx[i])
        dr_e, dq_e = npq.compose_rq(
            *npq.inverse_rq(p_est[i], q_est[i]), p_est[j], q_est[j]
        )
        dr_g, dq_g = npq.compose_rq(
            *npq.inverse_rq(p_gt[i], q_gt[i]), p_gt[j], q_gt[j]
        )
        er, eq = npq.compose_rq(*npq.inverse_rq(dr_g, dq_g), dr_e, dq_e)
        terr.append(np.dot(er, er))
        w = np.clip(abs(npq.normalize(eq)[3]), -1.0, 1.0)
        rerr.append((2.0 * np.arccos(w)) ** 2)
    if not terr:
        return {"rpe_trans_rmse": float("nan"), "rpe_rot_rmse_deg": float("nan"), "rpe_n_pairs": 0}
    return {
        "rpe_trans_rmse": float(np.sqrt(np.mean(terr))),
        "rpe_rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(rerr)))),
        "rpe_n_pairs": int(len(terr)),
    }
