"""Levenberg–Marquardt solver with landmark Schur complement.

Counterpart of the JAX package's ``estimator/gauss_newton.py``: assemble the block
normal equations from all factor tables, Schur-eliminate the 3x3 landmark
blocks, solve the dense reduced camera system (the B1 kernel on CUDA),
back-substitute landmarks, and run an accept/reject LM loop of a fixed
iteration count.

The JAX package forms its segment sums as one-hot matmuls (a TPU form that
avoids scatters); here they are ``index_add_`` over the slot index (over a
flattened (landmark, state) index for the coupling block). On CUDA
``index_add_`` adds with atomics, in an order that changes from run to run:
results agree with a fixed-order sum to float32 rounding of the summed
terms (relative ~1e-6), not bit for bit.

The LM loop is a Python loop of ``cfg.max_iterations`` steps with
``torch.where`` selects and no host synchronisation; iterations at or past
``n_iters`` leave the state bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..imu import ImuParameters
from ..kinematics import quaternion as quat
from ..ops.linalg3 import eigvalsh3x3, inv3x3
from ..ops.solve import solve_spd
from .factors import (
    eval_depth,
    eval_ext_prior,
    eval_imu,
    eval_lm_prior,
    eval_priors,
    eval_reprojection,
    eval_sonar,
    marg_delta,
)
from .rig import RigParams
from .window import Factors, WindowConfig, WindowState, device_scalar


def _segsum(data: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum over the leading axis: out[k] = Σ_{idx[o] == k} data[o]."""
    out = torch.zeros((n,) + data.shape[1:], dtype=data.dtype, device=data.device)
    return out.index_add_(0, idx, data)


def _outer_sum(J: torch.Tensor) -> torch.Tensor:
    """(..., m, a) → (..., a, a): Jᵀ J per batch element."""
    return J.transpose(-1, -2) @ J


def _jtr(J: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., m, a), (..., m) → (..., a): Jᵀ r per batch element."""
    return (J.transpose(-1, -2) @ r[..., None])[..., 0]


class NormalEqs(NamedTuple):
    H: torch.Tensor  # (Dx,Dx) state(+extrinsics)-block
    b: torch.Tensor  # (Dx,)
    Hll: torch.Tensor  # (L,3,3)
    bl: torch.Tensor  # (L,3)
    W: torch.Tensor  # (L,3,Dx) landmark-state coupling
    cost: torch.Tensor  # () total robustified cost


def assemble(
    window: WindowState,
    factors: Factors,
    rig: RigParams,
    imu_params: ImuParameters,
    cfg: WindowConfig,
) -> NormalEqs:
    """Dx = state_dim, plus C·6 appended extrinsics coords when
    cfg.estimate_extrinsics."""
    S, L, D = cfg.num_states, cfg.num_landmarks, cfg.state_dim
    C = cfg.num_cameras
    dtype, device = window.r.dtype, window.r.device
    Hd = torch.zeros((S, 15, 15), dtype=dtype, device=device)  # diagonal blocks
    b = torch.zeros((S, 15), dtype=dtype, device=device)

    # --- reprojection (Schur part) ---
    re = eval_reprojection(window, factors, rig, cfg)
    s_idx = factors.reproj.state_idx.long()
    l_idx = factors.reproj.lm_idx.long()
    c_idx = factors.reproj.cam_idx.long()
    Hd[:, :6, :6] += _segsum(_outer_sum(re.J_pose), s_idx, S)
    b[:, :6] += _segsum(_jtr(re.J_pose, re.res), s_idx, S)
    Hll = _segsum(_outer_sum(re.J_lm), l_idx, L)
    bl = _segsum(_jtr(re.J_lm, re.res), l_idx, L)
    lp = eval_lm_prior(window, factors)
    Hll = Hll + _outer_sum(lp.J)
    bl = bl + _jtr(lp.J, lp.res)
    cost = 0.5 * torch.sum(lp.res * lp.res)
    Wls_o = re.J_lm.transpose(-1, -2) @ re.J_pose  # (O,3,6)
    Wls = _segsum(Wls_o, l_idx * S + s_idx, L * S).reshape(L, S, 3, 6)
    W = torch.zeros((L, 3, S, 15), dtype=dtype, device=device)
    W[:, :, :, :6] = Wls.permute(0, 2, 1, 3)
    W = W.reshape(L, 3, D)
    cost = cost + torch.sum(re.rho_cost)

    if cfg.estimate_extrinsics:
        Hee = _segsum(_outer_sum(re.J_ext), c_idx, C)
        be = _segsum(_jtr(re.J_ext, re.res), c_idx, C)
        Hpe = _segsum(
            re.J_pose.transpose(-1, -2) @ re.J_ext, s_idx * C + c_idx, S * C
        ).reshape(S, C, 6, 6)
        Wle = _segsum(
            re.J_lm.transpose(-1, -2) @ re.J_ext, l_idx * C + c_idx, L * C
        ).reshape(L, C, 3, 6)
        ep = eval_ext_prior(window, factors)
        Hee = Hee + _outer_sum(ep.J)
        be = be + _jtr(ep.J, ep.res)
        cost = cost + 0.5 * torch.sum(ep.res * ep.res)

    # --- IMU ---
    im = eval_imu(window, factors, imu_params)
    Hd[:-1] += _outer_sum(im.J0)
    Hd[1:] += _outer_sum(im.J1)
    H01 = im.J0.transpose(-1, -2) @ im.J1  # (S-1,15,15) block (i, i+1)
    b[:-1] += _jtr(im.J0, im.res)
    b[1:] += _jtr(im.J1, im.res)
    cost = cost + 0.5 * torch.sum(im.res * im.res)

    # --- depth + sonar (scalar factors on position) ---
    for ev in (eval_depth(window, factors), eval_sonar(window, factors)):
        Hd[:, :3, :3] += ev.J_p[:, :, None] * ev.J_p[:, None, :]
        b[:, :3] += ev.J_p * ev.res[:, None]
        cost = cost + 0.5 * torch.sum(ev.res * ev.res)

    # --- priors ---
    pr = eval_priors(window, factors)
    Hd[:, :6, :6] += _outer_sum(pr.pose_J)
    b[:, :6] += _jtr(pr.pose_J, pr.pose_res)
    Hd[:, 6:15, 6:15] += _outer_sum(pr.sb_J)
    b[:, 6:15] += _jtr(pr.sb_J, pr.sb_res)
    cost = cost + 0.5 * (
        torch.sum(pr.pose_res * pr.pose_res) + torch.sum(pr.sb_res * pr.sb_res)
    )

    Hb = torch.zeros((S, S, 15, 15), dtype=dtype, device=device)
    ar = torch.arange(S, device=device)
    Hb[ar, ar] = Hd
    Hb[ar[:-1], ar[1:]] = H01
    Hb[ar[1:], ar[:-1]] = H01.transpose(-1, -2)
    H = Hb.permute(0, 2, 1, 3).reshape(D, D)
    bf = b.reshape(D)

    # --- marginalization prior (FEJ over state + extrinsics coords) ---
    m = factors.marg
    dm = marg_delta(window, factors)
    mw = m.valid.to(dtype)
    cost = cost + mw * (0.5 * dm @ m.H @ dm + m.b @ dm)

    if cfg.estimate_extrinsics:
        E = C * 6
        Dx = D + E
        Hf = torch.zeros((Dx, Dx), dtype=dtype, device=device)
        Hf[:D, :D] = H
        Hf[D:, D:] = torch.block_diag(*Hee.unbind(0))
        Hpe_f = Hpe.permute(0, 2, 1, 3).reshape(S * 6, E)
        rows = (ar[:, None] * 15 + torch.arange(6, device=device)[None, :]).reshape(-1)
        Hf[rows, D:] += Hpe_f
        Hf[D:, rows] += Hpe_f.T
        bfx = torch.cat([bf, be.reshape(-1)])
        Hf = Hf + mw * m.H
        bfx = bfx + mw * (m.b + m.H @ dm)
        Wf = torch.cat([W, Wle.permute(0, 2, 1, 3).reshape(L, 3, E)], dim=2)
        return NormalEqs(H=Hf, b=bfx, Hll=Hll, bl=bl, W=Wf, cost=cost)

    # fixed extrinsics: the prior's extrinsics block is identically zero
    H = H + mw * m.H[:D, :D]
    bf = bf + mw * (m.b[:D] + m.H[:D, :D] @ dm[:D])
    return NormalEqs(H=H, b=bf, Hll=Hll, bl=bl, W=W, cost=cost)


def total_cost(
    window: WindowState,
    factors: Factors,
    rig: RigParams,
    imu_params: ImuParameters,
    cfg: WindowConfig,
) -> torch.Tensor:
    """Robustified cost only."""
    re = eval_reprojection(window, factors, rig, cfg)
    im = eval_imu(window, factors, imu_params)
    de = eval_depth(window, factors)
    so = eval_sonar(window, factors)
    pr = eval_priors(window, factors)
    m = factors.marg
    dm = marg_delta(window, factors)
    mw = m.valid.to(window.r.dtype)
    lp = eval_lm_prior(window, factors)
    cost = (
        torch.sum(re.rho_cost)
        + 0.5 * torch.sum(im.res**2)
        + 0.5 * torch.sum(de.res**2)
        + 0.5 * torch.sum(so.res**2)
        + 0.5 * torch.sum(pr.pose_res**2)
        + 0.5 * torch.sum(pr.sb_res**2)
        + 0.5 * torch.sum(lp.res**2)
        + mw * (0.5 * dm @ m.H @ dm + m.b @ dm)
    )
    if cfg.estimate_extrinsics:
        ep = eval_ext_prior(window, factors)
        cost = cost + 0.5 * torch.sum(ep.res**2)
    return cost


def _solve_step(
    eqs: NormalEqs, window: WindowState, lam: torch.Tensor, cfg: WindowConfig,
    solve=solve_spd,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped Schur-complement solve → (δx (Dx,), δl (L,3))."""
    D = eqs.H.shape[0]
    dtype, device = eqs.H.dtype, eqs.H.device

    # damping + inactive-slot regularization
    state_active = window.state_valid.repeat_interleave(15)
    if cfg.estimate_extrinsics:
        state_active = torch.cat([
            state_active,
            torch.ones(cfg.num_cameras * 6, dtype=torch.bool, device=device),
        ])
    dH = torch.diagonal(eqs.H)
    damp = lam * torch.clamp(dH, min=1e-6) + (~state_active).to(dtype)
    H = eqs.H + torch.diag(damp)

    dLl = torch.diagonal(eqs.Hll, dim1=-2, dim2=-1)  # (L,3)
    dampl = lam * torch.clamp(dLl, min=1e-6) + (~window.lm_valid).to(dtype)[:, None]
    Hll = eqs.Hll + torch.diag_embed(dampl)

    Hll_inv = inv3x3(Hll)
    L = eqs.W.shape[0]
    Wm = eqs.W.reshape(L * 3, D)
    HiW = (Hll_inv @ eqs.W).reshape(L * 3, D)
    Hib = (Hll_inv @ eqs.bl[..., None]).reshape(L * 3)
    Hred = H - Wm.T @ HiW
    bred = eqs.b - Wm.T @ Hib
    # Jacobi equilibration (unit-diagonal system S·H·S y = S·b, x = S·y):
    # the reduced system mixes coordinates whose curvatures differ by ~1e8,
    # which a float32 factorization cannot take raw. The relative floor
    # keeps an f32-cancelled tiny/negative diagonal from poisoning rsqrt.
    Hred = Hred + 1e-10 * torch.eye(D, dtype=dtype, device=device)
    dHr = torch.diagonal(Hred)
    floor = 1e-10 * torch.clamp(torch.max(dHr), min=1e-12)
    s = torch.rsqrt(torch.maximum(dHr, floor))
    Hs = Hred * (s[:, None] * s[None, :])
    dx = -(s * solve(Hs, s * bred))
    dl = -(Hll_inv @ (eqs.bl + (eqs.W @ dx))[..., None])[..., 0]
    return dx, dl


def apply_step(window: WindowState, dx: torch.Tensor, dl: torch.Tensor) -> WindowState:
    S = window.r.shape[0]
    d = dx[: S * 15].reshape(S, 15)
    dp, da, dsb = d[:, :3], d[:, 3:6], d[:, 6:15]
    sv = window.state_valid[:, None]
    r_new = torch.where(sv, window.r + dp, window.r)
    q_new = torch.where(sv, quat.normalize(quat.multiply(quat.exp(da), window.q)), window.q)
    sb_new = torch.where(sv, window.speed_bias + dsb, window.speed_bias)
    lv = window.lm_valid[:, None]
    hp_new = torch.cat(
        [torch.where(lv, window.hp_W[:, :3] + dl, window.hp_W[:, :3]), window.hp_W[:, 3:]],
        dim=1,
    )
    ext_r, ext_q = window.ext_r, window.ext_q
    if dx.shape[0] > S * 15:  # extrinsics coords appended
        de = dx[S * 15:].reshape(-1, 6)
        ext_r = ext_r + de[:, :3]
        ext_q = quat.normalize(quat.multiply(quat.exp(de[:, 3:6]), ext_q))
    return window._replace(
        r=r_new, q=q_new, speed_bias=sb_new, hp_W=hp_new, ext_r=ext_r, ext_q=ext_q,
    )


def select(pred: torch.Tensor, a, b):
    """torch.where over every tensor leaf of two NamedTuples of one type."""
    if isinstance(a, torch.Tensor):
        return torch.where(pred, a, b)
    return type(a)(*(select(pred, x, y) for x, y in zip(a, b)))


class OptimizeResult(NamedTuple):
    window: WindowState
    cost0: torch.Tensor
    cost: torch.Tensor
    iterations: torch.Tensor
    # (L,3,3) per-landmark conditional covariance inv(Hll) [m²]
    lm_cov: torch.Tensor = None


def optimize(
    window: WindowState,
    factors: Factors,
    rig: RigParams,
    imu_params: ImuParameters,
    cfg: WindowConfig,
    lam0: float = 1e-4,
    n_iters=None,
    solve=solve_spd,
) -> OptimizeResult:
    """LM loop of ``cfg.max_iterations`` steps with masked accept/reject.

    The candidate's own assembly gives both its acceptance cost and, if
    accepted, the next iteration's normal equations. ``n_iters`` (an int or
    a 0-d tensor) freezes the state after that many iterations without
    changing the loop's length. ``solve`` is the dense SPD solver (the
    dispatching wrapper by default)."""
    dtype, device = window.r.dtype, window.r.device
    bound = device_scalar(cfg.max_iterations if n_iters is None else n_iters, torch.int32, device)
    eqs = assemble(window, factors, rig, imu_params, cfg)
    cost0 = eqs.cost
    win = window
    lam = torch.full((), lam0, dtype=dtype, device=device)
    n_acc = torch.zeros((), dtype=torch.int32, device=device)
    for i in range(cfg.max_iterations):
        dx, dl = _solve_step(eqs, win, lam, cfg, solve)
        cand = apply_step(win, dx, dl)
        eqs_cand = assemble(cand, factors, rig, imu_params, cfg)
        accept = (eqs_cand.cost < eqs.cost) & (bound > i)
        win = select(accept, cand, win)
        eqs = select(accept, eqs_cand, eqs)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-9), lam * 4.0)
        n_acc = n_acc + accept.to(torch.int32)

    Hll = eqs.Hll
    eye3 = torch.eye(3, dtype=Hll.dtype, device=device)
    # landmark quality = sqrt(λmin/λmax) of the 3x3 landmark Hessian
    evs = eigvalsh3x3(Hll + 1e-12 * eye3)
    quality = torch.sqrt(torch.clamp(evs[:, 0], min=0) / torch.clamp(evs[:, 2], min=1e-12))
    win = win._replace(lm_quality=torch.where(win.lm_valid, quality, torch.zeros_like(quality)))
    lm_cov = inv3x3(Hll + 1e-6 * eye3)
    return OptimizeResult(
        window=win, cost0=cost0, cost=eqs.cost, iterations=n_acc, lm_cov=lm_cov,
    )
