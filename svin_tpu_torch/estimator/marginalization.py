"""FEJ marginalization: fold one state slot (+ its exclusive landmarks) into
the dense marginal prior, then shift the window.

Counterpart of the JAX package's ``estimator/marginalization.py``:

1. evaluate every factor touching the dropped slot at the current estimates
   (the prior's fixed linearization points),
2. Schur-eliminate landmarks observed only at the dropped slot (3x3
   eigenvalue-clipped pseudo-inverses),
3. Schur-eliminate the slot's 15 coords with an eigenvalue-clipped
   pseudo-inverse,
4. add the result to the existing prior (re-centred at the current
   estimate), project it onto its range, and left-shift all slot-indexed
   arrays.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..imu import ImuParameters
from .factors import (
    eval_depth,
    eval_imu,
    eval_priors,
    eval_reprojection,
    eval_sonar,
    marg_delta,
)
from .rig import RigParams
from .window import Factors, MarginalPrior, WindowConfig, WindowState, device_scalar


def _equilibrate(A: torch.Tensor):
    """Empty-row mask, scale d = sqrt(diag) and the clipped unit-diagonal
    matrix of symmetric (..., n, n) A (see the JAX package for the 1e-15
    relative empty-row cut and the ±8 clamp)."""
    dg = torch.diagonal(A, dim1=-2, dim2=-1)
    top = torch.clamp(torch.amax(torch.clamp(dg, min=0.0), dim=-1, keepdim=True), min=1e-30)
    good = dg > 1e-15 * top
    d = torch.where(good, torch.sqrt(torch.where(good, dg, torch.ones_like(dg))), torch.ones_like(dg))
    gmask = good[..., :, None] & good[..., None, :]
    dd = d[..., :, None] * d[..., None, :]
    An = torch.where(gmask, torch.clamp(A / dd, -8.0, 8.0), torch.zeros_like(A))
    return good, d, gmask, dd, An


def _pinv_sym(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalue-clipped pseudo-inverse of symmetric PSD (..., n, n)
    matrices, taken on the diagonally equilibrated matrix; tolerance
    machine-epsilon × n × the largest eigenvalue."""
    n = A.shape[-1]
    tol = torch.finfo(A.dtype).eps * n
    A = 0.5 * (A + A.transpose(-1, -2))
    good, d, gmask, dd, An = _equilibrate(A)
    w, V = torch.linalg.eigh(An)
    w_max = torch.clamp(torch.amax(w, dim=-1, keepdim=True), min=0.0)
    inv_w = torch.where(w > tol * torch.clamp(w_max, min=1.0), 1.0 / w, torch.zeros_like(w))
    P = ((V * inv_w[..., None, :]) @ V.transpose(-1, -2)) / dd
    return torch.where(gmask, P, torch.zeros_like(P))


def _project_to_range(H: torch.Tensor, b: torch.Tensor):
    """PSD-clamp H and drop the null(H) component of b (in equilibrated
    coordinates): the prior's quadratic is bounded below only for
    b ∈ range(H)."""
    good, d, gmask, dd, Hn = _equilibrate(H)
    w, V = torch.linalg.eigh(0.5 * (Hn + Hn.T))
    tol = torch.finfo(H.dtype).eps * H.shape[-1]
    keep = w > tol * torch.clamp(torch.max(w), min=1.0)
    w_psd = torch.where(keep, w, torch.zeros_like(w))
    Hn_psd = (V * w_psd[None, :]) @ V.T
    H_out = torch.where(gmask, Hn_psd * dd, torch.zeros_like(Hn_psd))
    H_out = 0.5 * (H_out + H_out.T)
    bn = torch.where(good, b / d, torch.zeros_like(b))
    b_out = torch.where(good, d * (V @ (keep.to(b.dtype) * (V.T @ bn))), torch.zeros_like(b))
    return H_out, b_out


def _shift_rows(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Delete row `slot` and shift the rest left; the last row duplicates
    S-1 (the caller invalidates it)."""
    S = x.shape[0]
    idx = torch.arange(S, device=x.device)
    src = torch.clamp(idx + (idx >= slot).long(), 0, S - 1)
    return x[src]


def _segcount(mask: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int32, device=mask.device)
    return out.index_add_(0, idx, mask.to(torch.int32))


def marginalize_slot(
    window: WindowState,
    factors: Factors,
    slot,
    rig: RigParams,
    imu_params: ImuParameters,
    cfg: WindowConfig,
) -> Tuple[WindowState, Factors]:
    """Fold state ``slot`` (an int or a 0-d tensor) into the marginal prior
    and compact the window. With cfg.estimate_extrinsics the prior spans
    the extrinsics coords too and the exclusive-landmark fold carries the
    [slot-pose | extrinsics] coupling."""
    S, L, D = cfg.num_states, cfg.num_landmarks, cfg.state_dim
    C = cfg.num_cameras
    E = C * 6
    Dx = cfg.full_dim
    dtype, device = window.r.dtype, window.r.device
    slot = device_scalar(slot, torch.long, device)
    ar = torch.arange(S, device=device)

    # ---------- 1. factor evaluations at current (FEJ) estimates ----------
    re = eval_reprojection(window, factors, rig, cfg)
    im = eval_imu(window, factors, imu_params)
    de = eval_depth(window, factors)
    so = eval_sonar(window, factors)
    pr = eval_priors(window, factors)

    s_idx = factors.reproj.state_idx.long()
    l_idx = factors.reproj.lm_idx.long()
    obs_at_slot = re.valid & (s_idx == slot)
    obs_elsewhere = re.valid & (s_idx != slot)
    n_elsewhere = _segcount(obs_elsewhere, l_idx, L)
    n_at_slot = _segcount(obs_at_slot, l_idx, L)
    lm_drop = window.lm_valid & (n_elsewhere == 0) & (n_at_slot > 0)
    # landmarks with no live observation anywhere return to the pool
    lm_orphan = window.lm_valid & (n_elsewhere == 0) & (n_at_slot == 0)

    Hd = torch.zeros((S, 15, 15), dtype=dtype, device=device)
    b = torch.zeros((S, 15), dtype=dtype, device=device)

    # ---------- 2. exclusive-landmark fold (3x3 Schur) ----------
    fold_o = obs_at_slot & lm_drop[l_idx]
    wf = fold_o.to(dtype)
    Jp = re.J_pose * wf[:, None, None]
    Jl = re.J_lm * wf[:, None, None]
    r = re.res * wf[:, None]
    if cfg.estimate_extrinsics:
        c_idx = factors.reproj.cam_idx.long()
        oh_c = torch.nn.functional.one_hot(c_idx, C).to(dtype)  # (O,C)
        Je = re.J_ext * wf[:, None, None]
        Jef = (oh_c[:, None, :, None] * Je[:, :, None, :]).reshape(Je.shape[0], 2, E)
        Jx = torch.cat([Jp, Jef], dim=2)  # (O,2,6+E)
    else:
        Jx = Jp
    Jlt = Jl.transpose(-1, -2)
    Hll = torch.zeros((L, 3, 3), dtype=dtype, device=device).index_add_(0, l_idx, Jlt @ Jl)
    bl = torch.zeros((L, 3), dtype=dtype, device=device).index_add_(0, l_idx, (Jlt @ r[..., None])[..., 0])
    Wx = torch.zeros((L, 3, Jx.shape[2]), dtype=dtype, device=device).index_add_(0, l_idx, Jlt @ Jx)
    Hll_inv = _pinv_sym(Hll)
    X = Jx.shape[2]
    Jx2 = Jx.reshape(-1, X)
    Hxx_obs = Jx2.T @ Jx2
    bx_obs = Jx2.T @ r.reshape(-1)
    WtHi = Wx.transpose(-1, -2) @ Hll_inv  # (L,X,3)
    Hxx_red = Hxx_obs - torch.sum(WtHi @ Wx, dim=0)
    bx_red = bx_obs - torch.sum((WtHi @ bl[..., None])[..., 0], dim=0)
    at_slot = ar == slot
    ws = at_slot.to(dtype)
    Hd[:, :6, :6] += ws[:, None, None] * Hxx_red[:6, :6]
    b[:, :6] += ws[:, None] * bx_red[:6]

    # ---------- IMU factors adjacent to the slot ----------
    i0 = ar[:-1]
    i1 = i0 + 1
    touch = im.valid & ((i0 == slot) | (i1 == slot))
    wt = touch.to(dtype)
    J0 = im.J0 * wt[:, None, None]
    J1 = im.J1 * wt[:, None, None]
    ri = im.res * wt[:, None]
    Hd[:-1] += J0.transpose(-1, -2) @ J0
    Hd[1:] += J1.transpose(-1, -2) @ J1
    H01 = J0.transpose(-1, -2) @ J1
    b[:-1] += (J0.transpose(-1, -2) @ ri[..., None])[..., 0]
    b[1:] += (J1.transpose(-1, -2) @ ri[..., None])[..., 0]

    # ---------- scalar + prior factors at the slot ----------
    for ev in (de, so):
        w_s = (at_slot & ev.valid).to(dtype)
        Jps = ev.J_p * w_s[:, None]
        rs = ev.res * w_s
        Hd[:, :3, :3] += Jps[:, :, None] * Jps[:, None, :]
        b[:, :3] += Jps * rs[:, None]
    # pose priors at the slot are not folded: the gauge fixation is dropped
    # and re-fixed on the new first pose below
    redo_fixation = torch.any(at_slot & factors.priors.pose_valid)
    ws_ = (at_slot & pr.sb_valid).to(dtype)
    Jsb = pr.sb_J * ws_[:, None, None]
    Hd[:, 6:15, 6:15] += Jsb.transpose(-1, -2) @ Jsb
    b[:, 6:15] += (Jsb.transpose(-1, -2) @ (pr.sb_res * ws_[:, None])[..., None])[..., 0]

    Hb = torch.zeros((S, S, 15, 15), dtype=dtype, device=device)
    Hb[ar, ar] = Hd
    Hb[i0, i1] = H01
    Hb[i1, i0] = H01.transpose(-1, -2)
    H_m = torch.zeros((Dx, Dx), dtype=dtype, device=device)
    H_m[:D, :D] = Hb.permute(0, 2, 1, 3).reshape(D, D)
    b_m = torch.zeros(Dx, dtype=dtype, device=device)
    b_m[:D] = b.reshape(D)
    if cfg.estimate_extrinsics:
        erow = D + torch.arange(E, device=device)
        prow = slot * 15 + torch.arange(6, device=device)
        H_m[erow[:, None], erow[None, :]] += Hxx_red[6:, 6:]
        H_m[prow[:, None], erow[None, :]] += Hxx_red[:6, 6:]
        H_m[erow[:, None], prow[None, :]] += Hxx_red[6:, :6]
        b_m[erow] += bx_red[6:]

    # ---------- existing prior, re-centred at the current estimate ----------
    m = factors.marg
    mw = m.valid.to(dtype)
    dm = marg_delta(window, factors)
    H_m = H_m + mw * m.H
    b_m = b_m + mw * (m.b + m.H @ dm)

    # ---------- 3. Schur-eliminate the slot's 15 coords ----------
    key = torch.where(at_slot, torch.full_like(ar, S), ar)
    perm_slots = torch.argsort(key)  # kept slots in order, dropped slot last
    scols = (perm_slots[:, None] * 15 + torch.arange(15, device=device)[None, :]).reshape(-1)
    cperm = torch.cat([scols[: D - 15], D + torch.arange(E, device=device), scols[D - 15:]])
    Hp = H_m[cperm][:, cperm]
    bp = b_m[cperm]
    K = Dx - 15
    A = Hp[:K, :K]
    B = Hp[:K, K:]
    Cb = Hp[K:, K:]
    C_inv = _pinv_sym(Cb)
    H_new = A - B @ C_inv @ B.T
    b_new = bp[:K] - B @ C_inv @ bp[K:]
    H_new = 0.5 * (H_new + H_new.T)
    # kept states land at coords 0..(S-1)·15, extrinsics stay at D..Dx
    dest = torch.cat([torch.arange(D - 15, device=device), D + torch.arange(E, device=device)])
    H_full = torch.zeros((Dx, Dx), dtype=dtype, device=device)
    H_full[dest[:, None], dest[None, :]] = H_new
    b_full = torch.zeros(Dx, dtype=dtype, device=device)
    b_full[dest] = b_new
    H_full, b_full = _project_to_range(H_full, b_full)

    # ---------- 4. shift window + factors ----------
    last_invalid = ar < (S - 1)
    win2 = window._replace(
        r=_shift_rows(window.r, slot),
        q=_shift_rows(window.q, slot),
        speed_bias=_shift_rows(window.speed_bias, slot),
        state_valid=_shift_rows(window.state_valid, slot) & last_invalid,
        is_keyframe=_shift_rows(window.is_keyframe, slot) & last_invalid,
        timestamp=_shift_rows(window.timestamp, slot),
        state_id=torch.where(
            last_invalid, _shift_rows(window.state_id, slot),
            torch.full_like(window.state_id, -1),
        ),
        lm_valid=window.lm_valid & ~lm_drop & ~lm_orphan,
    )

    f = factors.reproj
    new_sidx = f.state_idx - (f.state_idx > slot).to(f.state_idx.dtype)
    obs_valid = f.valid & (f.state_idx != slot) & ~lm_drop[f.lm_idx.long()]
    reproj2 = f._replace(state_idx=new_sidx, valid=obs_valid)

    # IMU links: new link j connects old states (j+(j>=slot), j+1+(j+1>=slot));
    # the link bridging the removal (j == slot-1) was folded into the prior
    imf = factors.imu
    Sm1 = S - 1
    kidx = torch.arange(Sm1, device=device)
    src_raw = kidx + (kidx >= slot).long()
    in_range = src_raw <= Sm1 - 1
    src = torch.clamp(src_raw, 0, Sm1 - 1)
    pre2 = type(imf.pre)(*(a[src] for a in imf.pre))
    valid2 = imf.valid[src] & in_range & (kidx != slot - 1)
    imu2 = imf._replace(pre=pre2, sqrt_info=imf.sqrt_info[src], valid=valid2)

    dep = factors.depth
    depth2 = dep._replace(
        depth=_shift_rows(dep.depth, slot),
        sqrt_info=_shift_rows(dep.sqrt_info, slot),
        valid=_shift_rows(dep.valid, slot) & last_invalid,
    )
    son = factors.sonar
    sonar2 = son._replace(
        range=_shift_rows(son.range, slot),
        target_W=_shift_rows(son.target_W, slot),
        sqrt_info=_shift_rows(son.sqrt_info, slot),
        valid=_shift_rows(son.valid, slot) & last_invalid,
    )
    pri = factors.priors
    priors2 = pri._replace(
        pose_mean_r=_shift_rows(pri.pose_mean_r, slot),
        pose_mean_q=_shift_rows(pri.pose_mean_q, slot),
        pose_sqrt_info=_shift_rows(pri.pose_sqrt_info, slot),
        pose_valid=_shift_rows(pri.pose_valid, slot) & last_invalid,
        sb_mean=_shift_rows(pri.sb_mean, slot),
        sb_sqrt_info=_shift_rows(pri.sb_sqrt_info, slot),
        sb_valid=_shift_rows(pri.sb_valid, slot) & last_invalid,
    )
    # gauge re-fixation: fresh prior on the new oldest pose at its current
    # estimate — position + yaw only (sqrt information 1e7), roll/pitch free
    gauge_si = 1e7 * torch.eye(6, dtype=dtype, device=device)
    gauge_si[3, 3] = gauge_si[4, 4] = 0.0
    first = (ar == 0)
    refix = redo_fixation & first
    priors2 = priors2._replace(
        pose_mean_r=torch.where(refix[:, None], win2.r, priors2.pose_mean_r),
        pose_mean_q=torch.where(refix[:, None], win2.q, priors2.pose_mean_q),
        pose_sqrt_info=torch.where(refix[:, None, None], gauge_si, priors2.pose_sqrt_info),
        pose_valid=priors2.pose_valid | refix,
    )

    marg2 = MarginalPrior(
        H=H_full,
        b=b_full,
        lin_r=win2.r,
        lin_q=win2.q,
        lin_sb=win2.speed_bias,
        lin_ext_r=win2.ext_r,
        lin_ext_q=win2.ext_q,
        valid=torch.ones((), dtype=torch.bool, device=device),
    )
    factors2 = factors._replace(
        reproj=reproj2, imu=imu2, depth=depth2, sonar=sonar2,
        priors=priors2, marg=marg2,
    )
    return win2, factors2
