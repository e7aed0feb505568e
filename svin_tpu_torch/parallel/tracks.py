"""Track-structured global bundle adjustment, on one device or sharded over
a process mesh: the solver for Cave-scale maps (thousands of keyframes,
tens of thousands of landmarks).

Counterpart of the JAX package's ``parallel/tracks.py``. A landmark is
seen by a contiguous run of keyframes, its track: ``tracks_from_problem`` sorts the landmarks by their first observing pose
(the base) and lays each one's observations of poses base .. base+span-1
out in ``span * C`` dense slots (slot j: pose base + j // C, camera j % C);
what does not fit (loop-closure re-observations, slot collisions) goes to a
small COO overflow set, so the solver is exact for any problem.

The factor evaluation is unrolled by hand into channel arrays shaped
(slots, L), as in the JAX package (``_eval_core``). The TPU's data movement
is ported by meaning: its one-hot block matmuls over pose windows and its
shift-add of slot offsets (``_banded_reduce``, ``_shift_add``, the block
windows of ``_phase1_z`` / ``_phase2_y``) become one ``index_add_`` of the
per-landmark rows at pose base + r for the pose-side sums and one gather
``v[base + r]`` for the broadcast; the overflow's segment sums become
``index_add_``. A pose's cameras see the same pose update, so the matvec
keeps W summed over each pose's cameras: (L, 3, span·6).

The math is ``pcg.ba_solve_pcg``'s: the Schur-reduced camera system by PCG
with block-Jacobi preconditioning, robust weight sqrt(min(1, 3/|r|)),
validity at depth > 0.2, fixed poses by Jacobian zeroing and unit damping.
The GN and CG loops make no host synchronisation; on CUDA the entry points
run float32 products in full float32 (TF32 off).

Sharded (``make_sharded_ba_tracks``, on ``tracks_from_problem(...,
n_shards=n)``): the landmark blocks, sorted by base, are cut contiguously
into one block per rank of a ``runtime.ProcessMesh``, with each shard's
overflow; poses and the CG state are replicated. ``ProcessMesh.psum`` sums
the (K, 33) pose-side reduction and the cost once per GN step and the (K, 6)
matvec output once per CG iteration, one ``all_reduce`` where the JAX
package has one ``psum``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..estimator.rig import RigParams
from ..kinematics import quaternion as quat
from ..pipeline.vio import _float32_matmuls
from .dist_ba import GlobalMapProblem, _host
from .pcg import _inv_blocks, _pcg
from .runtime import ProcessMesh, shard


class TrackMeta(NamedTuple):
    """Layout constants."""

    span: int  # consecutive poses covered per landmark track window
    C: int  # cameras (slots per landmark = span * C)
    B: int  # landmarks per block
    S: int  # pose-window size per block (>= span + base spread)
    K: int  # poses
    n_blocks: int  # L // B (per shard)
    M: int  # overflow capacity (per shard)

    @property
    def slots(self) -> int:
        return self.span * self.C


class TrackProblem(NamedTuple):
    """Device tensors. Every landmark-axis tensor is sorted by track base;
    index fields are int64."""

    pose_r: torch.Tensor  # (K,3)
    pose_q: torch.Tensor  # (K,4)
    pose_fixed: torch.Tensor  # (K,) float (1 = fixed)
    lm: torch.Tensor  # (L,3)
    lm_valid: torch.Tensor  # (L,) bool
    base: torch.Tensor  # (L,) in [0, K - span]
    lo: torch.Tensor  # (NB,) block pose-window starts
    obs_uv: torch.Tensor  # (2, slots, L)
    obs_valid: torch.Tensor  # (slots, L) bool
    ov_uv: torch.Tensor  # (M,2)
    ov_pose: torch.Tensor  # (M,)
    ov_lm: torch.Tensor  # (M,) shard-local landmark index
    ov_cam: torch.Tensor  # (M,)
    ov_valid: torch.Tensor  # (M,) bool


# --------------------------------------------------------------- host build
def tracks_from_problem(prob: GlobalMapProblem, span: int = 8, block: int = 1024,
                        n_shards: int = 1, max_overflow: int = 0
                        ) -> Tuple[TrackProblem, TrackMeta, np.ndarray]:
    """Host numpy relayout of a generic BA problem into track structure.

    Observations within ``span`` consecutive poses of a landmark's first
    observation go to dense track slots (slot = (pose - base) * C + cam);
    the rest (loop re-observations, collisions) go to the COO overflow set.
    With ``n_shards`` > 1 the landmark axis is padded to a multiple of
    ``n_shards * block`` and the overflow is grouped per shard with
    shard-local landmark indices. Tensors land on the problem's device.

    Returns ``(problem, meta, order)``: ``order[i]`` is the original
    landmark index of sorted slot i (``tp.lm[i] == prob.lm[order[i]]``;
    entries past the original L are padding)."""
    dev = prob.pose_r.device
    K = int(prob.pose_r.shape[0])
    L0 = int(prob.lm.shape[0])
    valid = _host(prob.obs_valid).astype(bool)
    cam = _host(prob.obs_cam)[valid].astype(np.int64)
    pose = _host(prob.obs_pose)[valid].astype(np.int64)
    lmi = _host(prob.obs_lm)[valid].astype(np.int64)
    uv = _host(prob.obs_uv)[valid]
    C = int(cam.max()) + 1 if cam.size else 1  # the cameras the rig uses
    span = min(span, K)
    slots = span * C

    # landmark base = first observing pose, clipped to K - span: then base + r
    # (r < span) never passes the last pose, which keeps every gather at
    # base + r in range (the TPU form's rolled tables never wrap for the
    # same reason)
    base0 = np.full(L0, K - span, np.int64)
    np.minimum.at(base0, lmi, pose)
    base0 = np.minimum(base0, K - span)
    has_obs = np.zeros(L0, bool)
    has_obs[lmi] = True

    mult = n_shards * block
    L = -(-L0 // mult) * mult
    lm_valid = np.zeros(L, bool)
    lm_valid[:L0] = _host(prob.lm_valid).astype(bool) & has_obs
    lm_np = _host(prob.lm)
    lm = np.zeros((L, 3), lm_np.dtype)
    lm[:L0] = lm_np
    base = np.full(L, K - span, np.int64)
    base[:L0] = base0

    order = np.argsort(base, kind="stable")
    lm, lm_valid, base = lm[order], lm_valid[order], base[order]
    inv_order = np.empty(L, np.int64)
    inv_order[order] = np.arange(L)

    # slot assignment; of several observations of one slot the first wins,
    # the others overflow
    li = inv_order[lmi]
    r_off = pose - base[li]
    slot = r_off * C + cam
    in_track = (r_off >= 0) & (r_off < span)
    key = slot[in_track] * L + li[in_track]
    _, uniq_pos = np.unique(key, return_index=True)
    first_mask = np.zeros(key.shape[0], bool)
    first_mask[uniq_pos] = True
    track_rows = np.nonzero(in_track)[0][first_mask]
    ov_rows = np.concatenate([np.nonzero(~in_track)[0], np.nonzero(in_track)[0][~first_mask]])
    uv_slots = np.zeros((2, slots, L), uv.dtype)
    ok_slots = np.zeros((slots, L), bool)
    uv_slots[:, slot[track_rows], li[track_rows]] = uv[track_rows].T
    ok_slots[slot[track_rows], li[track_rows]] = True

    # overflow, grouped per shard of the sorted landmark axis
    Lloc = L // n_shards
    ov_l = li[ov_rows]
    ov_shard = ov_l // Lloc
    n_ov = np.bincount(ov_shard, minlength=n_shards)
    Mloc = max(int(n_ov.max()) if ov_rows.size else 0, max_overflow)
    Mloc = -(-max(Mloc, 1) // 8) * 8
    ov_uv = np.zeros((n_shards, Mloc, 2), uv.dtype)
    ov_pose = np.zeros((n_shards, Mloc), np.int64)
    ov_lm = np.zeros((n_shards, Mloc), np.int64)
    ov_cam = np.zeros((n_shards, Mloc), np.int64)
    ov_ok = np.zeros((n_shards, Mloc), bool)
    for s in range(n_shards):
        rows = ov_rows[ov_shard == s][:Mloc]
        n = rows.shape[0]
        ov_uv[s, :n] = uv[rows]
        ov_pose[s, :n] = pose[rows]
        ov_lm[s, :n] = ov_l[ov_shard == s][:Mloc] - s * Lloc
        ov_cam[s, :n] = cam[rows]
        ov_ok[s, :n] = True

    # per-block pose windows: S covers each block's spread of bases plus span
    NB = L // block
    lo = base[np.arange(NB) * block]
    hi = base[np.arange(1, NB + 1) * block - 1]
    S = int((hi - lo).max()) + span
    S = min(-(-S // 8) * 8, K)
    lo = np.minimum(lo, K - S)

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    tp = TrackProblem(
        pose_r=prob.pose_r, pose_q=prob.pose_q,
        pose_fixed=prob.pose_fixed.to(prob.pose_r.dtype),
        lm=put(lm), lm_valid=put(lm_valid), base=put(base), lo=put(lo),
        obs_uv=put(uv_slots), obs_valid=put(ok_slots),
        ov_uv=put(ov_uv.reshape(n_shards * Mloc, 2)), ov_pose=put(ov_pose.reshape(-1)),
        ov_lm=put(ov_lm.reshape(-1)), ov_cam=put(ov_cam.reshape(-1)),
        ov_valid=put(ov_ok.reshape(-1)),
    )
    meta = TrackMeta(span=span, C=C, B=block, S=S, K=K, n_blocks=NB // n_shards, M=Mloc)
    return tp, meta, order


# ------------------------------------------------------- channel-unrolled eval
def _rot_channels(qx, qy, qz, qw):
    """Rotation matrix C(q) as 9 channel tensors (row-major R00..R22); the
    formula of ``kinematics.quaternion.to_rotation_matrix``."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    )


def _distort_channels(model: str, x, y, d):
    """Distorted normalized coordinates and the analytic 2x2 Jacobian as
    channels (xd, yd, j00, j01, j10, j11). ``d`` is a sequence of
    distortion parameters, each broadcasting against x and y; ``model`` is
    one of ``cameras.distortion``'s."""
    if model == "none":
        one, zero = torch.ones_like(x), torch.zeros_like(x)
        return x, y, one, zero, zero, one
    if model in ("radialtangential", "radialtangential8"):
        r2 = x * x + y * y
        if model == "radialtangential":
            k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            drad = k1 + 2.0 * k2 * r2  # d(radial)/d(r2)
        else:
            k1, k2, p1, p2, k3, k4, k5, k6 = (d[i] for i in range(8))
            r4 = r2 * r2
            r6 = r4 * r2
            num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
            den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
            radial = num / den
            dnum = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4
            dden = k4 + 2.0 * k5 * r2 + 3.0 * k6 * r4
            drad = (dnum * den - num * dden) / (den * den)
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        g = 2.0 * drad
        j00 = radial + x * x * g + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = x * y * g + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = x * y * g + 2.0 * p1 * x + 2.0 * p2 * y
        j11 = radial + y * y * g + 6.0 * p1 * y + 2.0 * p2 * x
        return xd, yd, j00, j01, j10, j11
    if model == "equidistant":
        k1, k2, k3, k4 = d[0], d[1], d[2], d[3]
        r2 = x * x + y * y
        r = torch.sqrt(torch.clamp(r2, min=1e-16))
        theta = torch.atan(r)
        t2 = theta * theta
        poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        theta_d = theta * poly
        scale = theta_d / r
        dpoly = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))
        dtheta_dr = 1.0 / (1.0 + r2)
        dscale_dr = (dpoly * dtheta_dr * r - theta_d) / r2
        g = dscale_dr / r
        return x * scale, y * scale, scale + x * x * g, x * y * g, x * y * g, scale + y * y * g
    raise ValueError(f"unknown distortion model {model}")


def _eval_core(rig: RigParams, u_obs, v_obs, ok, px, py, pz, qx, qy, qz, qw, fixedf,
               lx, ly, lz, lm_ok, cfu, cfv, ccu, ccv, ctx, cty, ctz, cqx, cqy, cqz, cqw, cdist):
    """Per-observation channel evaluation over broadcast-compatible tensors:
    (W[18], Hpp[21], Hll[6], bl[3], bp[6], rsq), W[a*6+b] = Σ_i Jl[i][a]
    Jp[i][b], Hpp and Hll upper-triangular row-major packed. The math of
    ``dist_ba._reproj``."""
    # C_WS = R(q); p_S = C_WSᵀ (p_W - p_r)
    R = _rot_channels(qx, qy, qz, qw)
    d0, d1, d2 = lx - px, ly - py, lz - pz
    pS0 = R[0] * d0 + R[3] * d1 + R[6] * d2
    pS1 = R[1] * d0 + R[4] * d1 + R[7] * d2
    pS2 = R[2] * d0 + R[5] * d1 + R[8] * d2
    # C_SC = R(tq); p_C = C_SCᵀ (p_S - t)
    T = _rot_channels(cqx, cqy, cqz, cqw)
    e0, e1, e2 = pS0 - ctx, pS1 - cty, pS2 - ctz
    pC0 = T[0] * e0 + T[3] * e1 + T[6] * e2
    pC1 = T[1] * e0 + T[4] * e1 + T[7] * e2
    pC2 = T[2] * e0 + T[5] * e1 + T[8] * e2
    # A = C_WS C_SC; C_CW = Aᵀ
    A = [R[i * 3] * T[j] + R[i * 3 + 1] * T[3 + j] + R[i * 3 + 2] * T[6 + j]
         for i in range(3) for j in range(3)]
    CW = [A[j * 3 + i] for i in range(3) for j in range(3)]  # C_CW row-major

    # z_safe keeps rz finite behind the camera and at padded slots, whose
    # zero weight below then makes them add exact zeros
    z_safe = torch.where(torch.abs(pC2) < 1e-6, 1e-6, pC2)
    rz = 1.0 / z_safe
    x = pC0 * rz
    y = pC1 * rz
    xd, yd, j00, j01, j10, j11 = _distort_channels(rig.model, x, y, cdist)
    uhat = cfu * xd + ccu
    vhat = cfv * yd + ccv
    ok = ok & (pC2 > 0.2) & lm_ok

    # Juv = diag(fu, fv) Jd [[rz, 0, -x rz], [0, rz, -y rz]]
    Ju = [cfu * j00 * rz, cfu * j01 * rz, cfu * (-(j00 * x + j01 * y) * rz),
          cfv * j10 * rz, cfv * j11 * rz, cfv * (-(j10 * x + j11 * y) * rz)]
    # Jl[i][a] = -Σ_k Ju[i][k] CW[k][a]
    Jl = [-(Ju[i * 3] * CW[a] + Ju[i * 3 + 1] * CW[3 + a] + Ju[i * 3 + 2] * CW[6 + a])
          for i in range(2) for a in range(3)]
    # G = C_CW [d]x
    G = []
    for i in range(3):
        c0, c1, c2 = CW[i * 3], CW[i * 3 + 1], CW[i * 3 + 2]
        G += [c1 * d2 - c2 * d1, -c0 * d2 + c2 * d0, c0 * d1 - c1 * d0]
    nf = 1.0 - fixedf
    Jp = [None] * 12  # 2 rows x 6 columns
    for i in range(2):
        for a in range(3):
            Jp[i * 6 + a] = -Jl[i * 3 + a] * nf  # translation part = -Jl
            Jp[i * 6 + 3 + a] = -(Ju[i * 3] * G[a] + Ju[i * 3 + 1] * G[3 + a]
                                  + Ju[i * 3 + 2] * G[6 + a]) * nf

    r0 = u_obs - uhat
    r1 = v_obs - vhat
    n = torch.sqrt(r0 * r0 + r1 * r1)
    w = torch.sqrt(torch.where(n > 3.0, 3.0 / torch.clamp(n, min=1e-12), 1.0))
    w = torch.where(ok, w, torch.zeros_like(w))  # before w meets any Jacobian
    w2 = w * w
    r0w, r1w = w * r0, w * r1

    W = [w2 * (Jl[a] * Jp[b] + Jl[3 + a] * Jp[6 + b]) for a in range(3) for b in range(6)]
    Hpp = [w2 * (Jp[a] * Jp[b] + Jp[6 + a] * Jp[6 + b]) for a in range(6) for b in range(a, 6)]
    Hll = [w2 * (Jl[a] * Jl[b] + Jl[3 + a] * Jl[3 + b]) for a in range(3) for b in range(a, 3)]
    bl = [w * (Jl[a] * r0w + Jl[3 + a] * r1w) for a in range(3)]
    bp = [w * (Jp[b] * r0w + Jp[6 + b] * r1w) for b in range(6)]
    rsq = r0w * r0w + r1w * r1w
    return W, Hpp, Hll, bl, bp, rsq


_TRI = {n: [(a, b) for a in range(n) for b in range(a, n)] for n in (3, 6)}


def _sym_from_tri(tri: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n(n+1)/2) upper-triangular packed → (..., n, n) symmetric."""
    pos = {}
    for t, (a, b) in enumerate(_TRI[n]):
        pos[a, b] = pos[b, a] = t
    # one stack of column views: an index tensor would be a host upload
    cols = [tri[..., pos[a, b]] for a in range(n) for b in range(n)]
    return torch.stack(cols, dim=-1).reshape(tri.shape[:-1] + (n, n))


def _slot_inputs(tp: TrackProblem, rig: RigParams, meta: TrackMeta) -> dict:
    """Per-slot channel inputs shaped (slots, L): the pose parameters by one
    gather at base + r, the camera parameters as (slots, 1) columns, the
    landmarks as (1, L) rows."""
    span, C, slots = meta.span, meta.C, meta.slots
    L = tp.lm.shape[0]
    dtype, dev = tp.pose_r.dtype, tp.pose_r.device
    Pk = torch.cat([tp.pose_r, tp.pose_q, tp.pose_fixed[:, None].to(dtype)], dim=1)  # (K,8)
    g = Pk[_pose_rows(tp, meta).T]  # (span, L, 8)
    g = g.permute(2, 0, 1)[:, :, None, :].expand(8, span, C, L).reshape(8, slots, L)
    px, py, pz, qx, qy, qz, qw, fixedf = g.unbind(0)

    cam_of_slot = torch.arange(slots, device=dev) % C

    def cc(a):  # (NC,) → (slots, 1)
        return a[cam_of_slot][:, None]

    lm = tp.lm.T
    return dict(
        u_obs=tp.obs_uv[0], v_obs=tp.obs_uv[1], ok=tp.obs_valid,
        px=px, py=py, pz=pz, qx=qx, qy=qy, qz=qz, qw=qw, fixedf=fixedf,
        lx=lm[0:1], ly=lm[1:2], lz=lm[2:3], lm_ok=tp.lm_valid[None, :],
        cfu=cc(rig.fu), cfv=cc(rig.fv), ccu=cc(rig.cu), ccv=cc(rig.cv),
        ctx=cc(rig.T_SC_r[:, 0]), cty=cc(rig.T_SC_r[:, 1]), ctz=cc(rig.T_SC_r[:, 2]),
        cqx=cc(rig.T_SC_q[:, 0]), cqy=cc(rig.T_SC_q[:, 1]), cqz=cc(rig.T_SC_q[:, 2]),
        cqw=cc(rig.T_SC_q[:, 3]), cdist=[cc(rig.dist[:, i]) for i in range(rig.dist.shape[1])],
    )


def _ov_inputs(tp: TrackProblem, rig: RigParams) -> dict:
    """The overflow's channel inputs, shape (M,)."""
    pr, pq, lm = tp.pose_r[tp.ov_pose], tp.pose_q[tp.ov_pose], tp.lm[tp.ov_lm]
    ci = tp.ov_cam
    return dict(
        u_obs=tp.ov_uv[:, 0], v_obs=tp.ov_uv[:, 1], ok=tp.ov_valid,
        px=pr[:, 0], py=pr[:, 1], pz=pr[:, 2],
        qx=pq[:, 0], qy=pq[:, 1], qz=pq[:, 2], qw=pq[:, 3],
        fixedf=tp.pose_fixed[tp.ov_pose].to(tp.pose_r.dtype),
        lx=lm[:, 0], ly=lm[:, 1], lz=lm[:, 2], lm_ok=tp.lm_valid[tp.ov_lm],
        cfu=rig.fu[ci], cfv=rig.fv[ci], ccu=rig.cu[ci], ccv=rig.cv[ci],
        ctx=rig.T_SC_r[ci, 0], cty=rig.T_SC_r[ci, 1], ctz=rig.T_SC_r[ci, 2],
        cqx=rig.T_SC_q[ci, 0], cqy=rig.T_SC_q[ci, 1], cqz=rig.T_SC_q[ci, 2],
        cqw=rig.T_SC_q[ci, 3], cdist=[rig.dist[ci, i] for i in range(rig.dist.shape[1])],
    )


def _pose_rows(tp: TrackProblem, meta: TrackMeta) -> torch.Tensor:
    """(L, span): the pose of each landmark's track offsets, base + r."""
    return tp.base[:, None] + torch.arange(meta.span, device=tp.base.device)


# -------------------------------------------------- reductions and broadcast
def _banded_reduce(rows: torch.Tensor, pose_rows: torch.Tensor, K: int) -> torch.Tensor:
    """(L, span, D) → (K, D): row (l, r) summed into pose base_l + r, one
    ``index_add_`` (the JAX package's one-hot block matmuls and
    ``_shift_add`` together)."""
    D = rows.shape[-1]
    return torch.zeros(K, D, dtype=rows.dtype, device=rows.device).index_add_(
        0, pose_rows.reshape(-1), rows.reshape(-1, D))


# -------------------------------------------------------------- assembly
class _Assembled(NamedTuple):
    Wl: torch.Tensor  # (L, 3, span*6): W per landmark and track pose, summed over its cameras
    Wov: torch.Tensor  # (M, 3, 6)
    Hll_inv: torch.Tensor  # (L, 3, 3)
    bl: torch.Tensor  # (L, 3)
    Hpp_d: torch.Tensor  # (K, 6, 6) damped
    Minv: torch.Tensor  # (K, 6, 6) block-Jacobi preconditioner
    b_red: torch.Tensor  # (K, 6) reduced right-hand side
    cost: torch.Tensor  # ()
    pose_rows: torch.Tensor  # (L, span) base + r


def _inv3_channels(h, damp):
    """Symmetric 3x3 inverse from 6 upper-triangular channels plus diagonal
    damping, as 9 row-major channels: the closed-form adjugate."""
    a, b, c = h[0] + damp[0], h[1], h[2]
    dd, e = h[3] + damp[1], h[4]
    f = h[5] + damp[2]
    A = dd * f - e * e
    Bc = c * e - b * f
    Cc = b * e - c * dd
    det = a * A + b * Bc + c * Cc
    det = torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    rd = 1.0 / det
    i00, i01, i02 = A * rd, Bc * rd, Cc * rd
    i11 = (a * f - c * c) * rd
    i12 = (b * c - a * e) * rd
    i22 = (a * dd - b * b) * rd
    return (i00, i01, i02, i01, i11, i12, i02, i12, i22)


def _assemble_tracks(tp: TrackProblem, rig: RigParams, meta: TrackMeta, lam,
                     psum: Optional[Callable] = None) -> _Assembled:
    """Evaluate and reduce the factors once: everything a PCG step needs.
    With ``psum`` the pose-side reduction and the cost are summed over the
    mesh before the damping."""
    span, C, K = meta.span, meta.C, meta.K
    L, M = tp.lm.shape[0], tp.ov_pose.shape[0]
    W, Hpp, Hll, bl, bp, rsq = _eval_core(rig, **_slot_inputs(tp, rig, meta))
    Wo, Hppo, Hllo, blo, bpo, rsqo = _eval_core(rig, **_ov_inputs(tp, rig))

    # landmark-side sums: over the slots, then the overflow's
    lsum = torch.stack(Hll + bl).sum(1).index_add_(1, tp.ov_lm, torch.stack(Hllo + blo))  # (9, L)
    Hll_s, bl_s = lsum[:6], lsum[6:].T
    not_lm = (~tp.lm_valid).to(lsum.dtype)
    damp = [lam * torch.clamp(Hll_s[i], min=1e-6) + not_lm for i in (0, 3, 5)]
    Hinv = torch.stack(_inv3_channels(Hll_s, damp), dim=-1).view(L, 3, 3)
    u = _apply_hinv(Hinv, bl_s)  # (L, 3)

    # W per landmark and track pose (its cameras summed), and the overflow's
    Wl = torch.stack(W).view(3, 6, span, C, L).sum(3).permute(3, 0, 2, 1).reshape(L, 3, span * 6)
    Wov = torch.stack(Wo, dim=-1).view(M, 3, 6)

    # pose-side sums of [Hpp(21), bp(6), corr(6)], corr_b = Σ_a W[a,b] u_a
    pose_rows = _pose_rows(tp, meta)
    hb = torch.stack(Hpp + bp).view(27, span, C, L).sum(2).permute(2, 1, 0)  # (L, span, 27)
    corr = (u[:, None, :] @ Wl).view(L, span, 6)
    red = _banded_reduce(torch.cat([hb, corr], dim=2), pose_rows, K)  # (K, 33)
    corr_ov = (u[tp.ov_lm][:, None, :] @ Wov)[:, 0]
    red.index_add_(0, tp.ov_pose, torch.cat([torch.stack(Hppo + bpo, dim=1), corr_ov], dim=1))
    cost = 0.5 * (rsq.sum() + rsqo.sum())
    if psum is not None:
        red, cost = psum(red), psum(cost)

    Hpp_m = _sym_from_tri(red[:, :21], 6)
    dHpp = torch.diagonal(Hpp_m, dim1=-2, dim2=-1)
    dampp = (lam * torch.clamp(dHpp, min=1e-6) + (tp.pose_fixed > 0).to(dHpp.dtype)[:, None]
             + (dHpp < 1e-9).to(dHpp.dtype))  # the last term: unobserved poses
    Hpp_d = Hpp_m + torch.diag_embed(dampp)
    return _Assembled(Wl=Wl, Wov=Wov, Hll_inv=Hinv, bl=bl_s, Hpp_d=Hpp_d,
                      Minv=_inv_blocks(Hpp_d), b_red=red[:, 21:27] - red[:, 27:33], cost=cost,
                      pose_rows=pose_rows)


# ---------------------------------------------------------------- matvec
def _phase1_z(asm: _Assembled, tp: TrackProblem, meta: TrackMeta, v: torch.Tensor) -> torch.Tensor:
    """z = W v summed per landmark, (L, 3): one gather v[base + r] and a
    batched product, then the overflow's."""
    L = asm.Wl.shape[0]
    z = (asm.Wl @ v[asm.pose_rows].view(L, meta.span * 6, 1))[..., 0]
    return z.index_add_(0, tp.ov_lm, (asm.Wov @ v[tp.ov_pose][..., None])[..., 0])


def _phase2_y(asm: _Assembled, tp: TrackProblem, meta: TrackMeta, u: torch.Tensor) -> torch.Tensor:
    """y = Wᵀ u summed per pose, (K, 6), u (L, 3): a batched product and one
    ``index_add_`` at base + r, then the overflow's."""
    L = asm.Wl.shape[0]
    y = _banded_reduce((u[:, None, :] @ asm.Wl).view(L, meta.span, 6), asm.pose_rows, meta.K)
    return y.index_add_(0, tp.ov_pose, (u[tp.ov_lm][:, None, :] @ asm.Wov)[:, 0])


def _apply_hinv(Hinv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (Hinv @ z[..., None])[..., 0]


def _gn_step_tracks(tp: TrackProblem, rig: RigParams, meta: TrackMeta, lam, cg_iters: int,
                    psum: Optional[Callable] = None):
    asm = _assemble_tracks(tp, rig, meta, lam, psum)

    def matvec(v):
        y2 = _phase2_y(asm, tp, meta, _apply_hinv(asm.Hll_inv, _phase1_z(asm, tp, meta, v)))
        if psum is not None:
            y2 = psum(y2)
        return (asm.Hpp_d @ v[..., None])[..., 0] - y2

    dx = _pcg(matvec, -asm.b_red, lambda v: (asm.Minv @ v[..., None])[..., 0], cg_iters)
    dl = -_apply_hinv(asm.Hll_inv, asm.bl + _phase1_z(asm, tp, meta, dx))  # (L, 3)
    return dx, dl, asm.cost


def _apply_tracks(tp: TrackProblem, dxk: torch.Tensor, dl: torch.Tensor) -> TrackProblem:
    fixed = tp.pose_fixed[:, None] > 0
    r_new = torch.where(fixed, tp.pose_r, tp.pose_r + dxk[:, :3])
    q_new = torch.where(fixed, tp.pose_q,
                        quat.normalize(quat.multiply(quat.exp(dxk[:, 3:6]), tp.pose_q)))
    lm_new = torch.where(tp.lm_valid[:, None], tp.lm + dl, tp.lm)
    return tp._replace(pose_r=r_new, pose_q=q_new, lm=lm_new)


@_float32_matmuls()
def ba_solve_tracks(tp: TrackProblem, rig: RigParams, meta: TrackMeta, iters: int = 10,
                    cg_iters: int = 32, lam: float = 1e-3) -> Tuple[TrackProblem, torch.Tensor]:
    """Track-structured GN + PCG, the semantics of ``pcg.ba_solve_pcg``:
    (problem, final cost). The final cost is the last problem's assembly
    cost (what a further GN step would report)."""
    for _ in range(iters):
        dxk, dl, _ = _gn_step_tracks(tp, rig, meta, lam, cg_iters)
        tp = _apply_tracks(tp, dxk, dl)
    return tp, _assemble_tracks(tp, rig, meta, lam).cost


def make_sharded_ba_tracks(mesh: ProcessMesh, rig: RigParams, meta: TrackMeta, iters: int = 10,
                           cg_iters: int = 32, lam: float = 1e-3):
    """The sharded track-structured BA step on ``mesh``, for a problem built
    by ``tracks_from_problem(..., n_shards=mesh.size)`` (``meta`` its
    per-shard layout): ``(step, shard)``. ``shard(tp)`` cuts this rank's
    landmark blocks (``obs_uv`` along its slot-landmark axis, ``obs_valid``
    along its second) and overflow; ``step(local)`` gives (the local
    problem, the cost summed over the mesh: the last problem's assembly
    cost, as ``ba_solve_tracks`` reports it)."""

    @_float32_matmuls()
    def step(local: TrackProblem) -> Tuple[TrackProblem, torch.Tensor]:
        tp = local
        for _ in range(iters):
            dxk, dl, _ = _gn_step_tracks(tp, rig, meta, lam, cg_iters, mesh.psum)
            tp = _apply_tracks(tp, dxk, dl)
        return tp, _assemble_tracks(tp, rig, meta, lam, mesh.psum).cost

    return step, lambda tp: shard(mesh, tp)
