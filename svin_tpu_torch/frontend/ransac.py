"""Batched RANSAC: absolute pose (3D-2D, prior-seeded or seed-free P3P),
rotation-only and relative pose (2D-2D), every hypothesis solved at once
along a leading batch dim.

Counterpart of the JAX package's ``frontend/ransac.py``: each hypothesis is
a prior-seeded Gauss-Newton fit on its minimal sample (rotation-only: a
closed-form Kabsch fit), the hypothesis with the most inliers is refined on
its inliers. Differences of form:

- The sampled indices are an input, ``hyp_idx`` (H, s) int64, in place of a
  PRNG key: torch cannot reproduce ``jax.random`` streams, so callers draw
  (``draw_hypotheses``) and the parity tests feed the JAX draws in.
- The GN Jacobians are analytic (the JAX package takes them by ``jacfwd``);
  the fixed-length ``lax.scan`` loops are Python loops; the 5x5/6x6 normal
  equations are solved with ``torch.linalg.solve_ex`` (no host sync). The
  Kabsch SVD (``torch.linalg.svd``) checks convergence on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kinematics import Transformation, quaternion as quat


class RansacResult(NamedTuple):
    T: Transformation  # best model (meaning depends on call)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # ()
    success: torch.Tensor  # ()


def draw_hypotheses(valid: torch.Tensor, num_hypotheses: int, sample_size: int,
                    generator: torch.Generator = None) -> torch.Tensor:
    """(H, s) int64 sample indices, each row drawn uniformly without
    replacement from the valid entries of ``valid`` (N,), on its device and
    without a host sync: uniform keys in [0, 1), pushed past every valid
    key (+2) at invalid entries, and the s smallest per row. With fewer
    than s valid entries, invalid ones fill the row (the JAX sampler's 1e-9
    weight does the same)."""
    N = valid.shape[0]
    u = torch.rand((num_hypotheses, N), generator=generator, device=valid.device,
                   dtype=torch.float64)
    u = torch.where(valid, u, u + 2.0)  # invalid entries sort after every valid one
    return torch.topk(u, sample_size, dim=-1, largest=False).indices


def _bearing_residual(T_WC: Transformation, p_W, bearing):
    """Predicted minus measured unit bearing (..., N, 3) in the camera."""
    q_inv = quat.conjugate(T_WC.q)
    p_C = quat.rotate(q_inv[..., None, :], p_W - T_WC.r[..., None, :])
    pred = p_C / torch.clamp(torch.linalg.norm(p_C, dim=-1, keepdim=True), min=1e-12)
    return pred - bearing


def _gn_pose_fit(T0: Transformation, p_W, bearings, weights, iters: int = 7,
                 damping: float = 1e-6) -> Transformation:
    """Damped GN on SE(3) minimizing weighted bearing residuals, batched:
    T0 (..., 3)/(..., 4), p_W and bearings (..., N, 3), weights (..., N).
    Perturbation T ⊞ δ = (r + δp, exp(δα) ⊗ q), as the JAX package's."""
    T = T0
    eye6 = torch.eye(6, dtype=p_W.dtype, device=p_W.device)
    for _ in range(iters):
        C = quat.to_rotation_matrix(T.q)  # (..., 3, 3)
        Ct = C.transpose(-1, -2)[..., None, :, :]  # (..., 1, 3, 3)
        v = p_W - T.r[..., None, :]  # world offset
        p_C = (Ct @ v[..., None])[..., 0]
        n = torch.clamp(torch.linalg.norm(p_C, dim=-1, keepdim=True), min=1e-12)
        u = p_C / n
        r0 = (u - bearings) * weights[..., None]
        # d u / d p_C = (I − u uᵀ)/|p_C|; d p_C/dδp = −Cᵀ; d p_C/dδα = Cᵀ [v]×
        Pu = (torch.eye(3, dtype=p_W.dtype, device=p_W.device) - u[..., :, None] * u[..., None, :]) / n[..., None]
        J_p = -(Pu @ Ct)
        J_a = Pu @ Ct @ quat.cross_mx(v)
        J = torch.cat([J_p, J_a], dim=-1) * weights[..., None, None]  # (..., N, 3, 6)
        J = J.reshape(J.shape[:-3] + (-1, 6))
        r0 = r0.reshape(r0.shape[:-2] + (-1,))
        H = J.transpose(-1, -2) @ J + damping * eye6
        g = (J.transpose(-1, -2) @ r0[..., None])[..., 0]
        delta = -torch.linalg.solve_ex(H, g)[0]
        T = Transformation(
            r=T.r + delta[..., :3],
            q=quat.normalize(quat.multiply(quat.exp(delta[..., 3:6]), T.q)),
        )
    return T


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for a 0-d index tensor, without a host synchronisation."""
    return torch.index_select(x, 0, idx.reshape(1))[0]


def absolute_pose_ransac(
    hyp_idx: torch.Tensor,  # (H, 3) sample indices
    p_W: torch.Tensor,  # (N,3) landmark positions
    bearings: torch.Tensor,  # (N,3) measured unit bearings in camera frame
    valid: torch.Tensor,  # (N,)
    T_WC_prior: Transformation,  # IMU-predicted camera pose (seed)
    focal_px: float = 450.0,
    threshold_px: float = 3.0,
    min_inliers=10,
    refine_iters: int = 5,
) -> RansacResult:
    """3D-2D absolute-pose RANSAC: every hypothesis a 7-step GN from the
    prior on its 3-point sample; angular inlier threshold threshold_px /
    focal_px."""
    dtype = p_W.dtype
    thr = threshold_px / focal_px
    H = hyp_idx.shape[0]
    w = valid[hyp_idx].to(dtype)
    T0 = Transformation(r=T_WC_prior.r.expand(H, 3), q=T_WC_prior.q.expand(H, 4))
    Ts = _gn_pose_fit(T0, p_W[hyp_idx], bearings[hyp_idx], w, iters=7)
    err = torch.linalg.norm(_bearing_residual(Ts, p_W, bearings), dim=-1)  # (H, N)
    inls = valid & (err < thr)
    counts = inls.sum(dim=-1)
    best = torch.argmax(counts)
    T_best = Transformation(r=_take(Ts.r, best), q=_take(Ts.q, best))
    inl_best = _take(inls, best)

    T_ref = _gn_pose_fit(T_best, p_W, bearings, inl_best.to(dtype), iters=refine_iters)
    err = torch.linalg.norm(_bearing_residual(T_ref, p_W, bearings), dim=-1)
    inl_final = valid & (err < thr)
    n = inl_final.sum()
    ok = n >= min_inliers
    T_out = Transformation(r=torch.where(ok, T_ref.r, T_WC_prior.r),
                           q=torch.where(ok, T_ref.q, T_WC_prior.q))
    return RansacResult(T=T_out, inliers=inl_final, num_inliers=n, success=ok)


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _kabsch_quat(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rotation q minimizing Σ w‖a − R b‖² via SVD of the weighted
    covariance; a, b (..., N, 3), w (..., N)."""
    C = torch.einsum("...n,...ni,...nj->...ij", w, a, b)
    U, _, Vt = torch.linalg.svd(C)
    d = torch.sign(_det3(U @ Vt))
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return quat.from_rotation_matrix(U @ S @ Vt)


def rotation_only_ransac(
    hyp_idx: torch.Tensor,  # (H, 2)
    bearings_a: torch.Tensor,  # (N,3) unit bearings, frame A
    bearings_b: torch.Tensor,  # (N,3) unit bearings, frame B
    valid: torch.Tensor,
    threshold_px: float = 3.0,
    focal_px: float = 450.0,
    min_inliers: int = 10,
) -> RansacResult:
    """2-point rotation-only RANSAC: hypotheses are closed-form Kabsch fits
    on bearing pairs."""
    dtype = bearings_a.dtype
    thr = threshold_px / focal_px
    q_h = _kabsch_quat(bearings_a[hyp_idx], bearings_b[hyp_idx], valid[hyp_idx].to(dtype))  # (H,4)
    pred = quat.rotate(q_h[:, None, :], bearings_b)
    err = torch.linalg.norm(pred - bearings_a, dim=-1)
    inls = valid & (err < thr)
    best = torch.argmax(inls.sum(dim=-1))
    inl_best = _take(inls, best)
    q_ref = _kabsch_quat(bearings_a, bearings_b, inl_best.to(dtype))
    err = torch.linalg.norm(quat.rotate(q_ref, bearings_b) - bearings_a, dim=-1)
    inl = valid & (err < thr)
    n = inl.sum()
    T = Transformation(r=torch.zeros(3, dtype=dtype, device=bearings_a.device), q=q_ref)
    return RansacResult(T=T, inliers=inl, num_inliers=n, success=n >= min_inliers)


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) orthonormal basis of the plane ⊥ t (branchless helper)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    helper = torch.where((torch.abs(t[..., 0]) < 0.9)[..., None], ex, ey)
    e1 = quat.cross(t, helper)
    e1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True), min=1e-12)
    e2 = quat.cross(t, e1)
    return torch.stack([e1, e2], dim=-2)


def _epipolar_residual(q_ab, t_hat, bA, bB):
    """Per-pair epipolar coplanarity residual bAᵀ (t̂ × R bB), (..., N);
    q_ab (..., 4), t_hat (..., 3), bearings (..., N, 3)."""
    Rb = quat.rotate(q_ab[..., None, :], bB)
    n = quat.cross(t_hat[..., None, :], Rb)
    return torch.sum(bA * n, dim=-1)


def _gn_rel_fit(q0, t0, bA, bB, weights, iters: int = 10, damping: float = 1e-8):
    """Damped GN on (rotation, unit translation direction) minimizing the
    weighted epipolar residuals, batched over leading dims. Perturbation:
    q ← exp(d[:3]) ⊗ q, t ← normalize(t + d3·e1 + d4·e2) with (e1, e2) the
    tangent basis at t."""
    q, t = q0, t0
    eye5 = torch.eye(5, dtype=bA.dtype, device=bA.device)
    for _ in range(iters):
        Rb = quat.rotate(q[..., None, :], bB)  # (..., N, 3)
        B = _tangent_basis(t)  # (..., 2, 3)
        tn = torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
        t_hat = t / tn
        r0 = torch.sum(bA * quat.cross(t_hat[..., None, :], Rb), dim=-1) * weights
        # rotation: Rb ← Rb + α × Rb, and bA·(t̂ × (α × Rb)) = α·(Rb × (bA × t̂))
        J_a = quat.cross(Rb, quat.cross(bA, t_hat[..., None, :]))
        # direction: d t̂/d d_k = e_k/|t| − t (t·e_k)/|t|³, dr = bA·(dt̂ × Rb)
        Rb_x_bA = quat.cross(Rb, bA)
        cols = []
        for k in range(2):
            e = B[..., k, :]
            dt = e / tn - t * (torch.sum(t * e, dim=-1, keepdim=True) / tn ** 3)
            cols.append(torch.sum(Rb_x_bA * dt[..., None, :], dim=-1))
        J = torch.cat([J_a, torch.stack(cols, dim=-1)], dim=-1) * weights[..., None]  # (..., N, 5)
        Hm = J.transpose(-1, -2) @ J + damping * eye5
        d = -torch.linalg.solve_ex(Hm, (J.transpose(-1, -2) @ r0[..., None])[..., 0])[0]
        q = quat.normalize(quat.multiply(quat.exp(d[..., :3]), q))
        t_new = t + d[..., 3:4] * B[..., 0, :] + d[..., 4:5] * B[..., 1, :]
        t = t_new / torch.clamp(torch.linalg.norm(t_new, dim=-1, keepdim=True), min=1e-12)
    return q, t


def relative_pose_ransac(
    hyp_idx: torch.Tensor,  # (H, 5)
    bearings_a: torch.Tensor,  # (N,3) unit bearings, frame A
    bearings_b: torch.Tensor,  # (N,3) unit bearings, frame B
    valid: torch.Tensor,
    T_AB_prior: Transformation,  # IMU-predicted relative pose A→B (seed)
    threshold_px: float = 3.0,
    focal_px: float = 450.0,
    min_inliers: int = 10,
    refine_iters: int = 10,
) -> RansacResult:
    """2D-2D relative-pose RANSAC: prior-seeded GN hypotheses on the epipolar
    objective over 5-point samples. The returned T has a unit-norm
    translation direction."""
    dtype = bearings_a.dtype
    thr = threshold_px / focal_px
    q_prior = T_AB_prior.q
    t_prior = T_AB_prior.r
    tn = torch.linalg.norm(t_prior)
    t_prior = torch.where(tn > 1e-9, t_prior / torch.clamp(tn, min=1e-12),
                          torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=t_prior.device))
    Hn = hyp_idx.shape[0]
    w = valid[hyp_idx].to(dtype)
    qs, ts = _gn_rel_fit(q_prior.expand(Hn, 4), t_prior.expand(Hn, 3),
                         bearings_a[hyp_idx], bearings_b[hyp_idx], w, iters=7)
    r = _epipolar_residual(qs, ts, bearings_a, bearings_b)  # (H, N)
    inls = valid & (torch.abs(r) < thr)
    best = torch.argmax(inls.sum(dim=-1))
    q_b, t_b, inl_b = _take(qs, best), _take(ts, best), _take(inls, best)
    q_r, t_r = _gn_rel_fit(q_b, t_b, bearings_a, bearings_b, inl_b.to(dtype), iters=refine_iters)
    r = _epipolar_residual(q_r, t_r, bearings_a, bearings_b)
    inl = valid & (torch.abs(r) < thr)
    n = inl.sum()
    ok = n >= min_inliers
    return RansacResult(
        T=Transformation(r=torch.where(ok, t_r, t_prior), q=torch.where(ok, q_r, q_prior)),
        inliers=inl, num_inliers=n, success=ok,
    )


# ----------------------------------------------------------- closed-form P3P
def _quartic_roots(A, B, C, D, E, iters: int = 40) -> torch.Tensor:
    """All four complex roots of A v⁴ + B v³ + C v² + D v + E (coefficients
    batched (...,)) by Durand–Kerner simultaneous iteration from scaled
    rotating starts; (..., 4) complex128 for float64 input, else complex64."""
    cdtype = torch.complex128 if A.dtype == torch.float64 else torch.complex64
    A_ = torch.where(torch.abs(A) < 1e-12, torch.full_like(A, 1e-12), A)
    a, b, c, d = ((X / A_).to(cdtype)[..., None] for X in (B, C, D, E))

    def poly(x):
        return (((x + a) * x + b) * x + c) * x + d

    # Cauchy-style root bound scales the standard rotating starts
    bound = 1.0 + torch.maximum(torch.maximum(torch.abs(a), torch.abs(b)),
                                torch.maximum(torch.abs(c), torch.abs(d)))
    seed = torch.tensor(0.4 + 0.9j, dtype=cdtype, device=A.device)
    z = bound * seed ** torch.arange(1, 5, device=A.device).to(cdtype)
    eye = torch.eye(4, dtype=cdtype, device=A.device)
    tiny = torch.tensor(1e-30, dtype=cdtype, device=A.device)
    for _ in range(iters):
        # z_i ← z_i − p(z_i) / ∏_{j≠i} (z_i − z_j)
        diff = z[..., :, None] - z[..., None, :] + eye  # diagonal → 1
        denom = diff[..., 0] * diff[..., 1] * diff[..., 2] * diff[..., 3]
        denom = torch.where(torch.abs(denom) < 1e-30, tiny, denom)
        z = z - poly(z) / denom
    return z


def _p3p_grunert(f: torch.Tensor, P: torch.Tensor):
    """Closed-form P3P (Grunert's quartic), batched: unit bearings f
    (..., 3, 3) and world points P (..., 3, 3) → up to four camera poses
    T_WC per triple, (r (..., 4, 3), q (..., 4, 4), ok (..., 4))."""
    dtype = f.dtype
    a2 = torch.sum((P[..., 1, :] - P[..., 2, :]) ** 2, dim=-1)
    b2 = torch.sum((P[..., 0, :] - P[..., 2, :]) ** 2, dim=-1)
    c2 = torch.sum((P[..., 0, :] - P[..., 1, :]) ** 2, dim=-1)
    ca = torch.sum(f[..., 1, :] * f[..., 2, :], dim=-1)  # cos α (rays 2-3)
    cb = torch.sum(f[..., 0, :] * f[..., 2, :], dim=-1)  # cos β (rays 1-3)
    cg = torch.sum(f[..., 0, :] * f[..., 1, :], dim=-1)  # cos γ (rays 1-2)
    b2s = torch.where(b2 < 1e-12, torch.full_like(b2, 1e-12), b2)
    m = (a2 - c2) / b2s
    n = (a2 + c2) / b2s
    A4 = (m - 1.0) ** 2 - 4.0 * (c2 / b2s) * ca * ca
    A3 = 4.0 * (m * (1.0 - m) * cb - (1.0 - n) * ca * cg + 2.0 * (c2 / b2s) * ca * ca * cb)
    A2 = 2.0 * (m * m - 1.0 + 2.0 * m * m * cb * cb + 2.0 * ((b2 - c2) / b2s) * ca * ca
                - 4.0 * n * ca * cb * cg + 2.0 * ((b2 - a2) / b2s) * cg * cg)
    A1 = 4.0 * (-m * (1.0 + m) * cb + 2.0 * (a2 / b2s) * cg * cg * cb - (1.0 - n) * ca * cg)
    A0 = (1.0 + m) ** 2 - 4.0 * (a2 / b2s) * cg * cg
    roots = _quartic_roots(A4, A3, A2, A1, A0)  # (..., 4)
    vk = torch.real(roots).to(dtype)
    real_ok = torch.abs(torch.imag(roots)).to(dtype) < 1e-4 * (1.0 + torch.abs(vk))

    # per root (trailing dim 4): side lengths along the three rays
    m4, ca4, cb4, cg4, b24 = (x[..., None] for x in (m, ca, cb, cg, b2))
    denom_u = 2.0 * (cg4 - vk * ca4)
    denom_u = torch.where(torch.abs(denom_u) < 1e-9, torch.full_like(denom_u, 1e-9), denom_u)
    u = ((-1.0 + m4) * vk * vk - 2.0 * m4 * cb4 * vk + 1.0 + m4) / denom_u
    s1sq = b24 / torch.clamp(1.0 + vk * vk - 2.0 * vk * cb4, min=1e-12)
    s1 = torch.sqrt(torch.clamp(s1sq, min=0.0))
    s2 = u * s1
    s3 = vk * s1
    ok = real_ok & (vk > 0) & (u > 0) & (s1 > 1e-6)
    fe = f[..., None, :, :]  # (..., 1, 3, 3)
    X = torch.stack([s1[..., None] * fe[..., 0, :], s2[..., None] * fe[..., 1, :],
                     s3[..., None] * fe[..., 2, :]], dim=-2)  # (..., 4, 3, 3) camera frame
    # a root that overflowed gives a non-finite triple, which the JAX
    # package's SVD carries through to a failed check and the CPU's
    # torch.linalg.svd refuses: zero it and fail it here instead
    finite = torch.isfinite(X).flatten(-2).all(dim=-1)  # (..., 4)
    X = torch.where(finite[..., None, None], X, torch.zeros_like(X))
    # absolute orientation: P ≈ R X + t
    Pe = P[..., None, :, :].expand(X.shape)
    Xm, Pm = X.mean(dim=-2), Pe.mean(dim=-2)
    q_WC = _kabsch_quat(Pe - Pm[..., None, :], X - Xm[..., None, :],
                        torch.ones(X.shape[:-1], dtype=dtype, device=f.device))
    t = Pm - quat.rotate(q_WC, Xm)
    # self-consistency: the recovered pose must reproduce the triple
    err = torch.amax(torch.linalg.norm(
        quat.rotate(q_WC[..., None, :], X) + t[..., None, :] - Pe, dim=-1), dim=-1)
    scale = torch.sqrt(torch.clamp(a2 + b2 + c2, min=1e-9))[..., None]
    return t, q_WC, ok & finite & (err < 0.02 * scale)


def absolute_pose_ransac_p3p(
    hyp_idx: torch.Tensor,  # (H, 3) sample indices
    p_W: torch.Tensor,  # (N,3)
    bearings: torch.Tensor,  # (N,3) unit, camera frame
    valid: torch.Tensor,  # (N,)
    focal_px,
    threshold_px=3.0,
    min_inliers: int = 10,
    refine_iters: int = 7,
) -> RansacResult:
    """Seed-free absolute-pose RANSAC: closed-form P3P hypotheses (up to four
    poses per sampled triple, all scored as one (H, 4, N) residual), the
    best refined by GN on its inliers (kept only if it loses no inliers),
    then a second GN refit on the support within a quarter of the threshold
    (floored at 3 px), kept when it holds a majority and loses no inliers.
    No initial pose enters: loop-closure verification must work under any
    drift."""
    dtype = p_W.dtype
    thr = threshold_px / focal_px
    ok_sample = valid[hyp_idx].all(dim=-1)  # (H,)
    r4, q4, ok4 = _p3p_grunert(bearings[hyp_idx], p_W[hyp_idx])  # (H,4,3) (H,4,4) (H,4)
    err4 = torch.linalg.norm(_bearing_residual(Transformation(r=r4, q=q4), p_W, bearings), dim=-1)
    inl4 = valid & (err4 < thr) & ok4[..., None] & ok_sample[:, None, None]  # (H,4,N)
    n4 = inl4.sum(dim=-1)
    b4 = torch.argmax(n4, dim=-1)  # first of equal counts, as jnp.argmax
    rs = torch.gather(r4, 1, b4[:, None, None].expand(-1, 1, 3))[:, 0]
    qs = torch.gather(q4, 1, b4[:, None, None].expand(-1, 1, 4))[:, 0]
    inls = torch.gather(inl4, 1, b4[:, None, None].expand(-1, 1, inl4.shape[-1]))[:, 0]
    counts = torch.gather(n4, 1, b4[:, None])[:, 0]
    best = torch.argmax(counts)
    T_best = Transformation(r=_take(rs, best), q=_take(qs, best))
    inl_b, n_b = _take(inls, best), _take(counts, best)
    # GN refinement on the best model's inliers (seeded by P3P itself)
    T_ref = _gn_pose_fit(T_best, p_W, bearings, inl_b.to(dtype), iters=refine_iters)
    err = torch.linalg.norm(_bearing_residual(T_ref, p_W, bearings), dim=-1)
    inl = valid & (err < thr)
    n = inl.sum()
    better = n >= n_b  # fall back to the unrefined best if refinement lost inliers
    T_out = Transformation(r=torch.where(better, T_ref.r, T_best.r),
                           q=torch.where(better, T_ref.q, T_best.q))
    inl = torch.where(better, inl, inl_b)
    n = torch.where(better, n, n_b)
    # second, tightened refit (the residuals of the first refit select it)
    thr2 = max(thr * 0.25, 3.0 / focal_px)
    inl_t = inl & (err < thr2)
    n_t = inl_t.sum()
    T_tight = _gn_pose_fit(T_out, p_W, bearings, inl_t.to(dtype), iters=refine_iters)
    err_t = torch.linalg.norm(_bearing_residual(T_tight, p_W, bearings), dim=-1)
    inl_chk = valid & (err_t < thr)
    n_chk = inl_chk.sum()
    use_tight = (n_t >= torch.clamp(n // 2, min=6)) & (n_chk >= n)
    T_out = Transformation(r=torch.where(use_tight, T_tight.r, T_out.r),
                           q=torch.where(use_tight, T_tight.q, T_out.q))
    inl = torch.where(use_tight, inl_chk, inl)
    n = torch.where(use_tight, n_chk, n)
    return RansacResult(T=T_out, inliers=inl, num_inliers=n, success=n >= min_inliers)
