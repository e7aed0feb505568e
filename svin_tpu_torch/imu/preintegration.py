"""IMU preintegration, propagation and the two-state IMU factor.

Counterpart of the JAX package's ``imu/preintegration.py``. ``preintegrate`` runs the
trapezoidal on-manifold recursion over the mask-padded measurement
segments; the JAX package's masked ``lax.scan`` becomes a Python loop over
the segments in which a masked segment leaves the carry unchanged. The
parts of each step that do not depend on the carry (interpolation,
saturation, the segment's rotation increment and right Jacobian) are
computed for all segments at once before the loop.

``propagate`` and ``error_and_jacobians`` broadcast over leading batch
dims (the JAX package vmaps them).

Error-state ordering: [δp, δα, δv, δb_g, δb_a].
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..kinematics import Transformation, quaternion as quat


class ImuParameters(NamedTuple):
    """Continuous-time IMU noise model (reference ``okvis::ImuParameters``)."""

    sigma_g_c: float = 12.0e-4  # gyro noise density [rad/s/sqrt(Hz)]
    sigma_a_c: float = 8.0e-3  # accelerometer noise density [m/s^2/sqrt(Hz)]
    sigma_gw_c: float = 4.0e-6  # gyro bias random walk
    sigma_aw_c: float = 4.0e-5  # accel bias random walk
    g: float = 9.81007  # gravity magnitude
    g_max: float = 7.8  # gyro saturation [rad/s]
    a_max: float = 176.0  # accel saturation [m/s^2]
    rate: int = 100  # nominal rate [Hz]
    sigma_ba: float = 0.1  # prior accel bias sigma
    sigma_bg: float = 0.03  # prior gyro bias sigma


class Preintegral(NamedTuple):
    """Relative-motion preintegral between t0 and t1 at a reference bias."""

    Delta_q: torch.Tensor  # (4,) rotation increment quaternion (xyzw)
    C_integral: torch.Tensor  # (3,3) ∫C dt
    C_doubleintegral: torch.Tensor  # (3,3) ∫∫C dt²
    acc_integral: torch.Tensor  # (3,) ∫C a dt
    acc_doubleintegral: torch.Tensor  # (3,) ∫∫C a dt²
    dalpha_db_g: torch.Tensor  # (3,3)
    dv_db_g: torch.Tensor  # (3,3)
    dp_db_g: torch.Tensor  # (3,3)
    P_delta: torch.Tensor  # (15,15) error-state covariance
    Delta_t: torch.Tensor  # () total integrated time
    bias_ref: torch.Tensor  # (6,) [b_g, b_a] linearization point


def gravity_vector(params: ImuParameters, dtype=torch.float64, device=None) -> torch.Tensor:
    """(0, 0, g). ``params.g`` is a float or a 0-d tensor (a module buffer);
    either way no host-to-device copy is made, so the LM loop that
    evaluates the IMU factors never waits on the device."""
    g_W = torch.zeros(3, dtype=dtype, device=device)
    g_W[2] = params.g
    return g_W


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., m, n) x (..., n) → (..., m)."""
    return (M @ v[..., None])[..., 0]


def _interp(t, t0, v0, t1, v1):
    """Linear interpolation of (N,3) signals, safe for t1 == t0."""
    denom = torch.where(torch.abs(t1 - t0) < 1e-12, torch.ones_like(t1), t1 - t0)
    r = torch.clamp((t - t0) / denom, 0.0, 1.0)[:, None]
    return (1.0 - r) * v0 + r * v1


def preintegrate(
    t: torch.Tensor,  # (N,) measurement times [s]
    gyro: torch.Tensor,  # (N,3)
    acc: torch.Tensor,  # (N,3)
    valid: torch.Tensor,  # (N,) bool padding mask
    t0: torch.Tensor,  # () start time [s]
    t1: torch.Tensor,  # () end time [s]
    bias: torch.Tensor,  # (6,) [b_g, b_a] linearization bias
    params: ImuParameters,
) -> Preintegral:
    """Integrate all measurement intervals overlapping [t0, t1], clamped to
    [t0, t1] with endpoint interpolation."""
    dtype, device = gyro.dtype, gyro.device
    b_g, b_a = bias[:3], bias[3:6]
    eye3 = torch.eye(3, dtype=dtype, device=device)

    # ---- per-segment quantities independent of the carry ----
    ta, tb = t[:-1], t[1:]
    a = torch.maximum(ta, t0)
    b = torch.minimum(tb, t1)
    dt = b - a
    use = valid[:-1] & valid[1:] & (dt > 0)
    dt = torch.where(use, dt, torch.zeros_like(dt))
    w0 = _interp(a, ta, gyro[:-1], tb, gyro[1:])
    w1 = _interp(b, ta, gyro[:-1], tb, gyro[1:])
    a0 = _interp(a, ta, acc[:-1], tb, acc[1:])
    a1 = _interp(b, ta, acc[:-1], tb, acc[1:])
    gyr_sat = torch.amax(torch.abs(torch.cat([w0, w1], dim=1)), dim=1) > params.g_max
    acc_sat = torch.amax(torch.abs(torch.cat([a0, a1], dim=1)), dim=1) > params.a_max
    sigma_g_c = params.sigma_g_c * torch.where(gyr_sat, 100.0, 1.0).to(dtype)
    sigma_a_c = params.sigma_a_c * torch.where(acc_sat, 100.0, 1.0).to(dtype)
    omega_true = 0.5 * (w0 + w1) - b_g
    acc_true = 0.5 * (a0 + a1) - b_a
    dq_all = quat.exp(omega_true * dt[:, None])
    Jr_all = quat.right_jacobian(omega_true * dt[:, None])
    Rdq_inv_all = quat.to_rotation_matrix(quat.conjugate(dq_all))
    acc_x_all = quat.cross_mx(acc_true)
    s2_alpha_all = dt * sigma_g_c**2
    s2_v_all = dt * sigma_a_c**2
    s2_p_all = 0.5 * dt * dt * s2_v_all
    s2_bg_all = dt * params.sigma_gw_c**2
    s2_ba_all = dt * params.sigma_aw_c**2
    Q_all = torch.diag_embed(torch.cat([
        s2_p_all[:, None].expand(-1, 3), s2_alpha_all[:, None].expand(-1, 3),
        s2_v_all[:, None].expand(-1, 3), s2_bg_all[:, None].expand(-1, 3),
        s2_ba_all[:, None].expand(-1, 3),
    ], dim=1))

    Delta_q = quat.identity(dtype, device)
    C_int = torch.zeros((3, 3), dtype=dtype, device=device)
    C_dbl = torch.zeros((3, 3), dtype=dtype, device=device)
    acc_int = torch.zeros(3, dtype=dtype, device=device)
    acc_dbl = torch.zeros(3, dtype=dtype, device=device)
    cross = torch.zeros((3, 3), dtype=dtype, device=device)
    dalpha = torch.zeros((3, 3), dtype=dtype, device=device)
    dv = torch.zeros((3, 3), dtype=dtype, device=device)
    dp = torch.zeros((3, 3), dtype=dtype, device=device)
    P = torch.zeros((15, 15), dtype=dtype, device=device)
    Delta_t = torch.zeros((), dtype=dtype, device=device)

    for i in range(t.shape[0] - 1):
        h = dt[i]
        acc_true_i = acc_true[i]
        Jr = Jr_all[i]
        acc_x = acc_x_all[i]
        Delta_q_1 = quat.normalize(quat.multiply(Delta_q, dq_all[i]))
        C = quat.to_rotation_matrix(Delta_q)
        C_1 = quat.to_rotation_matrix(Delta_q_1)
        Cs = C + C_1
        Ca = _mv(Cs, acc_true_i)
        C_int_1 = C_int + 0.5 * Cs * h
        acc_int_1 = acc_int + 0.5 * Ca * h
        C_dbl_1 = C_dbl + C_int * h + 0.25 * Cs * h * h
        acc_dbl_1 = acc_dbl + acc_int * h + 0.25 * Ca * h * h
        dalpha_1 = dalpha + C_1 @ Jr * h
        cross_1 = Rdq_inv_all[i] @ cross + Jr * h
        mix = C @ acc_x @ cross + C_1 @ acc_x @ cross_1
        dv_1 = dv + 0.5 * h * mix
        dp_1 = dp + h * dv + 0.25 * h * h * mix

        F = torch.eye(15, dtype=dtype, device=device)
        F[0:3, 3:6] = -quat.cross_mx(acc_int * h + 0.25 * Ca * h * h)
        F[0:3, 6:9] = eye3 * h
        F[0:3, 9:12] = h * dv + 0.25 * h * h * mix
        F[0:3, 12:15] = -C_int * h - 0.25 * Cs * h * h
        F[3:6, 9:12] = -h * C_1
        F[6:9, 3:6] = -quat.cross_mx(0.5 * Ca * h)
        F[6:9, 9:12] = 0.5 * h * mix
        F[6:9, 12:15] = -0.5 * Cs * h
        P_1 = F @ P @ F.T + Q_all[i]

        u = use[i]
        Delta_q = torch.where(u, Delta_q_1, Delta_q)
        C_int = torch.where(u, C_int_1, C_int)
        C_dbl = torch.where(u, C_dbl_1, C_dbl)
        acc_int = torch.where(u, acc_int_1, acc_int)
        acc_dbl = torch.where(u, acc_dbl_1, acc_dbl)
        cross = torch.where(u, cross_1, cross)
        dalpha = torch.where(u, dalpha_1, dalpha)
        dv = torch.where(u, dv_1, dv)
        dp = torch.where(u, dp_1, dp)
        P = torch.where(u, P_1, P)
        Delta_t = torch.where(u, Delta_t + h, Delta_t)

    return Preintegral(
        Delta_q=Delta_q,
        C_integral=C_int,
        C_doubleintegral=C_dbl,
        acc_integral=acc_int,
        acc_doubleintegral=acc_dbl,
        dalpha_db_g=dalpha,
        dv_db_g=dv,
        dp_db_g=dp,
        P_delta=0.5 * (P + P.T),
        Delta_t=Delta_t,
        bias_ref=bias,
    )


def sqrt_information(pre: Preintegral) -> torch.Tensor:
    """Square-root information W with Wᵀ W = P_delta⁻¹, as W = L⁻¹ D⁻¹ from
    the Cholesky factor of the diagonally equilibrated covariance (see the
    JAX package for why the equilibration is needed in f32). Broadcasts
    over leading dims; a segment whose covariance does not factor (no IMU
    samples, P = 0) gets a zero whitener, and the caller marks the factor
    invalid."""
    P = pre.P_delta
    d = torch.sqrt(torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1), min=1e-30))
    Pn = P / (d[..., :, None] * d[..., None, :])
    L, info = torch.linalg.cholesky_ex(Pn)
    eye = torch.eye(15, dtype=P.dtype, device=P.device).expand(P.shape)
    W = torch.linalg.solve_triangular(L, eye, upper=False) / d[..., None, :]
    ok = (info == 0)[..., None, None] & torch.isfinite(W)
    return torch.where(ok, W, torch.zeros_like(W))


def propagate(
    T_WS: Transformation,
    speed_and_bias: torch.Tensor,  # (...,9) [v_W, b_g, b_a]
    pre: Preintegral,
    params: ImuParameters,
) -> Tuple[Transformation, torch.Tensor]:
    """Forward state propagation using a preintegral computed at the state's
    own bias, with first-order bias correction."""
    g_W = gravity_vector(params, pre.acc_integral.dtype, pre.acc_integral.device)
    v0 = speed_and_bias[..., :3]
    Dt = pre.Delta_t[..., None]
    C_WS = quat.to_rotation_matrix(T_WS.q)
    db = speed_and_bias[..., 3:9] - pre.bias_ref
    dp = pre.acc_doubleintegral + _mv(pre.dp_db_g, db[..., :3]) - _mv(pre.C_doubleintegral, db[..., 3:6])
    dv = pre.acc_integral + _mv(pre.dv_db_g, db[..., :3]) - _mv(pre.C_integral, db[..., 3:6])
    dq_corr = quat.exp(-_mv(pre.dalpha_db_g, db[..., :3]))
    Dq = quat.multiply(dq_corr, pre.Delta_q)
    r1 = T_WS.r + v0 * Dt - 0.5 * g_W * Dt * Dt + _mv(C_WS, dp)
    v1 = v0 - g_W * Dt + _mv(C_WS, dv)
    q1 = quat.normalize(quat.multiply(T_WS.q, Dq))
    sb1 = torch.cat([v1, speed_and_bias[..., 3:9]], dim=-1)
    return Transformation(r=r1, q=q1), sb1


def error_and_jacobians(
    T_WS_0: Transformation,
    sb0: torch.Tensor,
    T_WS_1: Transformation,
    sb1: torch.Tensor,
    pre: Preintegral,
    params: ImuParameters,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """15-dim IMU factor error + minimal Jacobians F0 (wrt state 0) and F1
    (wrt state 1), both 15x15 over [δp, δα, δv, δb_g, δb_a], unweighted.
    Broadcasts over leading dims."""
    dtype, device = pre.acc_integral.dtype, pre.acc_integral.device
    g_W = gravity_vector(params, dtype, device)
    Dt = pre.Delta_t
    Dt1 = Dt[..., None]
    C_WS_0 = quat.to_rotation_matrix(T_WS_0.q)
    C_S0_W = C_WS_0.transpose(-1, -2)
    v0, v1 = sb0[..., :3], sb1[..., :3]
    Delta_b = sb0[..., 3:9] - pre.bias_ref

    delta_p_est_W = T_WS_0.r - T_WS_1.r + v0 * Dt1 - 0.5 * g_W * Dt1 * Dt1
    delta_v_est_W = v0 - v1 - g_W * Dt1
    Dq = quat.multiply(quat.exp(-_mv(pre.dalpha_db_g, Delta_b[..., :3])), pre.Delta_q)
    q1_inv_q0 = quat.multiply(quat.conjugate(T_WS_1.q), T_WS_0.q)

    e_p = _mv(C_S0_W, delta_p_est_W) + pre.acc_doubleintegral + (
        _mv(pre.dp_db_g, Delta_b[..., :3]) - _mv(pre.C_doubleintegral, Delta_b[..., 3:6])
    )
    e_q = 2.0 * quat.multiply(Dq, q1_inv_q0)[..., :3]
    e_v = _mv(C_S0_W, delta_v_est_W) + pre.acc_integral + (
        _mv(pre.dv_db_g, Delta_b[..., :3]) - _mv(pre.C_integral, Delta_b[..., 3:6])
    )
    e_b = sb0[..., 3:9] - sb1[..., 3:9]
    error = torch.cat([e_p, e_q, e_v, e_b], dim=-1)

    batch = Dt.shape
    eye15 = torch.eye(15, dtype=dtype, device=device)
    F0 = eye15.expand(batch + (15, 15)).clone()
    F0[..., 0:3, 0:3] = C_S0_W
    F0[..., 0:3, 3:6] = C_S0_W @ quat.cross_mx(delta_p_est_W)
    F0[..., 0:3, 6:9] = C_S0_W * Dt[..., None, None]
    F0[..., 0:3, 9:12] = pre.dp_db_g
    F0[..., 0:3, 12:15] = -pre.C_doubleintegral
    F0[..., 3:6, 3:6] = (
        quat.plus_matrix(quat.multiply(Dq, quat.conjugate(T_WS_1.q)))
        @ quat.oplus_matrix(T_WS_0.q)
    )[..., :3, :3]
    F0[..., 3:6, 9:12] = (
        (quat.oplus_matrix(q1_inv_q0) @ quat.oplus_matrix(Dq))[..., :3, :3]
        @ (-pre.dalpha_db_g)
    )
    F0[..., 6:9, 3:6] = C_S0_W @ quat.cross_mx(delta_v_est_W)
    F0[..., 6:9, 6:9] = C_S0_W
    F0[..., 6:9, 9:12] = pre.dv_db_g
    F0[..., 6:9, 12:15] = -pre.C_integral

    F1 = (-eye15).expand(batch + (15, 15)).clone()
    F1[..., 0:3, 0:3] = -C_S0_W
    F1[..., 3:6, 3:6] = -(
        quat.plus_matrix(Dq)
        @ quat.oplus_matrix(T_WS_0.q)
        @ quat.plus_matrix(quat.conjugate(T_WS_1.q))
    )[..., :3, :3]
    F1[..., 6:9, 6:9] = -C_S0_W

    return error, F0, F1
