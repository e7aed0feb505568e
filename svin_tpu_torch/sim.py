"""Synthetic trajectory + sensor simulation for tests and the chip check.

Counterpart of the JAX package's ``sim.py``: a smooth closed-form trajectory whose
velocity, angular rate and specific force are exact. The JAX package takes
the time derivatives by forward-mode autodiff; here they are written out
analytically. Random draws come from an explicit ``numpy.random.Generator``.

World convention: gravity g_W = +g ẑ enters propagation as v̇ = -g_W + C_WS f
(the accelerometer measures f = C_SW (v̇_W + g_W)).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .imu import ImuParameters, gravity_vector
from .kinematics import Transformation, quaternion as quat


class Trajectory(NamedTuple):
    """Analytic trajectory coefficients; ``ramp_tau`` > 0 applies a C2
    smoothstep start-from-rest envelope."""

    r_amp: torch.Tensor  # (3,)
    r_freq: torch.Tensor  # (3,)
    r_lin: torch.Tensor  # (3,) linear velocity component
    w_amp: torch.Tensor  # (3,) orientation oscillation amplitude [rad]
    w_freq: torch.Tensor  # (3,)
    ramp_tau: float = 0.0


def default_trajectory(scale: float = 1.0, ramp_tau: float = 0.0,
                       dtype=torch.float64, device=None) -> Trajectory:
    def vec(v):
        return torch.tensor(v, dtype=dtype, device=device)

    two_pi = 2 * math.pi
    return Trajectory(
        r_amp=vec([1.0, 0.8, 0.4]) * scale,
        r_freq=vec([0.4, 0.3, 0.5]) * two_pi,
        r_lin=vec([0.15, 0.1, 0.0]) * scale,
        w_amp=vec([0.2, 0.25, 0.3]),
        w_freq=vec([0.3, 0.4, 0.2]) * two_pi,
        ramp_tau=ramp_tau,
    )


def _envelope(traj: Trajectory, t: torch.Tensor):
    """Envelope e(t) and its first two time derivatives, each (..., 1)."""
    t = t[..., None]
    if traj.ramp_tau <= 0.0:
        one = torch.ones_like(t)
        return one, torch.zeros_like(t), torch.zeros_like(t)
    x = t / traj.ramp_tau
    s = torch.clamp(x, 0.0, 1.0)
    inside = ((x > 0.0) & (x < 1.0)).to(t.dtype)
    e = s * s * s * (s * (6.0 * s - 15.0) + 10.0)
    de = inside * 30.0 * s * s * (s - 1.0) ** 2 / traj.ramp_tau
    dde = inside * (120.0 * s**3 - 180.0 * s**2 + 60.0 * s) / traj.ramp_tau**2
    return e, de, dde


def _pos_terms(traj: Trajectory, t: torch.Tensor):
    tt = t[..., None]
    arg = traj.r_freq * tt
    f = traj.r_amp * torch.sin(arg) + traj.r_lin * tt
    df = traj.r_amp * traj.r_freq * torch.cos(arg) + traj.r_lin
    ddf = -traj.r_amp * traj.r_freq**2 * torch.sin(arg)
    return f, df, ddf


def position(traj: Trajectory, t: torch.Tensor) -> torch.Tensor:
    e, _, _ = _envelope(traj, t)
    f, _, _ = _pos_terms(traj, t)
    return e * f


def velocity(traj: Trajectory, t: torch.Tensor) -> torch.Tensor:
    e, de, _ = _envelope(traj, t)
    f, df, _ = _pos_terms(traj, t)
    return de * f + e * df


def acceleration(traj: Trajectory, t: torch.Tensor) -> torch.Tensor:
    e, de, dde = _envelope(traj, t)
    f, df, ddf = _pos_terms(traj, t)
    return dde * f + 2.0 * de * df + e * ddf


def _rotvec_and_rate(traj: Trajectory, t: torch.Tensor):
    e, de, _ = _envelope(traj, t)
    arg = traj.w_freq * t[..., None]
    g = traj.w_amp * torch.sin(arg)
    dg = traj.w_amp * traj.w_freq * torch.cos(arg)
    return e * g, de * g + e * dg


def rotvec(traj: Trajectory, t: torch.Tensor) -> torch.Tensor:
    return _rotvec_and_rate(traj, t)[0]


def pose(traj: Trajectory, t: torch.Tensor) -> Transformation:
    return Transformation(r=position(traj, t), q=quat.exp(rotvec(traj, t)))


def _exp_rate(phi: torch.Tensor, dphi: torch.Tensor) -> torch.Tensor:
    """d/dt quat.exp(phi(t)) given phi and its time derivative (the same
    branches as ``quat.exp``)."""
    angle2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    dangle2 = 2.0 * torch.sum(phi * dphi, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle2, min=1e-12))
    dangle = torch.where(angle2 > 1e-12, dangle2 / (2.0 * angle), torch.zeros_like(angle))
    half = 0.5 * angle
    small = angle2 < 1e-10
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    dk = torch.where(
        small, -dangle2 / 48.0,
        (0.5 * torch.cos(half) * angle - torch.sin(half)) * dangle / (angle * angle),
    )
    dw = torch.where(small, -dangle2 / 8.0, -0.5 * torch.sin(half) * dangle)
    return torch.cat([dphi * k + phi * dk, dw], dim=-1)


def angular_velocity_body(traj: Trajectory, t: torch.Tensor) -> torch.Tensor:
    """ω_S such that q̇ = 0.5 q ⊗ [ω_S, 0]."""
    phi, dphi = _rotvec_and_rate(traj, t)
    q = quat.exp(phi)
    qdot = _exp_rate(phi, dphi)
    return 2.0 * quat.multiply(quat.conjugate(q), qdot)[..., :3]


def specific_force_body(traj: Trajectory, t: torch.Tensor, params: ImuParameters) -> torch.Tensor:
    a_W = acceleration(traj, t)
    C_SW = quat.to_rotation_matrix(quat.exp(rotvec(traj, t))).transpose(-1, -2)
    g = gravity_vector(params, a_W.dtype, a_W.device)
    return (C_SW @ (a_W + g)[..., None])[..., 0]


class ImuSeries(NamedTuple):
    t: torch.Tensor  # (N,)
    gyro: torch.Tensor  # (N,3)
    acc: torch.Tensor  # (N,3)


def simulate_imu(
    traj: Trajectory,
    t_start: float,
    t_end: float,
    rate: float,
    params: ImuParameters,
    rng: np.random.Generator = None,
    noisy: bool = False,
) -> ImuSeries:
    """Samples at ``rate`` over [t_start, t_end]; with ``noisy`` and an
    ``rng``, white noise of discrete sigma sigma_c·sqrt(rate)."""
    dtype, device = traj.r_amp.dtype, traj.r_amp.device
    n = int(round((t_end - t_start) * rate)) + 1
    ts = t_start + torch.arange(n, dtype=dtype, device=device) / rate
    gyro = angular_velocity_body(traj, ts)
    acc = specific_force_body(traj, ts, params)
    if noisy and rng is not None:
        def noise(sigma_c):
            x = rng.standard_normal((n, 3))
            return sigma_c * math.sqrt(rate) * torch.as_tensor(x, dtype=dtype, device=device)

        gyro = gyro + noise(params.sigma_g_c)
        acc = acc + noise(params.sigma_a_c)
    return ImuSeries(t=ts, gyro=gyro, acc=acc)


def landmark_grid(rng: np.random.Generator, n: int, center: torch.Tensor,
                  extent: torch.Tensor) -> torch.Tensor:
    """Uniform random landmarks in a box."""
    u = torch.as_tensor(rng.uniform(size=(n, 3)), dtype=center.dtype, device=center.device)
    return center + (u - 0.5) * extent
