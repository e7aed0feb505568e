"""Lens distortion models as pure functions on normalized image coordinates.

Counterpart of the JAX package's ``cameras/distortion.py``: each model is a
(distort, Jacobian) pair on (..., 2) normalized coordinates with a parameter
vector; undistortion is a fixed-count Gauss-Newton loop. The JAX package
takes the 2x2 Jacobians by forward-mode autodiff; here they are derived
analytically (no autograd in the port).

Model names match the reference YAML ``distortion_type`` strings.
"""
from __future__ import annotations

import torch

UNDISTORT_ITERS = 8

NUM_PARAMS = {"none": 0, "radialtangential": 4, "radialtangential8": 8, "equidistant": 4}


def _radial_radtan(r2, params):
    """radial factor and d radial / d r2 for radialtangential."""
    k1, k2 = params[..., 0], params[..., 1]
    return 1.0 + k1 * r2 + k2 * r2 * r2, k1 + 2.0 * k2 * r2


def _radial_radtan8(r2, params):
    """radial factor and d radial / d r2 for radialtangential8:
    params = [k1, k2, p1, p2, k3, k4, k5, k6]."""
    k1, k2, k3 = params[..., 0], params[..., 1], params[..., 4]
    k4, k5, k6 = params[..., 5], params[..., 6], params[..., 7]
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    dnum = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4
    dden = k4 + 2.0 * k5 * r2 + 3.0 * k6 * r4
    return num / den, (dnum * den - num * dden) / (den * den)


def _radtan_family(p, params, radial_fn, want_jac):
    x, y = p[..., 0], p[..., 1]
    p1, p2 = params[..., 2], params[..., 3]
    r2 = x * x + y * y
    radial, drad = radial_fn(r2, params)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    out = torch.stack([xd, yd], dim=-1)
    if not want_jac:
        return out
    gx = 2.0 * x * drad  # d radial / dx
    gy = 2.0 * y * drad
    j00 = radial + x * gx + 2.0 * p1 * y + 6.0 * p2 * x
    j01 = x * gy + 2.0 * p1 * x + 2.0 * p2 * y
    j10 = y * gx + 2.0 * p1 * x + 2.0 * p2 * y
    j11 = radial + y * gy + 6.0 * p1 * y + 2.0 * p2 * x
    J = torch.stack([torch.stack([j00, j01], -1), torch.stack([j10, j11], -1)], -2)
    return out, J


def _equidistant(p, params, want_jac):
    """equidistant (fisheye): params = [k1, k2, k3, k4]."""
    k1, k2, k3, k4 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-16))
    theta = torch.atan(r)
    t2 = theta * theta
    poly = 1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4
    theta_d = theta * poly
    scale = theta_d / r
    out = torch.stack([x * scale, y * scale], dim=-1)
    if not want_jac:
        return out
    dthd_dth = 1.0 + 3.0 * k1 * t2 + 5.0 * k2 * t2**2 + 7.0 * k3 * t2**3 + 9.0 * k4 * t2**4
    dthd_dr = dthd_dth / (1.0 + r * r)
    dscale_dr = (dthd_dr * r - theta_d) / (r * r)
    live = r2 > 1e-16  # the clamp's derivative is zero below the floor
    drdx = torch.where(live, x / r, torch.zeros_like(x))
    drdy = torch.where(live, y / r, torch.zeros_like(y))
    j00 = scale + x * dscale_dr * drdx
    j01 = x * dscale_dr * drdy
    j10 = y * dscale_dr * drdx
    j11 = scale + y * dscale_dr * drdy
    J = torch.stack([torch.stack([j00, j01], -1), torch.stack([j10, j11], -1)], -2)
    return out, J


def _eval(model: str, p, params, want_jac: bool):
    if model == "none":
        if not want_jac:
            return p
        eye = torch.eye(2, dtype=p.dtype, device=p.device)
        return p, eye.expand(p.shape[:-1] + (2, 2))
    if model == "radialtangential":
        return _radtan_family(p, params, _radial_radtan, want_jac)
    if model == "radialtangential8":
        return _radtan_family(p, params, _radial_radtan8, want_jac)
    if model == "equidistant":
        return _equidistant(p, params, want_jac)
    raise ValueError(f"unknown distortion model {model!r}")


def distort(model: str, p: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Distort (..., 2) normalized points. ``params`` is (P,) or batched
    (..., P) broadcasting against the points' leading dims."""
    return _eval(model, p, params, want_jac=False)


def distort_jacobian(model: str, p: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """d(distorted)/d(undistorted), shape (..., 2, 2)."""
    return _eval(model, p, params, want_jac=True)[1]


def undistort(model: str, pd: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Invert distortion by fixed-iteration Gauss-Newton (2x2 solve per
    point), UNDISTORT_ITERS steps from the distorted point."""
    if model == "none":
        return pd
    u = pd
    for _ in range(UNDISTORT_ITERS):
        f, J = _eval(model, u, params, want_jac=True)
        res = f - pd
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        dx = (J[..., 1, 1] * res[..., 0] - J[..., 0, 1] * res[..., 1]) / det
        dy = (-J[..., 1, 0] * res[..., 0] + J[..., 0, 0] * res[..., 1]) / det
        u = u - torch.stack([dx, dy], dim=-1)
    return u
