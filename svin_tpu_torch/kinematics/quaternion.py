"""Hamilton quaternion algebra on tensors.

Quaternions are stored as ``[x, y, z, w]`` (scalar last), as in the JAX
package's ``kinematics/quaternion.py``. All functions broadcast over leading
batch dimensions.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def identity(dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 (rotation composition: R(q1) @ R(q2))."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting leading dims."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q: R(q) @ v."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix C(q), shape (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def exp(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential: rotation vector (..., 3) → quaternion, Taylor-safe
    at phi → 0."""
    angle2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle2, min=_EPS))
    half = 0.5 * angle
    small = angle2 < 1e-10
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(half))
    return torch.cat([phi * k, w], dim=-1)


def log(q: torch.Tensor) -> torch.Tensor:
    """SO(3) log: quaternion → rotation vector (..., 3). Taylor-safe."""
    qv = q[..., :3]
    qw = q[..., 3]
    sgn = torch.where(qw < 0, -1.0, 1.0).to(q.dtype)
    qv = qv * sgn[..., None]
    qw = qw * sgn
    n2 = torch.sum(qv * qv, dim=-1)
    n = torch.sqrt(torch.clamp(n2, min=_EPS * _EPS))
    angle = 2.0 * torch.atan2(n, qw)
    small = n2 < 1e-14
    k = torch.where(small, 2.0 / torch.clamp(qw, min=1e-7), angle / n)
    return qv * k[..., None]


def cross_mx(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix [v]_x, shape (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zeros = torch.zeros_like(x)
    m = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def plus_matrix(q: torch.Tensor) -> torch.Tensor:
    """Left-multiplication matrix: multiply(q, p) == plus_matrix(q) @ p."""
    x, y, z, w = q.unbind(-1)
    m = torch.stack(
        [
            w, -z, y, x,
            z, w, -x, y,
            -y, x, w, z,
            -x, -y, -z, w,
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (4, 4))


def oplus_matrix(q: torch.Tensor) -> torch.Tensor:
    """Right-multiplication matrix: multiply(p, q) == oplus_matrix(q) @ p."""
    x, y, z, w = q.unbind(-1)
    m = torch.stack(
        [
            w, z, -y, x,
            -z, w, x, y,
            y, -x, w, z,
            -x, -y, -z, w,
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (4, 4))


def right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian J_r(phi), shape (..., 3, 3). Taylor-safe."""
    angle2 = torch.sum(phi * phi, dim=-1)
    angle = torch.sqrt(torch.clamp(angle2, min=_EPS))
    px = cross_mx(phi)
    px2 = px @ px
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(px.shape)
    small = angle2 < 1e-10
    a = torch.where(
        small, 0.5 - angle2 / 24.0,
        (1 - torch.cos(angle)) / torch.clamp(angle2, min=_EPS),
    )
    b = torch.where(
        small,
        1.0 / 6.0 - angle2 / 120.0,
        (angle - torch.sin(angle)) / torch.clamp(angle2 * angle, min=_EPS),
    )
    return eye - a[..., None, None] * px + b[..., None, None] * px2
