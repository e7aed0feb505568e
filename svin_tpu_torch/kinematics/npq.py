"""NumPy quaternion/SE(3) helpers for HOST-side bookkeeping.

A copy of the JAX package's ``kinematics/npq.py``. The engine's sequencing
logic runs on the host between its device programs; doing its small
quaternion algebra in numpy keeps the per-frame path free of tiny device
launches. Conventions match ``kinematics/quaternion.py`` exactly: xyzw
storage, Hamilton product, C(q) rotates body → world.
"""
from __future__ import annotations

import numpy as np


def normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def conjugate(q: np.ndarray) -> np.ndarray:
    return q * np.asarray([-1.0, -1.0, -1.0, 1.0], q.dtype)


def multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.stack(
        [
            np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            np.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            np.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        axis=-2,
    )


def from_rotation_matrix(C: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion xyzw (Shepperd's method, single matrix)."""
    C = np.asarray(C)
    t = np.trace(C)
    if t > 0:
        w = 0.5 * np.sqrt(1.0 + t)
        f = 0.25 / w
        q = np.array(
            [
                (C[2, 1] - C[1, 2]) * f,
                (C[0, 2] - C[2, 0]) * f,
                (C[1, 0] - C[0, 1]) * f,
                w,
            ]
        )
    else:
        i = int(np.argmax(np.diag(C)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(C[i, i] - C[j, j] - C[k, k] + 1.0, 1e-12))
        q = np.zeros(4)
        q[i] = 0.5 * s
        f = 0.5 / s
        q[3] = (C[k, j] - C[j, k]) * f
        q[j] = (C[j, i] + C[i, j]) * f
        q[k] = (C[k, i] + C[i, k]) * f
    return normalize(q)


def rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) v (...,3) by quaternion q."""
    return np.einsum("...ij,...j->...i", to_rotation_matrix(q), v)


def compose_rq(r1, q1, r2, q2):
    """T1 ∘ T2 as (r, q) arrays."""
    return rotate(q1, np.asarray(r2)) + np.asarray(r1), normalize(
        multiply(np.asarray(q1), np.asarray(q2))
    )


def inverse_rq(r, q):
    qi = conjugate(np.asarray(q))
    return -rotate(qi, np.asarray(r)), qi


def transform_point_rq(r, q, p):
    return rotate(np.asarray(q), np.asarray(p)) + np.asarray(r)
