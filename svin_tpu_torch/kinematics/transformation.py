"""SE(3) transformations as (r, q) tensor pairs with minimal-coords calculus.

Counterpart of the JAX package's ``kinematics/transformation.py``: a transformation
T_AB is a NamedTuple of ``r`` (position of frame B's origin in A, (..., 3))
and ``q`` (Hamilton quaternion xyzw rotating B-vectors into A, (..., 4)).

Minimal perturbation: T ⊞ δ = (r + δ_p, exp(δ_α) ⊗ q), δ = [δ_p, δ_α].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import quaternion as quat


class Transformation(NamedTuple):
    r: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4) xyzw

    @property
    def C(self) -> torch.Tensor:
        return quat.to_rotation_matrix(self.q)


def identity(batch: tuple = (), dtype=torch.float64, device=None) -> Transformation:
    return Transformation(
        r=torch.zeros(batch + (3,), dtype=dtype, device=device),
        q=quat.identity(dtype, device).expand(batch + (4,)).clone(),
    )


def from_matrix(T, dtype=torch.float64, device=None) -> Transformation:
    """(..., 4, 4) homogeneous matrix → Transformation."""
    T = torch.as_tensor(T, dtype=dtype, device=device)
    return Transformation(r=T[..., :3, 3], q=quat.from_rotation_matrix(T[..., :3, :3]))


def from_rq(r, q, dtype=torch.float64, device=None) -> Transformation:
    return Transformation(
        r=torch.as_tensor(r, dtype=dtype, device=device),
        q=quat.normalize(torch.as_tensor(q, dtype=dtype, device=device)),
    )


def compose(T_AB: Transformation, T_BC: Transformation) -> Transformation:
    """T_AC = T_AB * T_BC."""
    return Transformation(
        r=quat.rotate(T_AB.q, T_BC.r) + T_AB.r,
        q=quat.normalize(quat.multiply(T_AB.q, T_BC.q)),
    )


def inverse(T_AB: Transformation) -> Transformation:
    q_inv = quat.conjugate(T_AB.q)
    return Transformation(r=-quat.rotate(q_inv, T_AB.r), q=q_inv)


def transform_point(T_AB: Transformation, p_B: torch.Tensor) -> torch.Tensor:
    """Apply to 3D point(s): p_A = C_AB p_B + r_AB."""
    return quat.rotate(T_AB.q, p_B) + T_AB.r


def oplus(T: Transformation, delta: torch.Tensor) -> Transformation:
    """Minimal-coordinates retraction, delta shape (..., 6) = [dp, dalpha]."""
    dq = quat.exp(delta[..., 3:6])
    return Transformation(
        r=T.r + delta[..., :3],
        q=quat.normalize(quat.multiply(dq, T.q)),
    )


def ominus(T_a: Transformation, T_b: Transformation) -> torch.Tensor:
    """Local coordinates of T_a around T_b: delta s.t. oplus(T_b, delta) ≈ T_a."""
    dq = quat.multiply(T_a.q, quat.conjugate(T_b.q))
    return torch.cat([T_a.r - T_b.r, quat.log(dq)], dim=-1)
