"""Closed-form batched 3x3 linear algebra for the Schur/quality hot path.

Counterpart of the JAX package's ``ops/linalg3.py``: adjugate inverse and the
trigonometric symmetric eigenvalue formula, elementwise over (..., 3, 3).
"""
from __future__ import annotations

import math

import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate-based inverse of (..., 3, 3) matrices. The caller damps
    singular blocks before inverting."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def eigvalsh3x3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending: shift by
    the mean eigenvalue, scale the deviator to unit norm, then
    q + 2p·cos(phi + {0, ±2π/3})."""
    a, b, c = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    d, e, f = A[..., 0, 1], A[..., 1, 2], A[..., 0, 2]
    q = (a + b + c) / 3.0
    da, db, dc = a - q, b - q, c - q
    p2 = (da * da + db * db + dc * dc + 2.0 * (d * d + e * e + f * f)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    B00, B11, B22 = da / safe_p, db / safe_p, dc / safe_p
    B01, B12, B02 = d / safe_p, e / safe_p, f / safe_p
    detB = (
        B00 * (B11 * B22 - B12 * B12)
        - B01 * (B01 * B22 - B12 * B02)
        + B02 * (B01 * B12 - B11 * B02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)  # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3
    lam = torch.stack([e3, e2, e1], dim=-1)
    return torch.where(p[..., None] > 0, lam, q[..., None].expand(lam.shape))
