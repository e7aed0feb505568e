"""Pinhole camera with pluggable distortion — project / back-project +
Jacobians.

Counterpart of the JAX package's ``cameras/pinhole.py``. A camera is a NamedTuple of
intrinsics tensors; they may carry leading batch dims (one camera per
observation, or (C, 1) for C cameras against (C, N) points), and then
``dist_params`` is (..., P) with the same leading dims. Projection validity
is a mask: points behind the camera are invalid with finite output.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import distortion as dist


class PinholeCamera(NamedTuple):
    fu: torch.Tensor
    fv: torch.Tensor
    cu: torch.Tensor
    cv: torch.Tensor
    dist_params: torch.Tensor  # (..., P)
    width: int
    height: int
    model: str = "radialtangential"


def make_camera(width, height, fu, fv, cu, cv, dist_params=None,
                model="radialtangential", dtype=torch.float64,
                device=None) -> PinholeCamera:
    """Intrinsics are rounded through float32 as in the JAX package's
    ``make_camera``, so both packages hold the same camera."""
    if dist_params is None:
        dist_params = [0.0] * (dist.NUM_PARAMS[model] or 1)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32).to(dtype=dtype, device=device)

    return PinholeCamera(
        fu=f32(fu), fv=f32(fv), cu=f32(cu), cv=f32(cv),
        dist_params=f32(dist_params),
        width=int(width), height=int(height), model=model,
    )


MIN_DEPTH = 1e-6


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < MIN_DEPTH, torch.full_like(z, MIN_DEPTH), z)


def project(cam: PinholeCamera, p_C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project 3D camera-frame point(s) (..., 3) → pixel (..., 2), valid mask.

    Valid ⇔ depth > 0 and pixel inside the image. Invalid points still
    produce finite output (clamped depth)."""
    z = p_C[..., 2]
    un = p_C[..., :2] / _safe_z(z)[..., None]
    d = dist.distort(cam.model, un, cam.dist_params)
    uv = torch.stack(
        [cam.fu * d[..., 0] + cam.cu, cam.fv * d[..., 1] + cam.cv], dim=-1
    )
    in_image = (
        (uv[..., 0] >= 0.0)
        & (uv[..., 0] <= cam.width - 1)
        & (uv[..., 1] >= 0.0)
        & (uv[..., 1] <= cam.height - 1)
    )
    valid = (z > MIN_DEPTH) & in_image
    return uv, valid


def project_jacobian(cam: PinholeCamera, p_C: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(point), shape (..., 2, 3):
    J = diag(fu,fv) @ J_dist @ [1/z, 0, -x/z²; 0, 1/z, -y/z²]."""
    x, y, z = p_C[..., 0], p_C[..., 1], p_C[..., 2]
    rz = 1.0 / _safe_z(z)
    un = torch.stack([x * rz, y * rz], dim=-1)
    Jd = dist.distort_jacobian(cam.model, un, cam.dist_params)
    zero = torch.zeros_like(rz)
    J_norm = torch.stack(
        [
            torch.stack([rz, zero, -x * rz * rz], dim=-1),
            torch.stack([zero, rz, -y * rz * rz], dim=-1),
        ],
        dim=-2,
    )
    Jdn = Jd @ J_norm
    f = torch.stack(torch.broadcast_tensors(cam.fu, cam.fv), dim=-1)
    return f[..., :, None] * Jdn


def back_project(cam: PinholeCamera, uv: torch.Tensor) -> torch.Tensor:
    """Pixel(s) (..., 2) → unit-norm bearing vector(s) (..., 3)."""
    d = torch.stack(
        [(uv[..., 0] - cam.cu) / cam.fu, (uv[..., 1] - cam.cv) / cam.fv], dim=-1
    )
    un = dist.undistort(cam.model, d, cam.dist_params)
    ray = torch.cat([un, torch.ones_like(un[..., :1])], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
