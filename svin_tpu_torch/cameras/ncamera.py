"""Multi-camera rig: per-camera extrinsics T_SC + geometry.

Counterpart of the JAX package's ``cameras/ncamera.py``: a host-side container
(camera count and models are Python-level); extrinsics are Transformations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch

from ..kinematics import Transformation, compose, inverse, transform_point
from .pinhole import PinholeCamera, back_project, project


@dataclass
class NCameraSystem:
    cameras: List[PinholeCamera] = field(default_factory=list)
    T_SC: List[Transformation] = field(default_factory=list)

    @property
    def num_cameras(self) -> int:
        return len(self.cameras)

    def add_camera(self, T_SC: Transformation, camera: PinholeCamera) -> None:
        self.cameras.append(camera)
        self.T_SC.append(T_SC)

    def T_CiCj(self, i: int, j: int) -> Transformation:
        """Relative transform camera j → camera i."""
        return compose(inverse(self.T_SC[i]), self.T_SC[j])

    def has_overlap(self, i: int, j: int, depth: float = 2.0, grid: int = 8) -> bool:
        """Approximate FOV-overlap check: back-project a grid of pixels from
        camera j at the given depth and test visibility in camera i."""
        if i == j:
            return True
        camj, cami = self.cameras[j], self.cameras[i]
        dtype, device = camj.fu.dtype, camj.fu.device
        us = torch.linspace(0, camj.width - 1, grid, dtype=dtype, device=device)
        vs = torch.linspace(0, camj.height - 1, grid, dtype=dtype, device=device)
        vv, uu = torch.meshgrid(vs, us, indexing="ij")
        uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)
        rays = back_project(camj, uv) * depth
        p_Ci = transform_point(self.T_CiCj(i, j), rays)
        _, valid = project(cami, p_Ci)
        return bool(valid.any())
