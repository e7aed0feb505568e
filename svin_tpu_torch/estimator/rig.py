"""Device-side camera-rig parameters: stacked per-camera tensors.

Counterpart of the JAX package's ``estimator/rig.py``. All cameras of a rig share one
distortion model.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras import NCameraSystem, PinholeCamera
from ..kinematics import Transformation


class RigParams(NamedTuple):
    T_SC_r: torch.Tensor  # (NC,3)
    T_SC_q: torch.Tensor  # (NC,4)
    fu: torch.Tensor  # (NC,)
    fv: torch.Tensor
    cu: torch.Tensor
    cv: torch.Tensor
    dist: torch.Tensor  # (NC,P)
    width: int
    height: int
    model: str

    @property
    def num_cameras(self) -> int:
        return self.T_SC_r.shape[0]

    def camera(self, c) -> PinholeCamera:
        """Camera with indexed intrinsics; ``c`` may be an index tensor (one
        camera per element, intrinsics gain its shape)."""
        return PinholeCamera(
            fu=self.fu[c], fv=self.fv[c], cu=self.cu[c], cv=self.cv[c],
            dist_params=self.dist[c], width=self.width, height=self.height,
            model=self.model,
        )

    def T_SC(self, c) -> Transformation:
        return Transformation(r=self.T_SC_r[c], q=self.T_SC_q[c])


def rig_params(rig: NCameraSystem, dtype=torch.float64, device=None) -> RigParams:
    models = {c.model for c in rig.cameras}
    if len(models) != 1:
        raise ValueError(f"rig cameras must share a distortion model, got {models}")
    kw = dict(dtype=dtype, device=device)
    return RigParams(
        T_SC_r=torch.stack([T.r for T in rig.T_SC]).to(**kw),
        T_SC_q=torch.stack([T.q for T in rig.T_SC]).to(**kw),
        fu=torch.stack([c.fu for c in rig.cameras]).to(**kw),
        fv=torch.stack([c.fv for c in rig.cameras]).to(**kw),
        cu=torch.stack([c.cu for c in rig.cameras]).to(**kw),
        cv=torch.stack([c.cv for c in rig.cameras]).to(**kw),
        dist=torch.stack([c.dist_params for c in rig.cameras]).to(**kw),
        width=rig.cameras[0].width,
        height=rig.cameras[0].height,
        model=rig.cameras[0].model,
    )
