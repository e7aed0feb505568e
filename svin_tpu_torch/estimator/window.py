"""Fixed-shape sliding-window state and factor containers.

Counterpart of the JAX package's ``estimator/window.py``: a preallocated
structure-of-arrays with validity masks — S state slots, L landmark slots,
O flat observation slots — with the JAX package's field names and layouts.
The JAX ``WindowConfig.unroll`` knob (an XLA scan option) has no
counterpart here.

Minimal coordinates per state: 15 = [δp, δα, δv, δb_g, δb_a].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..imu import Preintegral
from ..kinematics import Transformation


def device_scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor on ``device`` from a Python number (filled on the
    device: no host-to-device copy, so no wait on the stream) or a tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


class WindowConfig(NamedTuple):
    """Static shape/solver configuration."""

    num_states: int = 8  # S: numKeyframes(5) + numImuFrames(3) reference window
    num_landmarks: int = 256  # L landmark slots
    num_obs: int = 2048  # O flat observation slots
    max_iterations: int = 10  # LM iterations
    cauchy_c: float = 1.0  # Cauchy robust-loss scale
    num_cameras: int = 2  # C rig cameras (extrinsics slots in the window)
    estimate_extrinsics: bool = False  # online T_SC calibration

    @property
    def state_dim(self) -> int:
        return self.num_states * 15

    @property
    def full_dim(self) -> int:
        """States + extrinsics minimal dims (S·15 then C·6)."""
        return self.num_states * 15 + self.num_cameras * 6


class WindowState(NamedTuple):
    r: torch.Tensor  # (S,3) p_WS
    q: torch.Tensor  # (S,4) q_WS xyzw
    speed_bias: torch.Tensor  # (S,9) [v_W, b_g, b_a]
    state_valid: torch.Tensor  # (S,) bool
    is_keyframe: torch.Tensor  # (S,) bool
    timestamp: torch.Tensor  # (S,) float seconds
    state_id: torch.Tensor  # (S,) int32 global ids
    hp_W: torch.Tensor  # (L,4) homogeneous, w==1
    lm_valid: torch.Tensor  # (L,) bool
    lm_id: torch.Tensor  # (L,) int32 global ids
    lm_quality: torch.Tensor  # (L,) float
    ext_r: torch.Tensor  # (C,3)
    ext_q: torch.Tensor  # (C,4) xyzw

    def pose(self, idx=None) -> Transformation:
        if idx is None:
            return Transformation(r=self.r, q=self.q)
        return Transformation(r=self.r[idx], q=self.q[idx])

    def T_SC(self, c) -> Transformation:
        return Transformation(r=self.ext_r[c], q=self.ext_q[c])


class ReprojectionFactors(NamedTuple):
    uv: torch.Tensor  # (O,2) measured keypoint [px]
    state_idx: torch.Tensor  # (O,) int32 window slot
    lm_idx: torch.Tensor  # (O,) int32 landmark slot
    cam_idx: torch.Tensor  # (O,) int32 camera index in rig
    sqrt_info: torch.Tensor  # (O,) scalar sqrt information
    valid: torch.Tensor  # (O,) bool


class ImuFactors(NamedTuple):
    pre: Preintegral  # batched (S-1, ...)
    sqrt_info: torch.Tensor  # (S-1,15,15)
    valid: torch.Tensor  # (S-1,) bool


class DepthFactors(NamedTuple):
    """Water-depth factor per state: z_WS ≈ -depth + first_depth."""

    depth: torch.Tensor  # (S,)
    first_depth: torch.Tensor  # ()
    sqrt_info: torch.Tensor  # (S,)
    valid: torch.Tensor  # (S,) bool


class SonarFactors(NamedTuple):
    """Sonar range factor per state: range ≈ ‖r_WS − target_W‖."""

    range: torch.Tensor  # (S,)
    target_W: torch.Tensor  # (S,3)
    sqrt_info: torch.Tensor  # (S,)
    valid: torch.Tensor  # (S,) bool


class PriorFactors(NamedTuple):
    pose_mean_r: torch.Tensor  # (S,3)
    pose_mean_q: torch.Tensor  # (S,4)
    pose_sqrt_info: torch.Tensor  # (S,6,6)
    pose_valid: torch.Tensor  # (S,) bool
    sb_mean: torch.Tensor  # (S,9)
    sb_sqrt_info: torch.Tensor  # (S,9,9)
    sb_valid: torch.Tensor  # (S,) bool


class LandmarkPrior(NamedTuple):
    mean: torch.Tensor  # (L,3)
    sqrt_info: torch.Tensor  # (L,3,3)
    valid: torch.Tensor  # (L,) bool


class ExtrinsicsPrior(NamedTuple):
    mean_r: torch.Tensor  # (C,3)
    mean_q: torch.Tensor  # (C,4)
    sqrt_info: torch.Tensor  # (C,6,6)
    valid: torch.Tensor  # (C,) bool


class MarginalPrior(NamedTuple):
    """Dense FEJ marginal prior over the full minimal state (Dx = S·15 + C·6):
    cost = ½ dmᵀ H dm + bᵀ dm with dm = χ ⊟ χ_lin."""

    H: torch.Tensor  # (Dx,Dx)
    b: torch.Tensor  # (Dx,)
    lin_r: torch.Tensor  # (S,3)
    lin_q: torch.Tensor  # (S,4)
    lin_sb: torch.Tensor  # (S,9)
    lin_ext_r: torch.Tensor  # (C,3)
    lin_ext_q: torch.Tensor  # (C,4)
    valid: torch.Tensor  # () bool


class Factors(NamedTuple):
    reproj: ReprojectionFactors
    imu: ImuFactors
    depth: DepthFactors
    sonar: SonarFactors
    priors: PriorFactors
    ext_prior: ExtrinsicsPrior
    marg: MarginalPrior
    lm_prior: LandmarkPrior


def _unit_q(n: int, dtype, device) -> torch.Tensor:
    q = torch.zeros((n, 4), dtype=dtype, device=device)
    q[:, 3] = 1.0
    return q


def empty_window(cfg: WindowConfig, dtype=torch.float64, rig=None, device=None) -> WindowState:
    """Fresh window. ``rig`` (a RigParams) seeds the extrinsics slots; the
    identity is used otherwise."""
    S, L, C = cfg.num_states, cfg.num_landmarks, cfg.num_cameras
    kw = dict(dtype=dtype, device=device)
    if rig is not None:
        ext_r = rig.T_SC_r[:C].to(**kw).clone()
        ext_q = rig.T_SC_q[:C].to(**kw).clone()
    else:
        ext_r = torch.zeros((C, 3), **kw)
        ext_q = _unit_q(C, dtype, device)
    hp = torch.zeros((L, 4), **kw)
    hp[:, 3] = 1.0
    return WindowState(
        r=torch.zeros((S, 3), **kw),
        q=_unit_q(S, dtype, device),
        speed_bias=torch.zeros((S, 9), **kw),
        state_valid=torch.zeros(S, dtype=torch.bool, device=device),
        is_keyframe=torch.zeros(S, dtype=torch.bool, device=device),
        timestamp=torch.zeros(S, **kw),
        state_id=torch.full((S,), -1, dtype=torch.int32, device=device),
        hp_W=hp,
        lm_valid=torch.zeros(L, dtype=torch.bool, device=device),
        lm_id=torch.full((L,), -1, dtype=torch.int32, device=device),
        lm_quality=torch.zeros(L, **kw),
        ext_r=ext_r,
        ext_q=ext_q,
    )


def empty_factors(cfg: WindowConfig, dtype=torch.float64, device=None) -> Factors:
    S, L, O, C = cfg.num_states, cfg.num_landmarks, cfg.num_obs, cfg.num_cameras
    Dx = cfg.full_dim
    Sm1 = S - 1
    kw = dict(dtype=dtype, device=device)
    bkw = dict(dtype=torch.bool, device=device)
    eye15 = torch.eye(15, **kw)
    pre = Preintegral(
        Delta_q=_unit_q(Sm1, dtype, device),
        C_integral=torch.zeros((Sm1, 3, 3), **kw),
        C_doubleintegral=torch.zeros((Sm1, 3, 3), **kw),
        acc_integral=torch.zeros((Sm1, 3), **kw),
        acc_doubleintegral=torch.zeros((Sm1, 3), **kw),
        dalpha_db_g=torch.zeros((Sm1, 3, 3), **kw),
        dv_db_g=torch.zeros((Sm1, 3, 3), **kw),
        dp_db_g=torch.zeros((Sm1, 3, 3), **kw),
        P_delta=eye15.repeat(Sm1, 1, 1),
        Delta_t=torch.zeros(Sm1, **kw),
        bias_ref=torch.zeros((Sm1, 6), **kw),
    )
    return Factors(
        reproj=ReprojectionFactors(
            uv=torch.zeros((O, 2), **kw),
            state_idx=torch.zeros(O, dtype=torch.int32, device=device),
            lm_idx=torch.zeros(O, dtype=torch.int32, device=device),
            cam_idx=torch.zeros(O, dtype=torch.int32, device=device),
            sqrt_info=torch.ones(O, **kw),
            valid=torch.zeros(O, **bkw),
        ),
        imu=ImuFactors(
            pre=pre,
            sqrt_info=eye15.repeat(Sm1, 1, 1),
            valid=torch.zeros(Sm1, **bkw),
        ),
        depth=DepthFactors(
            depth=torch.zeros(S, **kw),
            first_depth=torch.zeros((), **kw),
            sqrt_info=torch.full((S,), 5.0 ** 0.5, **kw),
            valid=torch.zeros(S, **bkw),
        ),
        sonar=SonarFactors(
            range=torch.zeros(S, **kw),
            target_W=torch.zeros((S, 3), **kw),
            sqrt_info=torch.ones(S, **kw),
            valid=torch.zeros(S, **bkw),
        ),
        priors=PriorFactors(
            pose_mean_r=torch.zeros((S, 3), **kw),
            pose_mean_q=_unit_q(S, dtype, device),
            pose_sqrt_info=torch.zeros((S, 6, 6), **kw),
            pose_valid=torch.zeros(S, **bkw),
            sb_mean=torch.zeros((S, 9), **kw),
            sb_sqrt_info=torch.zeros((S, 9, 9), **kw),
            sb_valid=torch.zeros(S, **bkw),
        ),
        ext_prior=ExtrinsicsPrior(
            mean_r=torch.zeros((C, 3), **kw),
            mean_q=_unit_q(C, dtype, device),
            sqrt_info=torch.zeros((C, 6, 6), **kw),
            valid=torch.zeros(C, **bkw),
        ),
        marg=MarginalPrior(
            H=torch.zeros((Dx, Dx), **kw),
            b=torch.zeros(Dx, **kw),
            lin_r=torch.zeros((S, 3), **kw),
            lin_q=_unit_q(S, dtype, device),
            lin_sb=torch.zeros((S, 9), **kw),
            lin_ext_r=torch.zeros((C, 3), **kw),
            lin_ext_q=_unit_q(C, dtype, device),
            valid=torch.zeros((), **bkw),
        ),
        lm_prior=LandmarkPrior(
            mean=torch.zeros((L, 3), **kw),
            sqrt_info=torch.zeros((L, 3, 3), **kw),
            valid=torch.zeros(L, **bkw),
        ),
    )
