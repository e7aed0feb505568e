"""Health monitoring + switching estimator (host numpy; a copy of the JAX
package's ``loopclosure/switching.py`` with poses composed by ``npq``).

The JAX package's module replaces the reference's ``SwitchingEstimator``
(``pose_graph/src/pose_graph/SwitchingEstimator.cpp``): a robust-pose state
machine NOT_INITIALIZED → TRACKING_VIO ⇄ TRACKING_PRIMITIVE that falls back
to the robot's dead-reckoning (primitive) odometry when VIO health degrades
and re-anchors it at switch time; and the per-keyframe ``healthCheck``
(``LoopClosure.cpp:302-353``): minimum tracked keypoints, per-quadrant
coverage, new-keypoint ratio, low-response fraction.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..kinematics import Transformation, npq
from ..pipeline.config import HealthConfig


class TrackingState(enum.Enum):
    NOT_INITIALIZED = 0
    TRACKING_VIO = 1
    TRACKING_PRIMITIVE = 2


@dataclass
class HealthStatus:
    healthy: bool
    reason: str = ""


def check_health(
    cfg: HealthConfig,
    num_tracked: int,
    quadrant_counts: np.ndarray,
    num_new: int,
    response_strengths: np.ndarray,
) -> HealthStatus:
    """The reference's keyframe health gates (SwitchingEstimator.cpp:41-97):
    - tracked keypoints >= min_keypoints
    - enough quadrants populated with >= kps_per_quadrant
    - fraction of NEW (untracked) keypoints < 0.75
    - fraction of weak detector responses < 0.85
    """
    if num_tracked < cfg.min_keypoints:
        return HealthStatus(False, f"tracked {num_tracked} < {cfg.min_keypoints}")
    quad_ok = int(np.sum(np.asarray(quadrant_counts) >= cfg.kps_per_quadrant))
    if quad_ok < 3:
        return HealthStatus(False, f"only {quad_ok} quadrants covered")
    total = num_tracked + num_new
    if total > 0 and num_new / total >= 0.75:
        return HealthStatus(False, f"new-kp ratio {num_new/total:.2f} >= 0.75")
    rs = np.asarray(response_strengths)
    if rs.size > 0:
        weak = float(np.mean(rs < np.median(rs) * 0.1))
        if weak >= 0.85:
            return HealthStatus(False, f"weak-response fraction {weak:.2f}")
    return HealthStatus(True)


def compose(T_AB: Transformation, T_BC: Transformation) -> Transformation:
    r, q = npq.compose_rq(T_AB.r, T_AB.q, T_BC.r, T_BC.q)
    return Transformation(r=r, q=q)


def inverse(T_AB: Transformation) -> Transformation:
    r, q = npq.inverse_rq(T_AB.r, T_AB.q)
    return Transformation(r=r, q=q)


@dataclass
class SwitchingEstimator:
    """Publishes a "robust pose": VIO when healthy, re-anchored primitive
    (dead-reckoning) odometry after sustained failures."""

    cfg: HealthConfig
    state: TrackingState = TrackingState.NOT_INITIALIZED
    failures: int = 0
    successes: int = 0
    # re-anchoring transform applied to primitive poses after a switch
    T_anchor: Optional[Transformation] = None
    last_vio: Optional[Transformation] = None
    last_primitive: Optional[Transformation] = None
    last_vio_time: Optional[float] = None
    switch_log: List[Tuple[float, str]] = field(default_factory=list)

    def add_primitive_pose(self, t: float, T_WB: Transformation) -> None:
        """Feed one dead-reckoning pose. If VIO keyframes have been silent
        for longer than ``keyframe_wait_time`` while primitive odometry
        keeps arriving, switch to the primitive estimator even without an
        unhealthy keyframe (the reference's VIO-silence timeout,
        SwitchingEstimator.cpp:196-214: switch when
        last_primitive_time - last_vio_keyframe_time > kf_wait_time)."""
        self.last_primitive = T_WB
        if (
            self.cfg.enable
            and self.state == TrackingState.TRACKING_VIO
            and self.last_vio_time is not None
            and t - self.last_vio_time > self.cfg.keyframe_wait_time
            and self.last_vio is not None
        ):
            self.T_anchor = compose(self.last_vio, inverse(T_WB))
            self.state = TrackingState.TRACKING_PRIMITIVE
            self.switch_log.append(
                (t, f"VIO->PRIMITIVE (no VIO keyframe for "
                    f"{t - self.last_vio_time:.2f} s)")
            )

    def add_keyframe(
        self, t: float, T_WS_vio: Transformation, health: HealthStatus
    ) -> Transformation:
        """Feed a VIO keyframe + its health; returns the robust pose."""
        self.last_vio = T_WS_vio
        self.last_vio_time = t
        if not self.cfg.enable:
            return T_WS_vio
        if self.state == TrackingState.NOT_INITIALIZED:
            self.state = TrackingState.TRACKING_VIO

        if health.healthy:
            self.successes += 1
            self.failures = 0
        else:
            self.failures += 1
            self.successes = 0

        if (
            self.state == TrackingState.TRACKING_VIO
            and self.failures >= self.cfg.consecutive_keyframes + 3
            and self.last_primitive is not None
        ):
            # switch: anchor primitive into the current robust (VIO) frame
            self.T_anchor = compose(T_WS_vio, inverse(self.last_primitive))
            self.state = TrackingState.TRACKING_PRIMITIVE
            self.switch_log.append((t, f"VIO->PRIMITIVE ({health.reason})"))
        elif (
            self.state == TrackingState.TRACKING_PRIMITIVE
            and self.successes >= self.cfg.consecutive_keyframes
        ):
            self.state = TrackingState.TRACKING_VIO
            self.switch_log.append((t, "PRIMITIVE->VIO"))

        return self.robust_pose()

    def robust_pose(self) -> Transformation:
        if (
            self.state == TrackingState.TRACKING_PRIMITIVE
            and self.T_anchor is not None
            and self.last_primitive is not None
        ):
            return compose(self.T_anchor, self.last_primitive)
        return self.last_vio
