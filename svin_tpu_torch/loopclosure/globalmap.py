"""Global colored point-cloud map with loop-closure re-projection (host
numpy; a copy of the JAX package's ``loopclosure/globalmap.py``).

Replaces ``GlobalMap``/``GlobalMapping``
(``pose_graph/src/pose_graph/GlobalMapping.cpp``, ``LoopClosure.cpp:219-290``
addPointsToGlobalMap/updateGlobalMap): landmarks keyed by id with per-
keyframe observations stored in LOCAL keyframe coordinates, so after a
pose-graph correction every landmark is re-projected through the corrected
keyframe poses (quality-weighted average over its observations). PLY export
mirrors the ``save_pointcloud`` service.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kinematics import Transformation, npq


@dataclass
class Observation:
    kf_index: int
    local_pos: np.ndarray  # (3,) point in keyframe (camera) coordinates
    quality: float
    color: float  # grayscale intensity [0,1]


@dataclass
class Landmark:
    point: np.ndarray  # (3,) current world estimate
    color: float
    quality: float
    observations: List[Observation] = field(default_factory=list)


class GlobalMap:
    def __init__(self, min_quality: float = 0.01):
        self.landmarks: Dict[int, Landmark] = {}
        self.min_quality = min_quality

    def add_observations(
        self,
        kf_index: int,
        T_WC: Transformation,
        point_ids: np.ndarray,
        points_W: np.ndarray,
        qualities: np.ndarray,
        colors: Optional[np.ndarray] = None,
    ) -> None:
        C_CW = npq.to_rotation_matrix(npq.conjugate(np.asarray(T_WC.q)))
        r = np.asarray(T_WC.r)
        for k, lid in enumerate(np.asarray(point_ids)):
            q = float(qualities[k])
            if q < self.min_quality:
                continue
            p_W = np.asarray(points_W[k], float)
            col = float(colors[k]) if colors is not None else 0.5
            local = C_CW @ (p_W - r)
            obs = Observation(kf_index=int(kf_index), local_pos=local, quality=q, color=col)
            lm = self.landmarks.get(int(lid))
            if lm is None:
                self.landmarks[int(lid)] = Landmark(
                    point=p_W, color=col, quality=q, observations=[obs]
                )
            else:
                lm.observations.append(obs)
                if q > lm.quality:
                    lm.quality = q
                    lm.point = p_W

    def update_after_loop(self, kf_poses: Dict[int, Transformation]) -> int:
        """Re-project all landmarks through corrected keyframe poses
        (quality-weighted mean over observations — LoopClosure.cpp:251-290)."""
        n = 0
        for lm in self.landmarks.values():
            acc = np.zeros(3)
            wsum = 0.0
            for obs in lm.observations:
                T = kf_poses.get(obs.kf_index)
                if T is None:
                    continue
                C = npq.to_rotation_matrix(np.asarray(T.q))
                p_W = C @ obs.local_pos + np.asarray(T.r)
                acc += obs.quality * p_W
                wsum += obs.quality
            if wsum > 0:
                lm.point = acc / wsum
                n += 1
        return n

    def point_cloud(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self.landmarks:
            return np.zeros((0, 3)), np.zeros((0,))
        pts = np.stack([lm.point for lm in self.landmarks.values()])
        cols = np.array([lm.color for lm in self.landmarks.values()])
        return pts, cols

    def save_ply(self, path: str) -> None:
        pts, cols = self.point_cloud()
        with open(path, "w") as f:
            f.write(
                "ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n"
            )
            for p, c in zip(pts, cols):
                g = int(np.clip(c * 255, 0, 255))
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {g} {g} {g}\n")
