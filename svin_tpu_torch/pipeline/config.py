"""Configuration: one structured config for VIO and pose-graph stages,
able to ingest the reference's OpenCV-YAML rig files directly.

Counterpart of the JAX package's ``pipeline/config.py`` (the same fields,
defaults and YAML keys); ``build_rig`` takes the rig's dtype and device.

Replaces ``okvis::VioParametersReader``
(``okvis_common/src/VioParametersReader.cpp``, SVIn keys at :266-303) and
pose_graph ``Parameters`` (``pose_graph/src/pose_graph/Parameters.cpp``):
both ends read the *same* file here, eliminating the reference's duplicated
config pitfall. Field names match the reference YAMLs (e.g.
``config_stereorig_v2.yaml``, ``config_fpga_p2_euroc.yaml``) so existing rig
configs load unchanged, including resizeFactor intrinsic rescaling.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import yaml

import torch

from ..cameras import NCameraSystem, make_camera
from ..imu import ImuParameters
from ..kinematics import Transformation, from_matrix


@dataclass
class CameraConfig:
    T_SC: np.ndarray  # (4,4)
    width: int
    height: int
    focal: List[float]
    principal: List[float]
    distortion: List[float]
    distortion_type: str


@dataclass
class LoopClosureConfig:
    enable: bool = True
    min_correspondences: int = 25
    pnp_reprojection_threshold: float = 20.0
    pnp_ransac_iterations: int = 100
    keyframe_queue: int = 5
    # loop acceptance gates — reference hardcodes |rel yaw| < 25 deg and
    # ||rel t|| < 15 m (pose_graph/src/pose_graph/Keyframe.cpp:501)
    max_yaw_diff: float = 25.0
    max_position_diff: float = 15.0
    # "4dof" (yaw+XYZ, the reference's default optimize4DoFPoseGraph) or
    # "6dof" (full SE(3), optimize6DoFPoseGraph, PoseGraph.cpp:387-543)
    pgo_mode: str = "4dof"
    # path to a trained vocabulary (save_vocabulary format) — the analog of
    # the reference's <share>/Vocabulary/brief_k10L6.bin (Parameters.cpp:40-45);
    # empty = built-in deterministic codebook
    vocabulary_file: str = ""


@dataclass
class HealthConfig:
    enable: bool = False
    min_keypoints: int = 15
    consecutive_keyframes: int = 3
    keyframe_wait_time: float = 2.0
    kps_per_quadrant: int = 1


@dataclass
class GlobalMapConfig:
    enable: bool = True
    min_landmark_quality: float = 0.01


@dataclass
class VioConfig:
    cameras: List[CameraConfig] = field(default_factory=list)
    imu: ImuParameters = field(default_factory=ImuParameters)
    T_BS: np.ndarray = field(default_factory=lambda: np.eye(4))
    T_SSo: np.ndarray = field(default_factory=lambda: np.eye(4))  # sonar
    camera_rate: float = 20.0
    num_keyframes: int = 5
    num_imu_frames: int = 3
    min_iterations: int = 3
    max_iterations: int = 10
    time_limit: float = 0.035
    detection_threshold: float = 40.0
    detection_octaves: int = 0
    max_keypoints: int = 400
    image_delay: float = 0.0
    # online extrinsics calibration (reference camera_params:
    # sigma_absolute_translation/orientation — 0.0 keeps T_SC constant,
    # > 0 estimates it with an absolute pose prior, Estimator.cpp:205-345)
    sigma_absolute_translation: float = 0.0
    sigma_absolute_orientation: float = 0.0
    # extrinsics random walk between frames (reference sigma_c_relative_*:
    # per-state T_SC blocks chained by RelativePoseError). Re-expressed on
    # the shared block as per-frame prior re-centering + information decay.
    sigma_c_relative_translation: float = 0.0
    sigma_c_relative_orientation: float = 0.0
    is_sonar_used: bool = False
    is_depth_used: bool = False
    histogram_method: str = "NONE"
    # reference CLAHE defaults when histogramMethod==CLAHE and the keys
    # are absent: clip 5.0, tiles 8 (VioParametersReader.cpp:287-288)
    clahe_clip_limit: float = 5.0
    clahe_tiles: int = 8
    resize_factor: float = 1.0
    timestamp_tolerance: float = 0.005
    # immediate single-loop drift re-anchoring (reference Parameters.cpp:128,
    # PoseGraph::updateKeyFrameLoop fast path)
    fast_relocalization: bool = False
    # output_params (reference pose_graph Parameters.cpp:73-92): default
    # output directory + debug-artifact mode (loop_candidates/… dirs)
    output_dir: str = ""
    debug_mode: bool = False
    loop_closure: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    health: HealthConfig = field(default_factory=HealthConfig)
    global_map: GlobalMapConfig = field(default_factory=GlobalMapConfig)

    def build_rig(self, dtype=torch.float64, device=None) -> NCameraSystem:
        """NCameraSystem with resizeFactor applied to intrinsics
        (VioParametersReader rescale semantics), its tensors in ``dtype``
        on ``device``."""
        rig = NCameraSystem()
        rf = self.resize_factor
        for c in self.cameras:
            cam = make_camera(
                int(round(c.width * rf)),
                int(round(c.height * rf)),
                c.focal[0] * rf,
                c.focal[1] * rf,
                c.principal[0] * rf,
                c.principal[1] * rf,
                dist_params=c.distortion,
                model=c.distortion_type,
                dtype=dtype,
                device=device,
            )
            T = from_matrix(np.asarray(c.T_SC, float))  # in float64, then cast
            rig.add_camera(Transformation(r=T.r.to(dtype=dtype, device=device),
                                          q=T.q.to(dtype=dtype, device=device)), cam)
        return rig


def _load_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV-style YAML (leading ``%YAML:1.0`` directive)."""
    with open(path) as f:
        text = f.read()
    lines = text.splitlines()
    if lines and lines[0].startswith("%YAML"):
        lines = lines[1:]
    text = "\n".join(l for l in lines if not l.strip().startswith("!!"))
    text = text.replace("!!opencv-matrix", "")
    return yaml.safe_load(text) or {}


def load_config(path: str) -> VioConfig:
    d = _load_opencv_yaml(path)
    cfg = VioConfig()

    for c in d.get("cameras", []) or []:
        cfg.cameras.append(
            CameraConfig(
                T_SC=np.array(c["T_SC"], float).reshape(4, 4),
                width=int(c["image_dimension"][0]),
                height=int(c["image_dimension"][1]),
                focal=[float(x) for x in c["focal_length"]],
                principal=[float(x) for x in c["principal_point"]],
                distortion=[float(x) for x in c["distortion_coefficients"]],
                distortion_type=str(c["distortion_type"]),
            )
        )

    imu = d.get("imu_params", {}) or {}
    cfg.imu = ImuParameters(
        sigma_g_c=float(imu.get("sigma_g_c", 12e-4)),
        sigma_a_c=float(imu.get("sigma_a_c", 8e-3)),
        sigma_gw_c=float(imu.get("sigma_gw_c", 4e-6)),
        sigma_aw_c=float(imu.get("sigma_aw_c", 4e-5)),
        g=float(imu.get("g", 9.81007)),
        g_max=float(imu.get("g_max", 7.8)),
        a_max=float(imu.get("a_max", 176.0)),
        rate=int(imu.get("imu_rate", 100)),
        sigma_ba=float(imu.get("sigma_ba", 0.1)),
        sigma_bg=float(imu.get("sigma_bg", 0.03)),
    )
    if "T_BS" in imu:
        cfg.T_BS = np.array(imu["T_BS"], float).reshape(4, 4)
    sonar = d.get("sonar_params", {}) or {}
    if "T_SSo" in sonar:
        cfg.T_SSo = np.array(sonar["T_SSo"], float).reshape(4, 4)

    cam_p = d.get("camera_params", {}) or {}
    cfg.camera_rate = float(cam_p.get("camera_rate", 20.0))
    cfg.timestamp_tolerance = float(cam_p.get("timestamp_tolerance", 0.005))
    cfg.sigma_absolute_translation = float(
        cam_p.get("sigma_absolute_translation", 0.0)
    )
    cfg.sigma_absolute_orientation = float(
        cam_p.get("sigma_absolute_orientation", 0.0)
    )
    cfg.sigma_c_relative_translation = float(
        cam_p.get("sigma_c_relative_translation", 0.0)
    )
    cfg.sigma_c_relative_orientation = float(
        cam_p.get("sigma_c_relative_orientation", 0.0)
    )

    cfg.num_keyframes = int(d.get("numKeyframes", 5))
    cfg.num_imu_frames = int(d.get("numImuFrames", 3))
    ceres = d.get("ceres_options", {}) or {}
    cfg.min_iterations = int(ceres.get("minIterations", 3))
    cfg.max_iterations = int(ceres.get("maxIterations", 10))
    cfg.time_limit = float(ceres.get("timeLimit", 0.035))
    det = d.get("detection_options", {}) or {}
    cfg.detection_threshold = float(det.get("threshold", 40.0))
    cfg.detection_octaves = int(det.get("octaves", 0))
    cfg.max_keypoints = int(det.get("maxNoKeypoints", 400))
    cfg.image_delay = float(d.get("imageDelay", 0.0))

    def _b(v):
        return bool(v) if isinstance(v, (bool, int)) else str(v).lower() == "true"

    cfg.is_sonar_used = _b(d.get("isSonarUsed", False))
    cfg.is_depth_used = _b(d.get("isDepthUsed", False))
    cfg.histogram_method = str(d.get("histogramMethod", "NONE")).strip('"')
    cfg.clahe_clip_limit = float(d.get("claheClipLimit", 5.0))
    cfg.clahe_tiles = int(d.get("claheTilesGridSize", 8))
    cfg.resize_factor = float(d.get("resizeFactor", 1.0))

    cfg.fast_relocalization = _b(d.get("fast_relocalization", False))
    lc = d.get("loop_closure_params", {}) or {}
    cfg.loop_closure = LoopClosureConfig(
        enable=_b(lc.get("enable", 1)),
        min_correspondences=int(lc.get("min_correspondences", 25)),
        pnp_reprojection_threshold=float(lc.get("pnp_reprojection_threshold", 20.0)),
        pnp_ransac_iterations=int(lc.get("pnp_ransac_iterations", 100)),
        keyframe_queue=int(lc.get("keyframe_queue", 5)),
        max_yaw_diff=float(lc.get("max_yaw_diff", 25.0)),
        max_position_diff=float(lc.get("max_position_diff", 15.0)),
        pgo_mode=str(lc.get("pgo_mode", "4dof")).strip('"'),
        vocabulary_file=str(lc.get("vocabulary_file", "")).strip('"'),
    )
    h = d.get("health", {}) or {}
    cfg.health = HealthConfig(
        enable=_b(h.get("enable", 0)),
        min_keypoints=int(h.get("min_keypoints", 15)),
        consecutive_keyframes=int(h.get("consecutive_keyframes", 3)),
        keyframe_wait_time=float(h.get("keyframe_wait_time", 2.0)),
        kps_per_quadrant=int(h.get("kps_per_quadrant", 1)),
    )
    gm = d.get("global_map_params", {}) or {}
    cfg.global_map = GlobalMapConfig(
        enable=_b(gm.get("enable", 1)),
        min_landmark_quality=float(gm.get("min_landmark_quality", 0.01)),
    )
    op = d.get("output_params", {}) or {}
    cfg.output_dir = str(op.get("output_dir", "")).strip('"')
    cfg.debug_mode = _b(op.get("debug", 0))
    return cfg
