"""Camera-frustum + loop-edge line-set export (headless rviz analog; host
numpy, a copy of the JAX package's ``loopclosure/frustums.py``).

The reference publishes a ``MarkerArray`` of camera frusta for every
keyframe pose plus blue loop-closure edges
(pose_graph/src/utils/CameraPoseVisualization.cpp:1-120,
pose_graph/src/pose_graph/Publisher.cpp ``pub_visualization_``). Without
ROS/rviz the same geometry is written as a colored PLY line set (MeshLab/
CloudCompare-viewable): each keyframe contributes the 8 frustum edges
(image-plane rectangle + optical-center connectors) scaled by ``scale``,
each loop edge one line between the two keyframe centers.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

from ..kinematics import Transformation, npq

# canonical frustum corners in the camera frame (CameraPoseVisualization.cpp:3-10)
_IMLT = np.array([-1.0, -0.5, 1.0])
_IMRT = np.array([1.0, -0.5, 1.0])
_IMLB = np.array([-1.0, 0.5, 1.0])
_IMRB = np.array([1.0, 0.5, 1.0])
_OC = np.array([0.0, 0.0, 0.0])

_FRUSTUM_SEGMENTS = (
    (_IMLT, _IMRT), (_IMRT, _IMRB), (_IMRB, _IMLB), (_IMLB, _IMLT),
    (_OC, _IMLT), (_OC, _IMRT), (_OC, _IMLB), (_OC, _IMRB),
)

_FRUSTUM_COLOR = (0, 255, 0)   # keyframe frusta: green
_LOOP_COLOR = (0, 0, 255)      # loop edges: blue (add_edge color.b=1.0)


def frustum_lines(
    T_WC: Transformation, scale: float = 0.2
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """World-frame endpoint pairs of one camera frustum's 8 line segments."""
    C = npq.to_rotation_matrix(np.asarray(T_WC.q, float))
    r = np.asarray(T_WC.r, float).reshape(3)
    out = []
    for a, b in _FRUSTUM_SEGMENTS:
        out.append((C @ (a * scale) + r, C @ (b * scale) + r))
    return out


def save_frustums_ply(
    path: str,
    keyframe_poses: Dict[int, Transformation],
    loop_edges: Iterable[Tuple[int, int]] = (),
    scale: float = 0.2,
) -> None:
    """Write keyframe frusta + loop edges as an ASCII PLY line set."""
    verts: List[np.ndarray] = []
    colors: List[Tuple[int, int, int]] = []
    edges: List[Tuple[int, int]] = []

    def add_segment(p0, p1, color):
        i = len(verts)
        verts.extend([np.asarray(p0, float), np.asarray(p1, float)])
        colors.extend([color, color])
        edges.append((i, i + 1))

    for T in keyframe_poses.values():
        for p0, p1 in frustum_lines(T, scale):
            add_segment(p0, p1, _FRUSTUM_COLOR)
    for a, b in loop_edges:
        if a in keyframe_poses and b in keyframe_poses:
            add_segment(
                np.asarray(keyframe_poses[a].r, float).reshape(3),
                np.asarray(keyframe_poses[b].r, float).reshape(3),
                _LOOP_COLOR,
            )

    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element edge {len(edges)}\n"
            "property int vertex1\nproperty int vertex2\n"
            "end_header\n"
        )
        for p, c in zip(verts, colors):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
        for a, b in edges:
            f.write(f"{a} {b}\n")
