from .hull import keyframe_overlap_ratio
from .ransac import (
    RansacResult,
    absolute_pose_ransac,
    absolute_pose_ransac_p3p,
    draw_hypotheses,
    relative_pose_ransac,
    rotation_only_ransac,
)
from .scale_refinement import ScaleRefiner, solve_scale
from .triangulation import (
    TriangulationResult,
    point_from_homogeneous,
    triangulate_fast,
    triangulation_covariance,
)

__all__ = [
    "RansacResult",
    "ScaleRefiner",
    "TriangulationResult",
    "absolute_pose_ransac",
    "absolute_pose_ransac_p3p",
    "draw_hypotheses",
    "keyframe_overlap_ratio",
    "point_from_homogeneous",
    "relative_pose_ransac",
    "rotation_only_ransac",
    "solve_scale",
    "triangulate_fast",
    "triangulation_covariance",
]
