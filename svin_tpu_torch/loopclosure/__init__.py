"""Loop closure: BoW place recognition (``retrieval``), seed-free P3P
verification and the 4/6-DoF pose graph (``posegraph``) behind
``LoopCloser``, plus the health gate and switching estimator, the global
map and the frustum export (host numpy). The scalable pose-graph solvers
past 512 nodes (the JAX package's ``parallel/``) are not ported."""
from .frustums import frustum_lines, save_frustums_ply
from .globalmap import GlobalMap
from .loop_closure import LoopCloser, LoopInfo, LoopKeyframe
from .posegraph import (
    PoseGraph6Edges,
    PoseGraph6Nodes,
    PoseGraphEdges,
    PoseGraphNodes,
    matrix_to_ypr,
    normalize_angle,
    optimize_4dof,
    optimize_6dof,
    ypr_to_matrix,
)
from .retrieval import (
    KeyframeDatabase,
    bow_vector,
    l1_scores,
    load_vocabulary,
    make_vocabulary,
    save_vocabulary,
    train_vocabulary,
)
from .switching import (
    HealthStatus,
    SwitchingEstimator,
    TrackingState,
    check_health,
)

__all__ = [
    "GlobalMap",
    "frustum_lines",
    "save_frustums_ply",
    "HealthStatus",
    "KeyframeDatabase",
    "save_vocabulary",
    "load_vocabulary",
    "train_vocabulary",
    "LoopCloser",
    "LoopInfo",
    "LoopKeyframe",
    "PoseGraph6Edges",
    "PoseGraph6Nodes",
    "PoseGraphEdges",
    "PoseGraphNodes",
    "SwitchingEstimator",
    "TrackingState",
    "bow_vector",
    "check_health",
    "l1_scores",
    "make_vocabulary",
    "matrix_to_ypr",
    "normalize_angle",
    "optimize_4dof",
    "optimize_6dof",
    "ypr_to_matrix",
]
