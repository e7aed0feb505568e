"""The scalable solvers on one device: global bundle adjustment (dense
Schur on the solve kernels, matrix-free PCG), multi-session merging, and the
loop closer's pose-graph solvers past 512 nodes (banded 4-DoF, 4/6-DoF PCG).

Counterpart of the single-device half of the JAX package's ``parallel/``.
Not ported yet: the sharded step factories (``make_sharded_*``,
``sharded_pose_major_index``, ``dist_posegraph``), the multi-process
runtime (``runtime``) and the track-structured BA (``tracks``)."""
from .dist_ba import (
    BucketedProblem,
    GlobalMapProblem,
    ba_solve_bucketed,
    ba_solve_local,
    bucket_problem,
    partition_problem,
)
from .multisession import merge_sessions
from .pcg import ba_solve_pcg, optimize_4dof_pcg, optimize_6dof_pcg, pose_major_index
from .pg_band import BandMeta, BandedPoseGraph, band_posegraph, optimize_4dof_banded

__all__ = [
    "BandMeta",
    "BandedPoseGraph",
    "BucketedProblem",
    "GlobalMapProblem",
    "ba_solve_bucketed",
    "ba_solve_local",
    "ba_solve_pcg",
    "band_posegraph",
    "bucket_problem",
    "merge_sessions",
    "optimize_4dof_banded",
    "optimize_4dof_pcg",
    "optimize_6dof_pcg",
    "partition_problem",
    "pose_major_index",
]
