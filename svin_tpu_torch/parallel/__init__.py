"""The scalable solvers on one device: global bundle adjustment (dense
Schur on the solve kernels, matrix-free PCG, and the track-structured PCG
for Cave-scale maps), multi-session merging, and the loop closer's
pose-graph solvers past 512 nodes (banded 4-DoF, 4/6-DoF PCG).

Counterpart of the single-device half of the JAX package's ``parallel/``.
Not ported yet: the sharded step factories (``make_sharded_*``,
``sharded_pose_major_index``, ``dist_posegraph``) and the multi-process
runtime (``runtime``)."""
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
from .tracks import TrackMeta, TrackProblem, ba_solve_tracks, tracks_from_problem

__all__ = [
    "BandMeta",
    "BandedPoseGraph",
    "BucketedProblem",
    "GlobalMapProblem",
    "TrackMeta",
    "TrackProblem",
    "ba_solve_bucketed",
    "ba_solve_local",
    "ba_solve_pcg",
    "ba_solve_tracks",
    "band_posegraph",
    "bucket_problem",
    "merge_sessions",
    "optimize_4dof_banded",
    "optimize_4dof_pcg",
    "optimize_6dof_pcg",
    "partition_problem",
    "pose_major_index",
    "tracks_from_problem",
]
