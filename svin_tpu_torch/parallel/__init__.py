"""The scalable solvers: global bundle adjustment (dense Schur on the solve
kernels, matrix-free PCG, and the track-structured PCG for Cave-scale
maps), multi-session merging, the loop closer's pose-graph solvers past 512
nodes (banded 4-DoF, 4/6-DoF PCG), and their sharded forms over a process
mesh with the multi-process runtime (``runtime``: bootstrap, mesh,
host payload exchange).

Counterpart of the JAX package's ``parallel/``, every name it exports. Its
``shard_map`` steps become SPMD processes on ``torch.distributed``, one
device each: a ``make_sharded_*`` factory takes a ``ProcessMesh`` and
returns ``(step, shard)``, and its ``psum`` is an ``all_reduce``
(``ProcessMesh.psum``)."""
from .dist_ba import (
    BucketedProblem,
    GlobalMapProblem,
    ba_solve_bucketed,
    ba_solve_local,
    bucket_problem,
    make_sharded_ba,
    make_sharded_ba_bucketed,
    partition_problem,
)
from .dist_posegraph import make_sharded_posegraph, pad_edges_for_mesh
from .multisession import merge_sessions
from .pcg import (
    ba_solve_pcg,
    make_sharded_ba_pcg,
    make_sharded_posegraph_pcg,
    optimize_4dof_pcg,
    optimize_6dof_pcg,
    pose_major_index,
    sharded_pose_major_index,
)
from .pg_band import BandMeta, BandedPoseGraph, band_posegraph, optimize_4dof_banded
from .runtime import (
    ProcessMesh,
    exchange_keyframe_payloads,
    exchange_loop_edges,
    exchange_session_problems,
    exchange_shared_pairs,
    gather,
    initialize_distributed,
    make_process_mesh,
    pack_keyframe,
    shard,
)
from .tracks import (
    TrackMeta,
    TrackProblem,
    ba_solve_tracks,
    make_sharded_ba_tracks,
    tracks_from_problem,
)

__all__ = [
    "BandMeta",
    "BandedPoseGraph",
    "BucketedProblem",
    "GlobalMapProblem",
    "ProcessMesh",
    "TrackMeta",
    "TrackProblem",
    "ba_solve_bucketed",
    "ba_solve_local",
    "ba_solve_pcg",
    "ba_solve_tracks",
    "band_posegraph",
    "bucket_problem",
    "exchange_keyframe_payloads",
    "exchange_loop_edges",
    "exchange_session_problems",
    "exchange_shared_pairs",
    "gather",
    "initialize_distributed",
    "make_process_mesh",
    "make_sharded_ba",
    "make_sharded_ba_bucketed",
    "make_sharded_ba_pcg",
    "make_sharded_ba_tracks",
    "make_sharded_posegraph",
    "make_sharded_posegraph_pcg",
    "merge_sessions",
    "optimize_4dof_banded",
    "optimize_4dof_pcg",
    "optimize_6dof_pcg",
    "pack_keyframe",
    "pad_edges_for_mesh",
    "partition_problem",
    "pose_major_index",
    "shard",
    "sharded_pose_major_index",
    "tracks_from_problem",
]
