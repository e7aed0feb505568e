"""Multi-process runtime: process bootstrap, the process mesh, and the
host-to-host keyframe / loop-edge / session exchange.

Counterpart of the JAX package's ``parallel/runtime.py``. The JAX package's
``shard_map`` over a named mesh axis becomes SPMD processes, one device
each, and its ``psum`` a ``torch.distributed.all_reduce``:

- ``initialize_distributed`` starts ``torch.distributed`` from its arguments
  or torch's standard variables (``MASTER_ADDR``/``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``), idempotently. A CUDA device takes NCCL for its
  tensors, with gloo beside it in the same default group for host tensors
  (gloo has no CUDA ``all_gather``); any other device needs its backend
  named. NCCL never falls back to gloo.
- ``make_process_mesh`` is the 1-D mesh: a ``ProcessMesh`` of the default
  group, this process's rank and device. ``ProcessMesh.psum`` is the sharded
  solvers' reduction hook; ``shard`` cuts a problem into this rank's block
  along its sharded fields, ``gather`` puts the blocks back together.
- ``exchange_*`` all-gather fixed-shape host numpy payloads, the keyframe
  topic's and the loop edges' replacement. At world 1 they return the local
  payloads, so the same pipeline code runs in one process.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device=None) -> Tuple[int, int]:
    """Start ``torch.distributed`` (idempotent): ``(rank, world size)``.

    ``coordinator_address`` is an init method (``tcp://host:port``,
    ``file:///path``, ``env://``) or ``host:port``; without one, ``env://``
    when ``MASTER_ADDR`` is set. ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``. With no coordinator and one
    process, no group is created and (0, 1) returned. ``backend`` defaults to
    NCCL for a CUDA ``device`` (``cuda`` unless another is named; gloo then
    carries the host tensors of the same group) and must be named for any
    other device."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = coordinator_address or ("env://" if os.environ.get("MASTER_ADDR") else None)
    nproc = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE") or 1)
    pid = process_id if process_id is not None else int(os.environ.get("RANK") or 0)
    if coord is None:
        if nproc != 1:
            raise ValueError(f"initialize_distributed: {nproc} processes need a coordinator "
                             f"address")
        return 0, 1
    if not (0 <= pid < nproc):
        raise ValueError(f"initialize_distributed: rank {pid} outside a world of {nproc}")
    dev = torch.device(device if device is not None else "cuda")
    if backend is None:
        if dev.type != "cuda":
            raise ValueError(f"initialize_distributed: name a backend for device {dev}")
        backend = "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: NCCL needs a CUDA device")
        local = int(os.environ.get("LOCAL_RANK", pid % torch.cuda.device_count()))
        torch.cuda.set_device(dev.index if dev.index is not None else local)
        backend = "cpu:gloo,cuda:nccl"
    if "://" not in coord:
        coord = "tcp://" + coord
    dist.init_process_group(backend, init_method=coord, world_size=nproc, rank=pid)
    return dist.get_rank(), dist.get_world_size()


class ProcessMesh(NamedTuple):
    """The 1-D process mesh: one device per rank of ``group`` (None: one
    process, no group)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis: str

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ of ``x`` over the mesh (the JAX package's ``psum``): one
        ``all_reduce`` of a fresh contiguous copy when ``x`` is a view, so no
        other tensor changes; ``x`` itself without a group."""
        if self.group is None:
            return x
        x = x.clone() if x._base is not None or not x.is_contiguous() else x
        dist.all_reduce(x, group=self.group)
        return x


def make_process_mesh(axis: str = "data", device=None) -> ProcessMesh:
    """The mesh over every process of the default group (one device each),
    for the sharded solvers. On ``cuda`` (the current CUDA device) unless
    another device is named; raises without a card."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_process_mesh: no CUDA device; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return ProcessMesh(group=None, rank=0, size=1, device=dev, axis=axis)
    return ProcessMesh(group=dist.group.WORLD, rank=dist.get_rank(), size=dist.get_world_size(),
                       device=dev, axis=axis)


# ----------------------------------------------------- sharding along the mesh
# The sharded fields of each problem type and the dimension each is cut along
# (the JAX factories' P(axis) specs); every other field is replicated.
_BA_FIELDS = ("lm", "lm_valid", "obs_uv", "obs_pose", "obs_cam", "obs_valid")
SHARDED_DIMS = {
    "GlobalMapProblem": dict.fromkeys(_BA_FIELDS + ("obs_lm",), 0),
    "BucketedProblem": dict.fromkeys(_BA_FIELDS, 0),
    "TrackProblem": dict(lm=0, lm_valid=0, base=0, lo=0, obs_uv=2, obs_valid=1, ov_uv=0,
                         ov_pose=0, ov_lm=0, ov_cam=0, ov_valid=0),
    "PoseGraphEdges": dict.fromkeys(("i", "j", "t_ij", "yaw_ij", "weight", "is_loop", "valid"), 0),
}


def shard(mesh: ProcessMesh, tree):
    """This rank's block of ``tree`` on the mesh's device: each sharded field
    cut into ``mesh.size`` equal blocks along its dimension (what
    ``jax.device_put`` with the JAX factories' shardings does), the other
    fields whole."""
    dims = SHARDED_DIMS[type(tree).__name__]
    out = {}
    for f in tree._fields:
        x = getattr(tree, f)
        if f in dims:
            n = x.shape[dims[f]]
            if n % mesh.size:
                raise ValueError(f"shard: {type(tree).__name__}.{f} has {n} rows along dim "
                                 f"{dims[f]}, not a multiple of {mesh.size}")
            x = x.narrow(dims[f], mesh.rank * (n // mesh.size), n // mesh.size)
        out[f] = x.to(mesh.device)
    return type(tree)(**out)


def gather(mesh: ProcessMesh, local):
    """The whole problem from every rank's block (collective; the inverse of
    ``shard``): the sharded fields all-gathered over the host and
    concatenated in rank order, on the mesh's device."""
    dims = SHARDED_DIMS[type(local).__name__]
    out = {}
    for f in local._fields:
        x = getattr(local, f)
        if f in dims and mesh.size > 1:
            parts = _allgather_array(_host(x))
            x = torch.from_numpy(np.concatenate(list(parts), axis=dims[f])).to(mesh.device)
        out[f] = x
    return type(local)(**out)


# ------------------------------------------------ keyframe/loop exchange
# The packed keyframe payload: the array form of the reference's keyframe
# topic tuple, without the image (place recognition across hosts works on
# descriptors; images stay with their host, as the reference's raw-image
# buffer stays inside pose_graph_node).
KEYFRAME_FIELDS = (
    ("kf_index", np.int32, ()),  # global keyframe id
    ("timestamp", np.float64, ()),
    ("T_WC_r", np.float64, (3,)),
    ("T_WC_q", np.float64, (4,)),
    ("points_W", np.float32, (-1, 3)),  # padded landmark positions
    ("point_valid", np.bool_, (-1,)),
    ("descriptors", np.uint32, (-1, 8)),
    ("landmark_ids", np.int64, (-1,)),  # the sender's landmark ids
)


def pack_keyframe(export: Dict, cap: int) -> Dict[str, np.ndarray]:
    """A keyframe-export dict as fixed-shape host arrays of ``cap``
    landmark slots."""
    n = min(len(export["points_W"]), cap)
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = _host(export["points_W"])[:n]
    ok = np.zeros(cap, bool)
    ok[:n] = True
    desc = np.zeros((cap, 8), np.uint32)
    d = export.get("descriptors")
    if d is not None:
        d = _host(d)
        m = min(len(d), cap)
        desc[:m] = d[:m].view(np.uint32) if d.dtype == np.int32 else d[:m]
    lm_ids = np.full(cap, -1, np.int64)
    li = export.get("landmark_ids")
    if li is not None:
        li = _host(li)
        m = min(len(li), cap)
        lm_ids[:m] = li[:m]
    return {
        "kf_index": np.int32(export["kf_index"]),
        "timestamp": np.float64(export["timestamp"]),
        "T_WC_r": np.asarray(_host(export["T_WC_r"]), np.float64),
        "T_WC_q": np.asarray(_host(export["T_WC_q"]), np.float64),
        "points_W": pts,
        "point_valid": ok,
        "descriptors": desc,
        "landmark_ids": lm_ids,
    }


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _allgather_array(a: np.ndarray) -> np.ndarray:
    """(P, ...) every process's ``a`` (equal shapes and dtypes), as bytes
    through the default group's host backend."""
    a = np.ascontiguousarray(a)
    if _world() == 1:
        return a[None]
    flat = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(flat) for _ in range(_world())]
    dist.all_gather(parts, flat)
    return np.stack([p.numpy().view(a.dtype).reshape(a.shape) for p in parts])


def _allgather_tree(tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every leaf all-gathered across processes (leading axis = process);
    at world 1, ``[local]``."""
    return {k: _allgather_array(np.asarray(v)) for k, v in tree.items()}


def exchange_keyframe_payloads(local: List[Dict[str, np.ndarray]], cap: int = 512,
                               max_per_round: int = 4) -> List[Dict[str, np.ndarray]]:
    """Every process's newest packed keyframes, the local ones included, as
    one flat list in process order with empty slots dropped. Collective:
    every process calls it with the same ``cap`` and ``max_per_round``."""
    batch = {
        "kf_index": np.full(max_per_round, -1, np.int32),
        "timestamp": np.zeros(max_per_round, np.float64),
        "T_WC_r": np.zeros((max_per_round, 3), np.float64),
        "T_WC_q": np.zeros((max_per_round, 4), np.float64),
        "points_W": np.zeros((max_per_round, cap, 3), np.float32),
        "point_valid": np.zeros((max_per_round, cap), bool),
        "descriptors": np.zeros((max_per_round, cap, 8), np.uint32),
        "landmark_ids": np.full((max_per_round, cap), -1, np.int64),
    }
    for i, kf in enumerate(local[:max_per_round]):
        for k in batch:
            batch[k][i] = kf[k]
    gathered = _allgather_tree(batch)
    return [{k: gathered[k][p, i] for k in gathered}
            for p in range(gathered["kf_index"].shape[0]) for i in range(max_per_round)
            if int(gathered["kf_index"][p, i]) >= 0]


def exchange_session_problems(prob) -> list:
    """Every process's session ``GlobalMapProblem`` (equal shapes across
    processes: pad the sessions to a common K, L, O first), in process
    order, on ``prob``'s device: the input of ``merge_sessions``.
    Collective."""
    gathered = _allgather_tree({f: _host(getattr(prob, f)) for f in prob._fields})
    dev = prob.pose_r.device
    return [type(prob)(**{k: torch.from_numpy(np.ascontiguousarray(v[p])).to(dev)
                          for k, v in gathered.items()})
            for p in range(gathered["pose_r"].shape[0])]


def exchange_shared_pairs(local_pairs: np.ndarray, max_per_round: int = 256) -> np.ndarray:
    """Every process's cross-session landmark associations (rows
    ``[session_a, lm_a, session_b, lm_b]``, ``merge_sessions``'s
    ``shared``), concatenated. Collective."""
    batch = np.full((max_per_round, 4), -1, np.int64)
    n = min(len(local_pairs), max_per_round)
    if n:
        batch[:n] = np.asarray(local_pairs, np.int64)[:n]
    gathered = _allgather_array(batch).reshape(-1, 4)
    return gathered[gathered[:, 0] >= 0]


def exchange_loop_edges(local_edges: np.ndarray, max_per_round: int = 16) -> np.ndarray:
    """Every process's loop edges (rows ``[i, j, t_ij(3), yaw_ij,
    weight]``), concatenated; rows with i < 0 are padding. Collective:
    every process calls it with the same ``max_per_round``."""
    batch = np.full((max_per_round, 7), -1.0, np.float64)
    n = min(len(local_edges), max_per_round)
    if n:
        batch[:n] = np.asarray(local_edges, np.float64)[:n]
    flat = _allgather_array(batch).reshape(-1, 7)
    return flat[flat[:, 0] >= 0]
