"""Checkpoint / resume for the VIO engine.

Counterpart of the engine half of the JAX package's
``pipeline/checkpoint.py``, in that package's file format, so a ``.npz``
written by either package loads in the other. One compressed ``.npz``
holds:

- ``window__{i}`` / ``factors__{i}``: the window and factor tables' leaves,
  numbered in the order ``jax.tree_util.tree_flatten`` gives them (depth
  first over the NamedTuple fields, ``None`` leaves skipped; the tables
  hold none). ``WINDOW_LEAVES`` and ``FACTORS_LEAVES`` below write that
  order down as field paths; a ``{prefix}__treedef`` string rides along
  (the JAX package writes its treedef there and reads it back nowhere);
- ``lm_desc``: landmark descriptors as uint32 words (the engine holds
  their int32 view); ``lm_cov``: the gate's landmark covariances;
- ``meta``: JSON of the engine's counters; ``imu_t`` / ``imu_gyro`` /
  ``imu_acc``: the IMU buffer; ``trajectory``: rows (t, r, q).

Per-frame keypoint records are not kept (tracking re-warms in one frame).

The loop closer's file (``save_loop_closer`` / ``load_loop_closer``), in
the same package-neutral format: ``nodes__{i}`` / ``edges__{i}`` (the
pose-graph tables' fields in order), the database rows (``db_word_ids`` /
``db_word_w`` and the codebooks for the product database, ``db_vectors`` /
``db_vocab`` for the flat one), ``meta`` (counters, drift, sequence state),
the drift and base-frame arrays, the full SE(3) edge relatives, and per
keyframe its pose, timestamp, sequence and loop-closure features (descriptor
words as uint32), so a resumed session verifies loops against the restored
keyframes. The inverted file is rebuilt on load.
"""
from __future__ import annotations

import json

import numpy as np

from .vio import VioEngine

# the leaf order of jax.tree_util.tree_flatten over the JAX package's
# WindowState and Factors
WINDOW_LEAVES = (
    "r", "q", "speed_bias", "state_valid", "is_keyframe", "timestamp", "state_id", "hp_W",
    "lm_valid", "lm_id", "lm_quality", "ext_r", "ext_q",
)
_PREINTEGRAL = (
    "Delta_q", "C_integral", "C_doubleintegral", "acc_integral", "acc_doubleintegral",
    "dalpha_db_g", "dv_db_g", "dp_db_g", "P_delta", "Delta_t", "bias_ref",
)
FACTORS_LEAVES = (
    ("reproj.uv", "reproj.state_idx", "reproj.lm_idx", "reproj.cam_idx", "reproj.sqrt_info",
     "reproj.valid")
    + tuple(f"imu.pre.{f}" for f in _PREINTEGRAL)
    + ("imu.sqrt_info", "imu.valid",
       "depth.depth", "depth.first_depth", "depth.sqrt_info", "depth.valid",
       "sonar.range", "sonar.target_W", "sonar.sqrt_info", "sonar.valid",
       "priors.pose_mean_r", "priors.pose_mean_q", "priors.pose_sqrt_info", "priors.pose_valid",
       "priors.sb_mean", "priors.sb_sqrt_info", "priors.sb_valid",
       "ext_prior.mean_r", "ext_prior.mean_q", "ext_prior.sqrt_info", "ext_prior.valid",
       "marg.H", "marg.b", "marg.lin_r", "marg.lin_q", "marg.lin_sb", "marg.lin_ext_r",
       "marg.lin_ext_q", "marg.valid",
       "lm_prior.mean", "lm_prior.sqrt_info", "lm_prior.valid")
)
# the pose-graph tables (NamedTuples: tree_flatten order is field order)
NODES_LEAVES = ("p", "yaw", "pitch", "roll", "valid")
EDGES_LEAVES = ("i", "j", "t_ij", "yaw_ij", "weight", "is_loop", "valid")
_LEAVES = {"window": WINDOW_LEAVES, "factors": FACTORS_LEAVES, "nodes": NODES_LEAVES,
           "edges": EDGES_LEAVES}
_META = ("n_states", "frame_count", "kf_count", "next_state_id", "next_lm_id", "last_kf_slot",
         "first_depth")


def _get(tree, path: str):
    for name in path.split("."):
        tree = getattr(tree, name)
    return tree


def _set(tree, path: str, value):
    """``tree`` with the leaf at ``path`` replaced (NamedTuples rebuilt)."""
    head, _, rest = path.partition(".")
    if not rest:
        return tree._replace(**{head: value})
    return tree._replace(**{head: _set(getattr(tree, head), rest, value)})


def _flatten(tree, prefix: str, out: dict) -> None:
    paths = _LEAVES[prefix]
    out[f"{prefix}__treedef"] = np.asarray(f"{type(tree).__name__}({', '.join(paths)})")
    for i, path in enumerate(paths):
        out[f"{prefix}__{i}"] = np.asarray(_get(tree, path))


def _unflatten(template, prefix: str, data):
    """The engine's host table ``template`` with every leaf from ``data``, in
    the template leaf's dtype (a float32 engine loads a float64 file)."""
    tree = template
    for i, path in enumerate(_LEAVES[prefix]):
        old = np.asarray(_get(template, path))
        new = np.asarray(data[f"{prefix}__{i}"])
        if new.shape != old.shape:
            raise ValueError(f"checkpoint {prefix}.{path}: shape {new.shape}, engine {old.shape}")
        tree = _set(tree, path, new.astype(old.dtype))
    return tree


def save_engine(engine: VioEngine, path: str) -> None:
    """Write the engine's estimation state to ``path`` (``.npz``). A
    pipelined engine must be flushed first (``backend_flush``): its host
    tables lag the solve in flight."""
    if getattr(engine, "_pending", None) is not None:
        raise ValueError("save_engine: a solve is in flight; call backend_flush() first")
    out: dict = {}
    _flatten(engine.window, "window", out)
    _flatten(engine.factors, "factors", out)
    desc = np.asarray(engine._lm_desc)
    out["lm_desc"] = desc.view(np.uint32) if desc.dtype == np.int32 else desc
    out["lm_cov"] = np.asarray(engine._lm_cov)
    out["meta"] = np.asarray(json.dumps({k: getattr(engine, k) for k in _META}))
    out["imu_t"] = np.asarray(engine.imu_t)
    out["imu_gyro"] = np.stack(engine.imu_gyro) if engine.imu_gyro else np.zeros((0, 3))
    out["imu_acc"] = np.stack(engine.imu_acc) if engine.imu_acc else np.zeros((0, 3))
    out["trajectory"] = (
        np.asarray([np.concatenate([[t], np.asarray(r), np.asarray(q)])
                    for t, r, q in engine.trajectory])
        if engine.trajectory else np.zeros((0, 8))
    )
    np.savez_compressed(path, **out)


def load_engine(engine: VioEngine, path: str) -> VioEngine:
    """Restore a state written by ``save_engine`` (either package's) into a
    freshly constructed engine of the same configuration and rig."""
    data = np.load(path, allow_pickle=False)
    engine.window = _unflatten(engine.window, "window", data)
    engine.factors = _unflatten(engine.factors, "factors", data)
    desc = np.array(data["lm_desc"])
    engine._lm_desc = desc.view(np.int32) if desc.dtype == np.uint32 else desc
    if "lm_cov" in data and data["lm_cov"].size:
        engine._lm_cov = np.array(data["lm_cov"])
    meta = json.loads(str(data["meta"]))
    for k in _META:
        setattr(engine, k, meta[k])
    with engine._imu_mutex:
        engine.imu_t = list(data["imu_t"])
        engine.imu_gyro = list(data["imu_gyro"])
        engine.imu_acc = list(data["imu_acc"])
    engine.trajectory = [(row[0], row[1:4], row[4:8]) for row in data["trajectory"]]
    engine.frames = {}
    engine._pending = None
    return engine


def _table(template, prefix: str, data):
    """A pose-graph table from ``data`` at the file's capacity, float leaves
    in the template's dtype."""
    leaves = []
    for i, name in enumerate(_LEAVES[prefix]):
        a = np.array(data[f"{prefix}__{i}"])
        old = getattr(template, name)
        leaves.append(a.astype(old.dtype) if old.dtype.kind == "f" else a)
    return type(template)(*leaves)


def _pad_stack(arrs, dtype):
    arrs = [np.asarray(a) for a in arrs]
    m = max((a.shape[0] for a in arrs), default=0)
    out = np.zeros((len(arrs), m) + arrs[0].shape[1:], dtype)
    cnt = np.zeros(len(arrs), np.int32)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
        cnt[i] = a.shape[0]
    return out, cnt


def save_loop_closer(closer, path: str) -> None:
    """Write the loop closer's pose graph, database and keyframe features to
    ``path`` (``.npz``)."""
    from ..loopclosure.retrieval import uint32_words

    out: dict = {}
    _flatten(closer.nodes, "nodes", out)
    _flatten(closer.edges, "edges", out)
    db = closer.db
    if hasattr(db, "word_ids"):  # the product database
        out["db_word_ids"] = np.asarray(db.word_ids[: db.count])
        out["db_word_w"] = np.asarray(db.word_w[: db.count])
        out["db_vocab1"] = uint32_words(db.pv.vocab1)
        out["db_vocab2"] = uint32_words(db.pv.vocab2)
    else:
        out["db_vectors"] = np.asarray(db.vectors[: db.count])
        out["db_vocab"] = uint32_words(db.vocab)
    meta = {
        "n_edges": closer.n_edges,
        "earliest_loop_index": closer.earliest_loop_index,
        "yaw_drift": closer.yaw_drift,
        "n_keyframes": len(closer.keyframes),
        "sequence_cnt": closer.sequence_cnt,
        "seq_aligned": {str(k): bool(v) for k, v in closer._seq_aligned.items()},
        "kf_by_export": {str(k): int(v) for k, v in closer._kf_by_export.items()},
    }
    out["meta"] = np.asarray(json.dumps(meta))
    out["t_drift"] = closer.t_drift
    out["R_drift"] = closer.R_drift
    out["w_svin_R"] = closer._w_svin_R
    out["w_svin_t"] = closer._w_svin_t
    if closer.keyframes:
        out["kf_seq"] = np.asarray([k.sequence for k in closer.keyframes], np.int32)
    if closer._edges_full:
        out["edges_full_t"] = np.stack([t for t, _ in closer._edges_full])
        out["edges_full_q"] = np.stack([q for _, q in closer._edges_full])
    if closer.keyframes:
        kfs = closer.keyframes
        out["kf_t"] = np.asarray([k.timestamp for k in kfs])
        out["kf_r"] = np.stack([np.asarray(k.T_WC_vio.r) for k in kfs])
        out["kf_q"] = np.stack([np.asarray(k.T_WC_vio.q) for k in kfs])
        out["kf_wdesc"], out["kf_wdesc_n"] = _pad_stack(
            [uint32_words(k.window_desc) for k in kfs], np.uint32)
        out["kf_wvalid"], _ = _pad_stack([np.asarray(k.window_valid, bool) for k in kfs], bool)
        out["kf_edesc"], out["kf_edesc_n"] = _pad_stack(
            [uint32_words(k.extra_desc) for k in kfs], np.uint32)
        out["kf_euv"], _ = _pad_stack([np.asarray(k.extra_uv, np.float32) for k in kfs], np.float32)
        out["kf_evalid"], _ = _pad_stack([np.asarray(k.extra_valid, bool) for k in kfs], bool)
        out["kf_pts"], out["kf_pts_n"] = _pad_stack(
            [np.asarray(k.points_W, np.float64) for k in kfs], np.float64)
        out["kf_puv"], _ = _pad_stack([np.asarray(k.point_uv, np.float64) for k in kfs], np.float64)
    np.savez_compressed(path, **out)


def load_loop_closer(closer, path: str):
    """Restore a loop closer written by ``save_loop_closer`` (either
    package's) into a freshly constructed one: pose graph (capacity from the
    file), database rows with the inverted file rebuilt, drift and sequence
    state, and every keyframe's loop-closure features."""
    from ..kinematics import Transformation
    from ..loopclosure.loop_closure import LoopKeyframe

    data = np.load(path, allow_pickle=False)
    closer.nodes = _table(closer.nodes, "nodes", data)
    closer.edges = _table(closer.edges, "edges", data)
    # capacity follows the restored arrays (a later growth doubles from them)
    closer.capacity = int(closer.nodes.p.shape[0])
    meta = json.loads(str(data["meta"]))
    closer.n_edges = meta["n_edges"]
    closer.earliest_loop_index = meta["earliest_loop_index"]
    closer.yaw_drift = meta["yaw_drift"]
    closer.t_drift = np.asarray(data["t_drift"])
    if "R_drift" in data:
        closer.R_drift = np.asarray(data["R_drift"])
    if "w_svin_R" in data:
        closer._w_svin_R = np.asarray(data["w_svin_R"])
        closer._w_svin_t = np.asarray(data["w_svin_t"])
    closer.sequence_cnt = int(meta.get("sequence_cnt", 0))
    closer._seq_aligned = {int(k): bool(v) for k, v in meta.get("seq_aligned", {"0": True}).items()}
    closer._kf_by_export = {int(k): int(v) for k, v in meta.get("kf_by_export", {}).items()}
    if "edges_full_t" in data:
        closer._edges_full = [(np.asarray(t), np.asarray(q))
                              for t, q in zip(data["edges_full_t"], data["edges_full_q"])]
    db = closer.db
    if "db_word_ids" in data:  # the product database
        n = int(data["db_word_ids"].shape[0])
        while db.capacity < n:
            db.word_ids = np.concatenate([db.word_ids, np.zeros_like(db.word_ids)])
            db.word_w = np.concatenate([db.word_w, np.zeros_like(db.word_w)])
            db.capacity *= 2
        db.word_ids[:n] = data["db_word_ids"]
        db.word_w[:n] = data["db_word_w"]
        db.count = n
        # the device mirror is rebuilt on the next device query
        db._dev_ids = None
        db._dev_w = None
        db._dev_count = 0
        db.rebuild_index()
    else:
        n = int(data["db_vectors"].shape[0])
        while db.capacity < n:
            db.vectors = np.concatenate([db.vectors, np.zeros_like(db.vectors)])
            db.capacity *= 2
        db.vectors[:n] = data["db_vectors"]
        db.count = n
    closer.keyframes = []
    if "kf_t" in data:
        empty_desc = np.zeros((0, 8), np.int32)
        empty_valid = np.zeros(0, bool)
        has_feat = "kf_wdesc" in data
        for k in range(meta["n_keyframes"]):
            if has_feat:
                ne = int(data["kf_edesc_n"][k])
                npts = int(data["kf_pts_n"][k])
                wdesc = np.array(data["kf_wdesc"][k]).view(np.int32)
                wvalid = np.array(data["kf_wvalid"][k])
                edesc = np.array(data["kf_edesc"][k][:ne]).view(np.int32)
                euv = np.array(data["kf_euv"][k][:ne])
                evalid = np.array(data["kf_evalid"][k][:ne])
                pts = np.array(data["kf_pts"][k][:npts])
                puv = np.array(data["kf_puv"][k][:npts])
            else:  # a checkpoint without features
                wdesc, wvalid = empty_desc, empty_valid
                edesc, evalid = empty_desc, empty_valid
                euv = np.zeros((0, 2), np.float32)
                pts, puv = np.zeros((0, 3)), np.zeros((0, 2))
            closer.keyframes.append(LoopKeyframe(
                index=k, timestamp=float(data["kf_t"][k]),
                T_WC_vio=Transformation(r=np.asarray(data["kf_r"][k]), q=np.asarray(data["kf_q"][k])),
                points_W=pts, point_uv=puv, window_desc=wdesc, window_valid=wvalid,
                extra_uv=euv, extra_desc=edesc, extra_valid=evalid,
                sequence=int(data["kf_seq"][k]) if "kf_seq" in data else 0,
            ))
    return closer
