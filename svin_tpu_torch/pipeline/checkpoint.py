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
The loop-closer half waits for the port of ``loopclosure/``.
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
_LEAVES = {"window": WINDOW_LEAVES, "factors": FACTORS_LEAVES}
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
