"""Multi-session joint mapping: merge sessions into one BA problem.

Counterpart of the JAX package's ``parallel/multisession.py``: each session
brings poses, landmarks and observations in its own drift frame;
cross-session landmark correspondences (from place recognition) identify
shared landmarks; in the merged problem the anchor session's gauge stays
fixed and the other sessions are free, so one BA aligns the sessions and
refines the joint map. Host numpy; the tensors land on the first session's
device.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .dist_ba import GlobalMapProblem, _host


def merge_sessions(
    sessions: List[GlobalMapProblem],
    shared: List[Tuple[int, int, int, int]],
    anchor: int = 0,
) -> Tuple[GlobalMapProblem, List[np.ndarray], List[np.ndarray]]:
    """Concatenate sessions into one problem.

    ``shared``: (session_a, lm_a, session_b, lm_b), landmark ``lm_b`` of
    session_b the same point as ``lm_a`` of session_a; session_b's
    observations are rewired onto one root landmark (union-find over the
    pairs, rooted at the lower global index). Only the anchor session's
    gauge poses stay fixed. Returns (problem, pose_maps, lm_maps): each
    session's index maps into the merged problem."""
    n_poses = [int(s.pose_r.shape[0]) for s in sessions]
    n_lms = [int(s.lm.shape[0]) for s in sessions]
    pose_off = np.cumsum([0] + n_poses)[:-1]
    lm_off = np.cumsum([0] + n_lms)[:-1]
    L_tot = int(sum(n_lms))
    parent = np.arange(L_tot)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for sa, la, sb, lb in shared:
        a = find(lm_off[sa] + la)
        b = find(lm_off[sb] + lb)
        if b < a:  # root toward the earlier session's copy (its position wins)
            a, b = b, a
        parent[b] = a
    lm_root = np.array([find(k) for k in range(L_tot)])

    def cat(field, offsets=None):
        parts = [_host(getattr(s, field)) for s in sessions]
        if offsets is not None:
            parts = [p + offsets[i] for i, p in enumerate(parts)]
        return np.concatenate(parts)

    fixed = np.concatenate([_host(s.pose_fixed) if i == anchor else np.zeros(n_poses[i], bool)
                            for i, s in enumerate(sessions)])
    # merged landmarks: only roots stay valid, at the root copy's position
    lm_valid = cat("lm_valid") & (lm_root == np.arange(L_tot))
    dev = sessions[0].pose_r.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    prob = GlobalMapProblem(
        pose_r=t(cat("pose_r")), pose_q=t(cat("pose_q")), pose_fixed=t(fixed), lm=t(cat("lm")),
        lm_valid=t(lm_valid), obs_uv=t(cat("obs_uv")),
        obs_pose=t(cat("obs_pose", pose_off).astype(np.int64)),
        obs_lm=t(lm_root[cat("obs_lm", lm_off)].astype(np.int64)),
        obs_cam=t(cat("obs_cam").astype(np.int64)), obs_valid=t(cat("obs_valid")))
    pose_maps = [pose_off[i] + np.arange(n_poses[i]) for i in range(len(sessions))]
    lm_maps = [lm_root[lm_off[i] + np.arange(n_lms[i])] for i in range(len(sessions))]
    return prob, pose_maps, lm_maps
