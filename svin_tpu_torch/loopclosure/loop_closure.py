"""Loop closing: keyframe intake → place recognition → geometric
verification → pose-graph optimization → drift correction.

Counterpart of the JAX package's ``loopclosure/loop_closure.py``. The
keyframe payload is the dict ``VioEngine`` exports; the device work is the
keyframe's descriptors (window keypoints re-described, fresh corners
detected and described), the BoW words (the nearest-codeword kernel),
verification (the fused matcher, then seed-free P3P RANSAC) and the dense
pose-graph solve; the bookkeeping is host numpy. Each stage fetches once.

Differences of form from the JAX package:

- The P3P hypotheses are drawn by ``draw_p3p(cur_index, old_index, valid,
  H)`` → (H, 3) indices on ``valid``'s device; the default seeds a
  ``torch.Generator`` with the JAX package's key integer, ``cur_index *
  7919 + old_index``. torch cannot reproduce ``jax.random``'s streams, so
  the parity tests inject the JAX draws.
- The database is added to with the BoW vector the query already computed
  (the JAX package quantizes the keyframe twice, with the same result).
- Past 512 nodes the JAX package switches to the banded 4-DoF solver and
  the 6-DoF PCG of ``parallel/``, which are not ported: there the port
  raises ``NotImplementedError``.
- Host timers per stage (``utils.Timing``): ``lc.1 describe_detect``,
  ``lc.2 bow``, ``lc.3 query``, ``lc.4 verify`` (per candidate inside it:
  ``lc.4.1 match``, ``lc.4.2 p3p``), ``lc.5 pose_graph``; each stage ends
  in its fetch, so the host clock reads the device work too.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cameras import PinholeCamera, back_project
from .. import convert
from ..frontend.ransac import absolute_pose_ransac_p3p, draw_hypotheses
from ..kinematics import Transformation, npq, quaternion as quat
from ..ops import descriptor as desc_ops, detection, hamming
from ..pipeline.config import VioConfig
from ..pipeline.vio import _float32_matmuls
from ..utils import Timer
from .posegraph import (
    PoseGraph6Edges,
    PoseGraph6Nodes,
    PoseGraphEdges,
    PoseGraphNodes,
    matrix_to_ypr,
    matrix_to_ypr_np,
    normalize_angle_np,
    optimize_4dof,
    optimize_6dof,
    ypr_to_matrix,
    ypr_to_matrix_np,
)
from .retrieval import (
    KeyframeDatabase,
    ProductKeyframeDatabase,
    load_product_vocabulary,
    load_vocabulary,
)
from .switching import HealthStatus, SwitchingEstimator, check_health


def _pad(a, n):
    """Zero-pad a host array to n leading rows (capacity growth)."""
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def _words_np(a) -> np.ndarray:
    """Descriptor words as an int32 numpy array (uint32 words as their view)."""
    a = np.asarray(a)
    return a.copy() if a.dtype == np.int32 else a.astype(np.uint32).view(np.int32)


RECENCY_EXCLUSION = 50  # skip the most recent N keyframes (read at call time)
MIN_LOOP_SCORE = 0.015  # absolute floor on BoW score
N_EXTRA_CORNERS = 500  # fresh corners per loop keyframe
DESC_DIST_LOOP = 80  # Hamming acceptance for loop matching
WINDOW_CAP = 512  # fixed window-keypoint capacity (one shape per device call)
COVIS_WEIGHT_TH = 20  # shared-landmark covisibility edge threshold
SOLVE_BATCH_KF = 8  # past 512 nodes, full solves batch every N keyframes
DENSE_MAX_NODES = 512  # the dense solves' limit; past it the JAX package
# runs the scalable solvers of parallel/, not ported


@dataclass
class LoopKeyframe:
    index: int  # sequential pose-graph index
    timestamp: float
    T_WC_vio: Transformation  # VIO odometry pose (numpy r, q; drift frame)
    points_W: np.ndarray  # (M,3) VIO landmark positions
    point_uv: np.ndarray  # (M,2)
    window_desc: np.ndarray  # (WINDOW_CAP,8) int32 descriptors of VIO window keypoints
    window_valid: np.ndarray  # (WINDOW_CAP,)
    extra_uv: np.ndarray  # (Ke,2) fresh corners
    extra_desc: np.ndarray  # (Ke,8) int32
    extra_valid: np.ndarray  # (Ke,)
    loop_index: int = -1
    loop_rel_t: Optional[np.ndarray] = None
    loop_rel_yaw: float = 0.0
    sequence: int = 0  # VIO session this keyframe belongs to
    # covisibility-graph neighbours (internal indices, weight > COVIS_WEIGHT_TH)
    connected: List[int] = field(default_factory=list)
    # retained intake image, only in debug mode (match visualizations)
    debug_image: Optional[np.ndarray] = None


@dataclass
class LoopInfo:
    query_index: int
    match_index: int
    num_inliers: int
    rel_t: np.ndarray
    rel_yaw: float
    # full SE(3) relative old → cur in old's camera frame (6-DoF edges)
    rel_t_full: Optional[np.ndarray] = None
    rel_q_full: Optional[np.ndarray] = None
    # PnP-inlier correspondences (row k ↔ row k), for the debug match images
    uv_query: Optional[np.ndarray] = None
    uv_match: Optional[np.ndarray] = None


class LoopCloser:
    """Sequential loop-closure engine (deterministic, host-orchestrated).

    ``device`` (default ``cuda``; raises without a card unless another is
    named) and ``dtype`` (default float32 on the card, float64 on the CPU)
    set where and in what precision the device stages run; the pose-graph
    tables are host numpy in the matching precision. ``matcher`` and
    ``nearest`` default to the kernel-dispatching ``hamming``
    functions (``hamming.match_descriptors_plain`` /
    ``nearest_codeword_plain`` run the plain versions on the card). ``draw_p3p`` draws the P3P
    hypotheses (see the module docstring)."""

    def __init__(
        self,
        camera: PinholeCamera,
        config: Optional[VioConfig] = None,
        capacity: int = 512,
        device=None,
        dtype=None,
        matcher: Callable = hamming.match_descriptors,
        nearest: Callable = hamming.nearest_codeword,
        draw_p3p: Optional[Callable] = None,
    ):
        self.cfg = config if config is not None else VioConfig()
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LoopCloser: no CUDA device; pass device='cpu' to run on the host")
        if dtype is None:
            dtype = torch.float32 if self.device.type == "cuda" else torch.float64
        self.dtype = dtype
        # bearings are computed in float32, as the JAX package's float32
        # camera computes them, then cast to the closer's precision
        self.camera = convert.tree_to(camera, self.device, torch.float32)
        self._focal_px = float(self.camera.fu)
        self.matcher = matcher
        self.draw_p3p = draw_p3p if draw_p3p is not None else self._draw_p3p
        vocab_file = getattr(self.cfg.loop_closure, "vocabulary_file", "")
        if vocab_file:
            # a trained codebook + idf: product vocabularies load into the
            # 65k-word database, flat codebooks into the 1024-word one
            try:
                pv = load_product_vocabulary(vocab_file)
                self.db = ProductKeyframeDatabase(pv=pv, device=self.device, nearest=nearest)
            except (ValueError, KeyError):
                vocab, weights = load_vocabulary(vocab_file)
                self.db = KeyframeDatabase(vocab=vocab, weights=weights, device=self.device,
                                           nearest=nearest)
        else:
            self.db = ProductKeyframeDatabase(device=self.device, nearest=nearest)
        self.keyframes: List[LoopKeyframe] = []
        self.capacity = capacity
        npdt = np.float64 if dtype == torch.float64 else np.float32
        # pose-graph tables are host numpy (per-keyframe writes stay on the host)
        self.nodes = PoseGraphNodes(
            p=np.zeros((capacity, 3), npdt), yaw=np.zeros(capacity, npdt),
            pitch=np.zeros(capacity, npdt), roll=np.zeros(capacity, npdt),
            valid=np.zeros(capacity, bool),
        )
        E = capacity * 4
        self.edges = PoseGraphEdges(
            i=np.zeros(E, np.int32), j=np.zeros(E, np.int32), t_ij=np.zeros((E, 3), npdt),
            yaw_ij=np.zeros(E, npdt), weight=np.ones(E, npdt), is_loop=np.zeros(E, bool),
            valid=np.zeros(E, bool),
        )
        self.n_edges = 0
        # full SE(3) relative per edge (same order as `edges`), for 6-DoF mode
        self._edges_full: List[Tuple[np.ndarray, np.ndarray]] = []
        self.earliest_loop_index = capacity
        self.loops: List[LoopInfo] = []
        # drift: corrected = R_drift @ p_vio + t_drift (yaw-only in 4-DoF mode)
        self.yaw_drift = 0.0
        self.R_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        self.loop_callback: Optional[Callable[[LoopInfo], None]] = None
        self._pending_optimize = False
        # health gate + robust-pose state machine
        self.switching = SwitchingEstimator(cfg=self.cfg.health)
        self.robust_trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.keep_images = bool(getattr(self.cfg, "debug_mode", False))
        # optional DebugOutputDirs: every verification stage writes its image
        self.debug = None
        self.pgo_gn_iters = 30  # pose-graph GN iterations per solve
        self.stats = {
            "queries": 0, "candidates": 0, "floor_reject": 0,
            "desc_reject": 0, "pnp_reject": 0, "ratio_reject": 0,
            "gate_reject": 0, "accepted": 0,
        }
        self.pgo_log: List[dict] = []
        self._last_solve_kf = 0
        # export kf_index → internal index (unhealthy keyframes never enter)
        self._kf_by_export: Dict[int, int] = {}
        # sequence/base-frame state: a VIO restart starts a new sequence
        self.sequence_cnt = 0
        self._seq_aligned: Dict[int, bool] = {0: True}
        self._w_svin_R = np.eye(3)
        self._w_svin_t = np.zeros(3)

    def _draw_p3p(self, cur_index: int, old_index: int, valid: torch.Tensor,
                  num_hypotheses: int) -> torch.Tensor:
        g = torch.Generator(device=valid.device).manual_seed(cur_index * 7919 + old_index)
        return draw_hypotheses(valid, num_hypotheses, 3, g)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ------------------------------------------------------------- intake
    def add_keyframe(self, kf_export: dict) -> Optional[LoopInfo]:
        """Consume one VioEngine keyframe export; returns the loop if one was
        detected and verified (the optimization runs inline). Float32
        products run in full float32 (TF32 off) inside."""
        with _float32_matmuls():
            return self._add_keyframe(kf_export)

    def _add_keyframe(self, kf_export: dict) -> Optional[LoopInfo]:
        idx = len(self.keyframes)
        if idx >= self.capacity:
            self._grow_capacity()
        # deferred pose-graph optimization from fast-relocalized loops: below
        # the dense limit the lag is one keyframe; past it solves batch every
        # SOLVE_BATCH_KF keyframes
        if self._pending_optimize:
            due = (len(self.keyframes) <= DENSE_MAX_NODES
                   or len(self.keyframes) - self._last_solve_kf >= SOLVE_BATCH_KF)
            if due:
                self._pending_optimize = False
                self._optimize_and_update_drift()
        # sequence boundary: VIO restarted, zero the drift and the base shift
        seq = int(kf_export.get("sequence", 0))
        if seq != self.sequence_cnt:
            self.sequence_cnt = seq
            self._seq_aligned[seq] = False
            self._w_svin_R = np.eye(3)
            self._w_svin_t = np.zeros(3)
            self.yaw_drift = 0.0
            self.R_drift = np.eye(3)
            self.t_drift = np.zeros(3)
        T_raw = Transformation(r=np.asarray(kf_export["T_WC_r"], float),
                               q=np.asarray(kf_export["T_WC_q"], float))
        T_WC = Transformation(
            r=self._w_svin_R @ np.asarray(T_raw.r) + self._w_svin_t,
            q=npq.normalize(npq.multiply(npq.from_rotation_matrix(self._w_svin_R),
                                         np.asarray(T_raw.q))),
        )
        # health gate + robust pose: unhealthy keyframes feed the switching
        # estimator but are not processed
        t_kf = float(kf_export["timestamp"])
        if self.cfg.health.enable:
            health = check_health(
                self.cfg.health,
                int(kf_export.get("num_tracked", 0)),
                np.asarray(kf_export.get("quadrant_counts", np.zeros(4))),
                int(kf_export.get("num_new", 0)),
                np.asarray(kf_export.get("response_strengths", np.zeros(0))),
            )
        else:
            health = HealthStatus(True)
        robust = self.switching.add_keyframe(t_kf, T_WC, health)
        if robust is not None:
            self.robust_trajectory.append((t_kf, np.asarray(robust.r), np.asarray(robust.q)))
        if self.cfg.health.enable and not health.healthy:
            return None
        uv_raw = np.asarray(kf_export["keypoints_uv"], np.float32).reshape(-1, 2)
        M = min(uv_raw.shape[0], WINDOW_CAP)
        uv_pad = np.zeros((WINDOW_CAP, 2), np.float32)
        uv_pad[:M] = uv_raw[:M]
        valid_w = np.arange(WINDOW_CAP) < M
        with Timer("lc.1 describe_detect"):
            if "window_desc" in kf_export:
                # precomputed-descriptor intake (image-free)
                desc_w = np.zeros((WINDOW_CAP, 8), np.int32)
                dw = _words_np(kf_export["window_desc"])
                desc_w[: min(M, dw.shape[0])] = dw[:M]
                desc_e = _words_np(kf_export["extra_desc"])
                kp_e_uv = np.asarray(kf_export["extra_uv"], np.float32)
                kp_e_valid = np.asarray(kf_export["extra_valid"], bool)
            else:
                image = self._dev(np.asarray(kf_export["image"], np.float32))
                # window keypoints re-described on the keyframe image, padded
                # to WINDOW_CAP; fresh corners detected and described
                desc_w_d = desc_ops.describe(
                    image, self._dev(uv_pad), torch.zeros(WINDOW_CAP, device=self.device),
                    self._dev(valid_w))
                kp_e = detection.detect(image, max_keypoints=N_EXTRA_CORNERS)
                desc_e_d = desc_ops.describe(image, kp_e.uv, kp_e.angle, kp_e.valid)
                desc_w, desc_e, kp_e_uv, kp_e_valid = convert.to_numpy_tree(
                    (desc_w_d, desc_e_d, kp_e.uv, kp_e.valid))

        # covisibility graph from the export's per-point covisibility lists
        kf_counter: Dict[int, int] = {}
        for lst in kf_export.get("point_covisibilities", []) or []:
            for ek in lst:
                ik = self._kf_by_export.get(int(ek))
                if ik is not None:
                    kf_counter[ik] = kf_counter.get(ik, 0) + 1
        connected = [k for k, w in kf_counter.items() if w > COVIS_WEIGHT_TH]

        # the base-frame shift moves the keyframe's 3D points with its pose
        pts_W = np.asarray(kf_export["points_W"], float)
        if pts_W.size:
            pts_W = pts_W @ self._w_svin_R.T + self._w_svin_t
        kf = LoopKeyframe(
            index=idx, timestamp=float(kf_export["timestamp"]), T_WC_vio=T_WC,
            points_W=pts_W, point_uv=np.asarray(kf_export["keypoints_uv"], float),
            window_desc=desc_w, window_valid=valid_w, extra_uv=kp_e_uv, extra_desc=desc_e,
            extra_valid=kp_e_valid, sequence=seq, connected=connected,
        )
        if self.keep_images and "image" in kf_export:
            kf.debug_image = np.asarray(kf_export["image"])
        self.keyframes.append(kf)
        self._kf_by_export[int(kf_export.get("kf_index", idx))] = idx

        # pose-graph node from the drift-corrected VIO pose
        T_cor = self.apply_drift(T_WC)
        yaw, pitch, roll = matrix_to_ypr_np(npq.to_rotation_matrix(np.asarray(T_cor.q)))
        self.nodes.p[idx] = np.asarray(T_cor.r)
        self.nodes.yaw[idx] = yaw
        self.nodes.pitch[idx] = pitch
        self.nodes.roll[idx] = roll
        self.nodes.valid[idx] = True
        # sequential edges to the previous keyframes of the same sequence:
        # j = 1..2 in 4-DoF mode, 1..4 in 6-DoF mode
        n_back = 4 if self.cfg.loop_closure.pgo_mode == "6dof" else 2
        for back in range(1, n_back + 1):
            if idx - back >= 0 and self.keyframes[idx - back].sequence == seq:
                self._add_sequential_edge(idx - back, idx)

        # loop detection (database query before adding, recent ones excluded)
        loop, bow = self._detect_and_verify(kf)
        if bow is not None:
            self.db.add_vector(bow)
        else:
            self.db.add(np.concatenate([desc_w, desc_e]), np.concatenate([valid_w, kp_e_valid]))

        if loop is not None:
            self.loops.append(loop)
            kf.loop_index = loop.match_index
            kf.loop_rel_t = loop.rel_t
            kf.loop_rel_yaw = loop.rel_yaw
            self.earliest_loop_index = min(self.earliest_loop_index, loop.match_index)
            # first loop from a new sequence into an older one: align the new
            # sequence into the world frame with a yaw-only shift
            old_kf = self.keyframes[loop.match_index]
            if old_kf.sequence != kf.sequence and not self._seq_aligned.get(kf.sequence, True):
                self._align_sequence(kf, loop)
            self._add_loop_edge(loop)
            if self.cfg.fast_relocalization or len(self.keyframes) > DENSE_MAX_NODES:
                # immediate single-constraint re-anchor now, the full solve
                # deferred (forced past the dense limit, config or not)
                self._fast_relocalize(loop)
                self._pending_optimize = True
            else:
                self._optimize_and_update_drift()
            if self.loop_callback:
                self.loop_callback(loop)
        return loop

    def flush(self) -> None:
        """Run any deferred pose-graph optimization (end of sequence)."""
        if self._pending_optimize:
            self._pending_optimize = False
            with _float32_matmuls():
                self._optimize_and_update_drift()

    # ---------------------------------------------------------- internals
    def _vio_rel(self, i: int, j: int) -> Tuple[np.ndarray, float]:
        """Relative translation (in i's full camera frame) and yaw from the
        VIO poses."""
        Ti = self.keyframes[i].T_WC_vio
        Tj = self.keyframes[j].T_WC_vio
        Ri = npq.to_rotation_matrix(np.asarray(Ti.q))
        t_ij = Ri.T @ (np.asarray(Tj.r) - np.asarray(Ti.r))
        yaw_i = matrix_to_ypr_np(Ri)[0]
        yaw_j = matrix_to_ypr_np(npq.to_rotation_matrix(np.asarray(Tj.q)))[0]
        return t_ij, float(normalize_angle_np(yaw_j - yaw_i))

    def _vio_rel_full(self, i: int, j: int) -> Tuple[np.ndarray, np.ndarray]:
        """Full SE(3) relative i → j in i's camera frame (6-DoF edges)."""
        Ti = self.keyframes[i].T_WC_vio
        Tj = self.keyframes[j].T_WC_vio
        Ri = npq.to_rotation_matrix(np.asarray(Ti.q))
        t = Ri.T @ (np.asarray(Tj.r) - np.asarray(Ti.r))
        q = npq.multiply(npq.conjugate(np.asarray(Ti.q)), np.asarray(Tj.q))
        return t, q

    def _grow_capacity(self) -> None:
        """Double the pose-graph node arrays (the keyframe list is unbounded)."""
        old = self.capacity
        new = old * 2
        self.nodes = PoseGraphNodes(*(_pad(a, new) for a in self.nodes))
        self._grow_edges(new * 4)
        if self.earliest_loop_index == old:  # the "no loop yet" sentinel
            self.earliest_loop_index = new
        self.capacity = new

    def _grow_edges(self, e_new: int = 0) -> None:
        e_old = self.edges.i.shape[0]
        e_new = e_new or e_old * 2
        if e_new <= e_old:
            return
        self.edges = PoseGraphEdges(*(_pad(a, e_new) for a in self.edges))

    def _add_sequential_edge(self, i: int, j: int):
        t_ij, yaw_ij = self._vio_rel(i, j)
        k = self.n_edges
        if k >= self.edges.i.shape[0]:
            self._grow_edges()
        self._edges_full.append(self._vio_rel_full(i, j))
        e = self.edges
        e.i[k], e.j[k], e.t_ij[k], e.yaw_ij[k] = i, j, t_ij, yaw_ij
        e.weight[k], e.is_loop[k], e.valid[k] = 1.0, False, True
        self.n_edges += 1

    def _add_loop_edge(self, loop: LoopInfo):
        k = self.n_edges
        if k >= self.edges.i.shape[0]:
            self._grow_edges()
        if loop.rel_t_full is not None:
            self._edges_full.append((loop.rel_t_full, loop.rel_q_full))
        else:
            Rz = ypr_to_matrix_np(loop.rel_yaw, 0.0, 0.0)
            self._edges_full.append((loop.rel_t, npq.from_rotation_matrix(Rz)))
        e = self.edges
        e.i[k], e.j[k] = loop.match_index, loop.query_index
        e.t_ij[k], e.yaw_ij[k] = loop.rel_t, loop.rel_yaw
        # loop edges weigh as odometry edges; robustness comes from Huber
        e.weight[k], e.is_loop[k], e.valid[k] = 1.0, True, True
        self.n_edges += 1

    def _align_sequence(self, kf: LoopKeyframe, loop: LoopInfo) -> None:
        """Shift every keyframe of ``kf``'s (new) sequence into the world
        frame by the first cross-sequence loop: a yaw-only rotation +
        translation mapping the current keyframe's VIO pose onto the old
        keyframe's corrected pose composed with the loop relative."""
        old = loop.match_index
        R_old = ypr_to_matrix_np(self.nodes.yaw[old], self.nodes.pitch[old], self.nodes.roll[old])
        w_P_cur = R_old @ loop.rel_t + self.nodes.p[old]
        w_yaw_cur = float(self.nodes.yaw[old]) + loop.rel_yaw
        yaw_vio = float(matrix_to_ypr_np(npq.to_rotation_matrix(np.asarray(kf.T_WC_vio.q)))[0])
        shift_yaw = float(normalize_angle_np(w_yaw_cur - yaw_vio))
        Rz = ypr_to_matrix_np(shift_yaw, 0.0, 0.0)
        shift_t = w_P_cur - Rz @ np.asarray(kf.T_WC_vio.r)
        dq = npq.from_rotation_matrix(Rz)
        for k2 in self.keyframes:
            if k2.sequence != kf.sequence:
                continue
            k2.T_WC_vio = Transformation(
                r=Rz @ np.asarray(k2.T_WC_vio.r) + shift_t,
                q=npq.normalize(npq.multiply(dq, np.asarray(k2.T_WC_vio.q))),
            )
            if k2.points_W.size:
                k2.points_W = k2.points_W @ Rz.T + shift_t
            # re-seed the node at the shifted pose; the following solve refines it
            j = k2.index
            ypr_j = matrix_to_ypr_np(npq.to_rotation_matrix(np.asarray(k2.T_WC_vio.q)))
            self.nodes.p[j] = np.asarray(k2.T_WC_vio.r)
            self.nodes.yaw[j], self.nodes.pitch[j], self.nodes.roll[j] = ypr_j
        # later intake of this sequence arrives pre-shifted
        self._w_svin_R = Rz @ self._w_svin_R
        self._w_svin_t = Rz @ self._w_svin_t + shift_t
        self.yaw_drift = 0.0
        self.R_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        self._seq_aligned[kf.sequence] = True

    def _detect_and_verify(self, kf: LoopKeyframe):
        """(loop or None, the keyframe's BoW vector or None if none was
        computed)."""
        lc = self.cfg.loop_closure
        if not lc.enable:
            return None, None
        exclude_after = len(self.keyframes) - 1 - RECENCY_EXCLUSION
        if exclude_after <= 0:
            return None, None
        if int(kf.window_valid.sum()) < 5:
            return None, None
        all_desc = np.concatenate([kf.window_desc, kf.extra_desc])
        all_valid = np.concatenate([kf.window_valid, kf.extra_valid])
        # one quantization serves the query, the neighbour floor and the add
        with Timer("lc.2 bow"):
            v = self.db.bow(all_desc, all_valid)
        with Timer("lc.3 query"):
            idxs, scores = self.db.query_vector(v, top_k=4, exclude_after=exclude_after)
            # covisible-neighbour relative gate: a candidate must score at
            # least 0.6 of the weakest covisible link (the last 3 database
            # entries when there are no covisibility edges)
            neighbor_floor = 0.0
            if kf.connected:
                neighbor_floor = 0.6 * float(np.min(self.db.scores_at(v, kf.connected)))
            elif self.db.count >= 1:
                lo = max(0, self.db.count - 3)
                neighbor_floor = 0.6 * float(np.min(self.db.scores_range(v, lo, self.db.count)))
        self.stats["queries"] += 1
        with Timer("lc.4 verify"):
            for cand, score in zip(idxs, scores):
                if score < max(MIN_LOOP_SCORE, neighbor_floor):
                    self.stats["floor_reject"] += 1
                    continue
                self.stats["candidates"] += 1
                old = self.keyframes[int(cand)]
                self._debug_stage_candidate(kf, old)
                loop = self._verify(kf, old)
                if loop is not None:
                    self.stats["accepted"] += 1
                    return loop, v
        return None, v

    # ------------------------------------------------ debug stage images
    def _debug_ready(self, cur: LoopKeyframe, old: LoopKeyframe) -> bool:
        return self.debug is not None and cur.debug_image is not None and old.debug_image is not None

    def _debug_stage_candidate(self, cur: LoopKeyframe, old: LoopKeyframe):
        """loop_candidates/: query keypoints + candidate corners side by side."""
        if not self._debug_ready(cur, old):
            return
        from ..pipeline.outputs import draw_keypoints

        a = draw_keypoints(cur.debug_image, cur.point_uv, cur.window_valid)
        b = draw_keypoints(old.debug_image, np.asarray(old.extra_uv), np.asarray(old.extra_valid))
        h = max(a.shape[0], b.shape[0])
        canvas = np.zeros((h, a.shape[1] + b.shape[1]), np.float32)
        canvas[: a.shape[0], : a.shape[1]] = a
        canvas[: b.shape[0], a.shape[1]:] = b
        self.debug.save_image("loop_candidates", f"loop_candidate_{cur.index}_{old.index}", canvas,
                              caption=f"query {cur.index}  candidate {old.index}")

    def _debug_stage_matches(self, subdir: str, prefix: str, cur: LoopKeyframe, old: LoopKeyframe,
                             uv_cur: np.ndarray, uv_old: np.ndarray, caption: str):
        """descriptor_matched/ and pnp_verified/ correspondence images."""
        if not self._debug_ready(cur, old):
            return
        from ..pipeline.outputs import draw_matches

        m = len(uv_cur)
        pairs = np.stack([np.arange(m), np.arange(m)], 1)
        img = draw_matches(cur.debug_image, uv_cur, old.debug_image, uv_old, pairs)
        self.debug.save_image(subdir, f"{prefix}_{cur.index}_{old.index}", img, caption=caption)

    def _verify(self, cur: LoopKeyframe, old: LoopKeyframe) -> Optional[LoopInfo]:
        """Descriptor match cur-window (3D) → old corners (2D), then seed-free
        P3P RANSAC for the old camera's pose against the current 3D points."""
        lc = self.cfg.loop_closure
        with Timer("lc.4.1 match"):
            res = self.matcher(self._dev(cur.window_desc), self._dev(old.extra_desc),
                               self._dev(cur.window_valid), self._dev(old.extra_valid),
                               max_distance=DESC_DIST_LOOP, mutual=True)
            m, idx_b = convert.to_numpy_tree((res.valid, res.idx_b))
        if m.sum() < lc.min_correspondences:
            self.stats["desc_reject"] += 1
            return None
        sel = np.nonzero(m)[0]
        old_idx = idx_b[sel]
        self._debug_stage_matches(
            "descriptor_matched", "descriptor_match", cur, old,
            np.asarray(cur.point_uv)[sel], np.asarray(old.extra_uv)[old_idx],
            caption=f"query {cur.index}  match {old.index}  desc-matches {len(sel)}",
        )
        # fixed-size RANSAC problem (padded with invalid rows)
        n = min(len(sel), WINDOW_CAP)
        p_W_pad = np.zeros((WINDOW_CAP, 3))
        p_W_pad[:n] = cur.points_W[sel[:n]]
        uv_pad = np.zeros((WINDOW_CAP, 2), np.float32)
        uv_pad[:n] = np.asarray(old.extra_uv)[old_idx[:n]]
        with Timer("lc.4.2 p3p"):
            ransac_valid = self._dev(np.arange(WINDOW_CAP) < n)
            rays = back_project(self.camera, self._dev(uv_pad)).to(self.dtype)
            hyp = self.draw_p3p(cur.index, old.index, ransac_valid, lc.pnp_ransac_iterations)
            rr = absolute_pose_ransac_p3p(
                hyp, self._dev(p_W_pad, self.dtype), rays, ransac_valid,
                focal_px=self._focal_px, threshold_px=lc.pnp_reprojection_threshold,
                min_inliers=lc.min_correspondences,
            )
            rr = convert.to_numpy_tree(rr)
        if not bool(rr.success) or int(rr.num_inliers) < lc.min_correspondences:
            self.stats["pnp_reject"] += 1
            return None
        inl = np.asarray(rr.inliers)[:n].astype(bool)
        self._debug_stage_matches(
            "pnp_verified", "pnp_verified", cur, old,
            np.asarray(cur.point_uv)[sel[:n]][inl], np.asarray(old.extra_uv)[old_idx[:n]][inl],
            caption=f"current frame: {cur.index}  previous frame: {old.index}  "
                    f"pnp-inliers {int(rr.num_inliers)}",
        )
        # inlier-ratio gate: the pose must explain the majority of the matches
        if int(rr.num_inliers) < 0.5 * int(n):
            self.stats["ratio_reject"] += 1
            return None
        # the old camera's pose in the current VIO frame
        r_of, q_of = np.asarray(rr.T.r, float), np.asarray(rr.T.q, float)
        # relative old → cur in old's full camera frame
        R_of = npq.to_rotation_matrix(q_of)
        rel_t = R_of.T @ (np.asarray(cur.T_WC_vio.r) - r_of)
        yaw_o = matrix_to_ypr_np(R_of)[0]
        yaw_c = matrix_to_ypr_np(npq.to_rotation_matrix(np.asarray(cur.T_WC_vio.q)))[0]
        rel_yaw = float(normalize_angle_np(yaw_c - yaw_o))
        # sanity gates (|yaw| < 25°, ‖t‖ < 15 m by default)
        if abs(np.degrees(rel_yaw)) > lc.max_yaw_diff:
            self.stats["gate_reject"] += 1
            return None
        if np.linalg.norm(rel_t) > lc.max_position_diff:
            self.stats["gate_reject"] += 1
            return None
        return LoopInfo(
            query_index=cur.index, match_index=old.index, num_inliers=int(rr.num_inliers),
            rel_t=rel_t, rel_yaw=rel_yaw, rel_t_full=rel_t,
            rel_q_full=npq.multiply(npq.conjugate(q_of), np.asarray(cur.T_WC_vio.q)),
            uv_query=np.asarray(cur.point_uv)[sel[:n]][inl],
            uv_match=np.asarray(old.extra_uv)[old_idx[:n]][inl],
        )

    def _fast_relocalize(self, loop: LoopInfo) -> None:
        """Immediate drift update from one verified loop: the current
        keyframe re-anchored at the old keyframe's corrected pose composed
        with the relative (gates |rel yaw| < 30°, ‖rel t‖ < 20 m)."""
        if abs(np.degrees(loop.rel_yaw)) > 30.0 or np.linalg.norm(loop.rel_t) > 20.0:
            return
        old = loop.match_index
        p_old = self.nodes.p[old]
        R_old = ypr_to_matrix_np(self.nodes.yaw[old], self.nodes.pitch[old], self.nodes.roll[old])
        w_P_cur = R_old @ loop.rel_t + p_old
        yaw_w_cur = float(self.nodes.yaw[old]) + loop.rel_yaw
        kf = self.keyframes[loop.query_index]
        yaw_vio = float(matrix_to_ypr_np(npq.to_rotation_matrix(np.asarray(kf.T_WC_vio.q)))[0])
        self.yaw_drift = float(normalize_angle_np(yaw_w_cur - yaw_vio))
        Rz = ypr_to_matrix_np(self.yaw_drift, 0.0, 0.0)
        self.R_drift = Rz
        self.t_drift = w_P_cur - Rz @ np.asarray(kf.T_WC_vio.r)

    def _pg_edge_residuals(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per valid edge: (edge index, 4-DoF residual norm with metres and
        radians in one norm, is_loop)."""
        n = self.n_edges
        e, nd = self.edges, self.nodes
        kk = np.nonzero(e.valid[:n])[0]
        if len(kk) == 0:
            return kk, np.zeros(0), np.zeros(0, bool)
        i, j = e.i[kk], e.j[kk]
        cy, sy = np.cos(nd.yaw[i]), np.sin(nd.yaw[i])
        cp, sp = np.cos(nd.pitch[i]), np.sin(nd.pitch[i])
        cr, sr = np.cos(nd.roll[i]), np.sin(nd.roll[i])
        R = np.empty((len(kk), 3, 3))
        R[:, 0, 0] = cy * cp
        R[:, 0, 1] = cy * sp * sr - sy * cr
        R[:, 0, 2] = cy * sp * cr + sy * sr
        R[:, 1, 0] = sy * cp
        R[:, 1, 1] = sy * sp * sr + cy * cr
        R[:, 1, 2] = sy * sp * cr - cy * sr
        R[:, 2, 0] = -sp
        R[:, 2, 1] = cp * sr
        R[:, 2, 2] = cp * cr
        d = nd.p[j] - nd.p[i]
        rt = np.einsum("kab,ka->kb", R, d) - e.t_ij[kk]
        ry = np.asarray(normalize_angle_np(nd.yaw[j] - nd.yaw[i] - e.yaw_ij[kk]))
        rn = np.sqrt(np.sum(rt * rt, axis=1) + ry * ry)
        return kk, rn, np.asarray(e.is_loop[kk], bool)

    def _pg_cost_np(self) -> Tuple[float, float]:
        """Host 4-DoF edge cost over valid edges, (sequential, loop)."""
        kk, rn, il = self._pg_edge_residuals()
        r2 = rn * rn
        return float(r2[~il].sum()), float(r2[il].sum())

    def _prune_outlier_loops(self) -> int:
        """Disable (permanently) valid loop edges whose post-solve residual
        exceeds max(10x the median loop residual, 0.5); returns how many."""
        kk, rn, il = self._pg_edge_residuals()
        loops = kk[il]
        if len(loops) < 3:
            return 0
        r_loop = rn[il]
        thr = max(10.0 * float(np.median(r_loop)), 0.5)
        bad = loops[r_loop > thr]
        if len(bad) == 0:
            return 0
        self.edges.valid[bad] = False
        self.stats["pruned_edges"] = self.stats.get("pruned_edges", 0) + int(len(bad))
        return int(len(bad))

    def _optimize_and_update_drift(self):
        with Timer("lc.5 pose_graph"):
            t_solve0 = time.perf_counter()
            cost0 = self._pg_cost_np()
            # fix everything up to and including the earliest looped keyframe
            fix_before = max(self.earliest_loop_index + 1, 1)
            self._solve_once(fix_before)
            # post-solve loop-edge outlier rejection + one re-solve without them
            if self._prune_outlier_loops() > 0:
                self._solve_once(fix_before)
            self._update_drift_and_log(cost0, t_solve0)

    def _prefix(self) -> Tuple[int, int]:
        """(Np, Ep): the occupied node and edge prefix, padded to powers of
        two (at least 64 and 128) within the tables."""
        n_used = max(len(self.keyframes), 2)
        Np = min(max(64, 1 << (n_used - 1).bit_length()), self.nodes.p.shape[0])
        Ep = min(max(128, 1 << (max(self.n_edges, 1) - 1).bit_length()), self.edges.i.shape[0])
        return Np, Ep

    def _solve_once(self, fix_before: int) -> None:
        if self.cfg.loop_closure.pgo_mode == "6dof":
            self._optimize_6dof(fix_before)
            return
        Np, Ep = self._prefix()
        if Np > DENSE_MAX_NODES:
            raise NotImplementedError(
                f"LoopCloser: a 4-DoF pose graph of {Np} nodes needs the banded solver "
                f"(svin_tpu/parallel/pg_band.py, optimize_4dof_banded), which is not ported; "
                f"the dense solve stops at {DENSE_MAX_NODES} nodes")
        nodes_s = PoseGraphNodes(*(self._dev(a[:Np], self.dtype if a.dtype.kind == "f" else None)
                                   for a in self.nodes))
        edges_s = PoseGraphEdges(*(self._dev(a[:Ep], self.dtype if a.dtype.kind == "f" else None)
                                   for a in self.edges))
        out = convert.to_numpy_tree(
            optimize_4dof(nodes_s, edges_s, fix_before, iters=self.pgo_gn_iters))
        self.nodes.p[:Np] = out.p
        self.nodes.yaw[:Np] = out.yaw

    def _update_drift_and_log(self, cost0, t_solve0) -> None:
        # drift: the newest node's optimized pose against its raw VIO pose
        last = len(self.keyframes) - 1
        kf = self.keyframes[last]
        if self.cfg.loop_closure.pgo_mode == "6dof":
            R_opt = ypr_to_matrix_np(self.nodes.yaw[last], self.nodes.pitch[last],
                                     self.nodes.roll[last])
            R_vio = npq.to_rotation_matrix(np.asarray(kf.T_WC_vio.q))
            self.R_drift = R_opt @ R_vio.T
            self.yaw_drift = float(matrix_to_ypr_np(self.R_drift)[0])
        else:
            yaw_vio = float(matrix_to_ypr_np(npq.to_rotation_matrix(np.asarray(kf.T_WC_vio.q)))[0])
            yaw_opt = float(self.nodes.yaw[last])
            self.yaw_drift = float(normalize_angle_np(yaw_opt - yaw_vio))
            self.R_drift = ypr_to_matrix_np(self.yaw_drift, 0.0, 0.0)
        self.t_drift = self.nodes.p[last] - self.R_drift @ np.asarray(kf.T_WC_vio.r)
        cost1 = self._pg_cost_np()
        n_used = len(self.keyframes)
        self._last_solve_kf = n_used
        self.pgo_log.append({
            "n_nodes": n_used,
            "n_edges": int(self.n_edges),
            "mode": self.cfg.loop_closure.pgo_mode,
            "branch": "scalable" if n_used > DENSE_MAX_NODES else "dense",
            "cost_seq_before": round(cost0[0], 5),
            "cost_loop_before": round(cost0[1], 5),
            "cost_seq_after": round(cost1[0], 5),
            "cost_loop_after": round(cost1[1], 5),
            "t_drift_norm": round(float(np.linalg.norm(self.t_drift)), 4),
            "yaw_drift_deg": round(float(np.degrees(self.yaw_drift)), 3),
            "wall_s": round(time.perf_counter() - t_solve0, 3),
        })

    def _optimize_6dof(self, fix_before: int) -> None:
        """Full-SE(3) pose-graph solve (sqrt information diag(20,20,20,100,
        100,57.3) sequential, diag(...,100) + Huber loop); the nodes are
        written back into the shared yaw/pitch/roll table."""
        Np, Ep = self._prefix()
        if Np > DENSE_MAX_NODES:
            raise NotImplementedError(
                f"LoopCloser: a 6-DoF pose graph of {Np} nodes needs the matrix-free PCG "
                f"(svin_tpu/parallel/pcg.py, optimize_6dof_pcg), which is not ported; the "
                f"dense solve stops at {DENSE_MAX_NODES} nodes")
        f = lambda a: self._dev(a, self.dtype)  # noqa: E731
        q = quat.from_rotation_matrix(ypr_to_matrix(
            f(self.nodes.yaw[:Np]), f(self.nodes.pitch[:Np]), f(self.nodes.roll[:Np])))
        nodes6 = PoseGraph6Nodes(r=f(self.nodes.p[:Np]), q=q, valid=self._dev(self.nodes.valid[:Np]))
        E = Ep
        t_full = np.zeros((E, 3))
        q_full = np.zeros((E, 4))
        q_full[:, 3] = 1.0
        ne = min(len(self._edges_full), E)
        if ne:
            t_full[:ne] = np.stack([t for t, _ in self._edges_full[:ne]])
            q_full[:ne] = np.stack([q for _, q in self._edges_full[:ne]])
        W_seq = np.diag([20.0, 20.0, 20.0, 100.0, 100.0, 57.3])
        W_loop = np.diag([20.0, 20.0, 20.0, 100.0, 100.0, 100.0])
        il = np.asarray(self.edges.is_loop[:E], bool)
        sqrt_info = np.where(il[:, None, None], W_loop[None, :, :], W_seq[None, :, :])
        edges6 = PoseGraph6Edges(
            i=self._dev(self.edges.i[:E]), j=self._dev(self.edges.j[:E]), t_ij=f(t_full),
            q_ij=f(q_full), sqrt_info=f(sqrt_info), valid=self._dev(self.edges.valid[:E]),
            is_loop=self._dev(il),
        )
        out = optimize_6dof(nodes6, edges6, fix_before, iters=max(10, self.pgo_gn_iters // 3))
        ypr = torch.stack(matrix_to_ypr(quat.to_rotation_matrix(out.q)), dim=-1)
        out_r, ypr = convert.to_numpy_tree((out.r, ypr))
        self.nodes.p[:Np] = out_r
        self.nodes.yaw[:Np] = ypr[:, 0]
        self.nodes.pitch[:Np] = ypr[:, 1]
        self.nodes.roll[:Np] = ypr[:, 2]

    def add_primitive_pose(self, t: float, T: Transformation) -> None:
        """Dead-reckoning odometry for the switching estimator."""
        self.switching.add_primitive_pose(float(t), T)

    def save_switch_info(self, path: str) -> None:
        with open(path, "w") as f:
            for t, msg in self.switching.switch_log:
                f.write(f"{t:.6f} {msg}\n")

    # ------------------------------------------------------------- output
    def apply_drift(self, T_WC: Transformation) -> Transformation:
        """Drift-corrected pose for a raw VIO pose."""
        Rd = np.asarray(self.R_drift)
        dq = npq.from_rotation_matrix(Rd)
        return Transformation(r=Rd @ np.asarray(T_WC.r) + self.t_drift,
                              q=npq.normalize(npq.multiply(dq, np.asarray(T_WC.q))))

    def optimized_path(self) -> np.ndarray:
        n = len(self.keyframes)
        return self.nodes.p[:n].copy()

    def corrected_keyframe_poses(self) -> Dict[int, Transformation]:
        """Loop-corrected pose per keyframe index (for GlobalMap.update_after_loop)."""
        out: Dict[int, Transformation] = {}
        for k in range(len(self.keyframes)):
            R = ypr_to_matrix_np(self.nodes.yaw[k], self.nodes.pitch[k], self.nodes.roll[k])
            out[k] = Transformation(r=self.nodes.p[k], q=npq.from_rotation_matrix(R))
        return out

    def save_trajectory_tum(self, path: str):
        """TUM export of the loop-corrected keyframe path."""
        n = len(self.keyframes)
        with open(path, "w") as f:
            for k in range(n):
                p = self.nodes.p[k]
                R = ypr_to_matrix_np(self.nodes.yaw[k], self.nodes.pitch[k], self.nodes.roll[k])
                q = npq.from_rotation_matrix(R)
                t = self.keyframes[k].timestamp
                f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
