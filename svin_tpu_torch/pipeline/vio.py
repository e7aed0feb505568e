"""The VIO engine: deterministic host pipeline around the device programs.

Counterpart of the JAX package's ``pipeline/vio.py``. The serial path
(``VioEngine.add_frame``) is a single-threaded, deterministic stage sequence
per frame:

  add_imu/depth/sonar → buffered;  add_frame:
    1. preprocess + detect + describe          (device, one program, all cameras)
    2. IMU preintegrate + propagate prediction (device)
    3. match keypoints ↔ window landmarks with projection gating + RANSAC (device)
    4. new-landmark creation via stereo (or temporal) match + triangulation (device)
    5. state creation + factor table update    (host bookkeeping, numpy)
    6. optimize + fused marginalization + prune errors (device, LM + Schur)
    7. marginalization policy bookkeeping      (host)
    8. outputs: state callback, keyframe export (the pose_graph ABI)

The bookkeeping state (window and factor tables, landmark descriptors and
covariances, frame records) lives on the host as numpy, in the port's
NamedTuples; each program uploads what it reads and the engine fetches its
outputs at the same points as the JAX engine (one ``to_numpy_tree`` per
fetch). Device programs are the pure functions of ``pipeline/programs.py``;
``solve`` and ``matcher`` are threaded through to them, so the same engine
runs with the CUDA kernels (the defaults, on a CUDA device) or with their
plain versions. The engine runs on ``cuda`` unless the caller names another
device (the CPU tests pass ``device="cpu"``). ``add_frame``,
``frontend_stage`` and ``backend_step`` turn TF32 off for their duration
(``_float32_matmuls``, safe with two threads inside), and each is one frame
of the spans (``utils.timing``: ``2.0 frame_total`` and its stages, ``3.3
kf_callback`` around the app's keyframe callback).

The pipelined path splits a frame in two (driven by ``AsyncVioEngine`` in
``pipeline/async_vio.py``, or on one thread):

- ``frontend_stage``: preprocess + detect + describe at an attitude
  dead-reckoned on the host from the newest window state. It touches no
  mutable engine state and runs its device work on a CUDA stream of its
  own, so it can run on a second thread beside ``backend_step``.
- ``backend_step``: keeps one optimize(+marginalize) program in flight.
  Frame k+1's IMU propagation, map matching and speculative stereo are
  queued behind frame k's solve, reading its un-fetched window; one
  ``to_numpy_tree`` then fetches all of it; frame k is finalized and frame
  k+1's solve queued without a fetch. Results come out one frame late;
  ``backend_flush`` drains the last.

RANSAC samples are drawn on the device by ``draw_hypotheses(seed, sub,
valid, num_hypotheses, sample_size)``, seeded from the same host
``RandomState(1234)`` sequence as the JAX engine's PRNG keys (``sub`` is
None for the map-matching RANSAC, 0/1 for the two halves of the temporal
bootstrap's split key); a test replaces it with the JAX engine's draws.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..convert import array_to_tensor, from_numpy_tree, to_numpy_tree
from ..estimator import WindowConfig, empty_factors, empty_window, marginalize_slot, rig_params
from ..frontend import ScaleRefiner, draw_hypotheses as _draw
from ..frontend.hull import keyframe_overlap_ratio
from ..imu import init_pose_from_imu, preintegrate
from ..kinematics import Transformation, npq
from ..ops import detection
from ..ops.hamming import match_descriptors
from ..ops.solve import solve_spd
from ..utils import Timer, timing
from . import programs
from .config import VioConfig

TEMPORAL_IMU_OVERLAP = 0.02  # s (reference ThreadedKFVio.cpp:87)

_LOG = logging.getLogger("svin_tpu_torch")


def _as_uint8(img) -> np.ndarray:
    """Host image → uint8: 8-bit images pass through, float images in [0, 1]
    are quantized (what a mono8 camera delivers)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    return a


def _as_upload(img, device):
    """Host image → the upload form, a uint8 tensor on ``device``
    (``_as_uint8``, then ``array_to_tensor``); tensors already on the
    engine's device pass through untouched."""
    if isinstance(img, torch.Tensor):
        return img.to(device)
    return array_to_tensor(_as_uint8(img), device)


_TF32_LOCK = threading.Lock()
_tf32_inside = 0  # threads (or nested blocks) inside _float32_matmuls
_tf32_saved = None  # the caller's flags, saved by the first one in


@contextlib.contextmanager
def _float32_matmuls():
    """float32 matmuls and convolutions in full float32 (TF32 off) for the
    block. The flags are process-global, so blocks on several threads share
    one entry count: the first in saves the caller's settings and turns TF32
    off, the last out restores them."""
    global _tf32_inside, _tf32_saved
    with _TF32_LOCK:
        if _tf32_inside == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_inside += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_inside -= 1
            if _tf32_inside == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _tf32_saved


def torch_draw(seed: int, sub: Optional[int], valid: torch.Tensor, num_hypotheses: int,
               sample_size: int) -> torch.Tensor:
    """The engine's default RANSAC draw: a device generator seeded from
    (seed, sub), uniform without replacement over the valid entries."""
    g = torch.Generator(device=valid.device)
    g.manual_seed(int(seed) * 4 + (0 if sub is None else 1 + int(sub)))
    return _draw(valid, num_hypotheses, sample_size, g)


@dataclass
class FrameResult:
    """Per-frame output (state callback payload)."""

    timestamp: float
    T_WS: Transformation
    speed_bias: np.ndarray
    is_keyframe: bool
    num_tracked: int
    num_new_landmarks: int
    cost: float
    keyframe_export: Optional[dict] = None
    # accepted LM steps in this frame's optimize
    lm_iterations: int = 0


@dataclass
class _PendingOpt:
    """An in-flight optimize(+marginalize) program of the pipelined
    backend: its un-fetched outputs and the host context that finalizes the
    frame once the next backend step (or the flush) fetches them."""

    opt_out: tuple  # the opt program's output tensors
    win_dev: object  # its window (after the fused marginalization), for chaining
    victim: Optional[int]
    lm_valid_before: Optional[np.ndarray]
    slot_post: int  # the frame's slot after the fused marginalization
    t: float
    images: list
    is_kf: bool
    n_tracked: int
    n_new: int
    t_dispatch: float
    static_iters: int = 0
    # a keyframe's processed cam0 image on the device, fetched with the
    # opt outputs (one fetch per step) for its export
    image0: Optional[torch.Tensor] = None


@dataclass
class _FrameData:
    """Host-side per-frame record for matching (per camera arrays)."""

    timestamp: float
    kp_uv: List[np.ndarray]
    kp_desc: List[np.ndarray]  # (K, 8) int32 words
    kp_valid: List[np.ndarray]
    kp_landmark: List[np.ndarray]  # (K,) landmark slot per keypoint or -1
    kp_score: List[np.ndarray]
    kp_octave: List[np.ndarray]  # (K,) pyramid level per keypoint
    # preprocessed cam0 image, uint8, left on the device until a keyframe
    # export fetches it
    image0: Optional[torch.Tensor] = None
    # recorded on the frontend stream after the frame's device work (CUDA
    # frames of frontend_stage); the backend's stream waits on it
    ready: Optional[torch.cuda.Event] = None


class VioEngine:
    """Deterministic sonar-visual-inertial-depth odometry engine."""

    def __init__(self, config: VioConfig, rig=None, dtype=None, device=None,
                 solve=solve_spd, matcher=match_descriptors):
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VioEngine: no CUDA device; pass device='cpu' to run on the CPU")
        if dtype is None:
            dtype = torch.float32 if self.device.type == "cuda" else torch.float64
        self.dtype = dtype
        self.cfg = config
        self.rig = rig if rig is not None else config.build_rig(dtype, self.device)
        self.rig_p = rig_params(self.rig, dtype, self.device)
        self.solve, self.matcher = solve, matcher
        S = config.num_keyframes + config.num_imu_frames
        estimate_ext = (
            config.sigma_absolute_translation > 1e-16 and config.sigma_absolute_orientation > 1e-16
        ) or (
            config.sigma_c_relative_translation > 1e-12
            and config.sigma_c_relative_orientation > 1e-12
        )
        self.wcfg = WindowConfig(
            num_states=S, num_landmarks=512, num_obs=4096, max_iterations=config.max_iterations,
            num_cameras=self.rig.num_cameras, estimate_extrinsics=estimate_ext,
        )
        window = empty_window(self.wcfg, dtype, rig=self.rig_p, device=self.device)
        factors = empty_factors(self.wcfg, dtype, device=self.device)
        if estimate_ext:
            # absolute extrinsics prior at the config values; with only a
            # random-walk sigma the initial anchor is one second of walk
            sat = config.sigma_absolute_translation or config.sigma_c_relative_translation
            sao = config.sigma_absolute_orientation or config.sigma_c_relative_orientation
            si = torch.diag(torch.tensor([1.0 / sat] * 3 + [1.0 / sao] * 3, dtype=dtype,
                                         device=self.device))
            factors = factors._replace(ext_prior=factors.ext_prior._replace(
                mean_r=window.ext_r.clone(), mean_q=window.ext_q.clone(),
                sqrt_info=si.repeat(self.rig.num_cameras, 1, 1),
                valid=torch.ones(self.rig.num_cameras, dtype=torch.bool, device=self.device),
            ))
        # ---- bookkeeping state lives on the HOST as numpy ----
        self.window = to_numpy_tree(window)
        self.factors = to_numpy_tree(factors)
        self._lm_desc = np.zeros((self.wcfg.num_landmarks, 8), np.int32)
        self._lm_cov = np.tile(np.eye(3) * self._LM_COV_DEFAULT, (self.wcfg.num_landmarks, 1, 1))

        # focal lengths and image diagonal as host numbers (read once: a
        # device scalar read would wait on the device)
        cams = self.rig.cameras
        self._focal = [float(c.fu) for c in cams]
        self._diag = [float(np.hypot(c.width, c.height)) for c in cams]

        self._opt_programs: Dict[tuple, Callable] = {}
        # the two static LM bounds: the full config bound and a short
        # variant at half (≥ minIterations) for budget-limited frames
        self._opt_bounds = sorted({
            max(self.cfg.min_iterations, 1, (config.max_iterations + 1) // 2),
            config.max_iterations,
        })
        # real-time iteration governor: rolling per-LM-iteration wall time;
        # the per-frame budget ``timeLimit`` caps iterations at
        # clip(timeLimit / iter_time, minIterations, maxIterations)
        self._opt_iter_ema: Optional[float] = None
        self._opt_calls = 0
        self.draw_hypotheses = torch_draw

        self.imu_t: List[float] = []
        self.imu_gyro: List[np.ndarray] = []
        self.imu_acc: List[np.ndarray] = []
        # pipelined-backend state: the in-flight optimize of the previous
        # frame; the lock serializing IMU-buffer access between the feeding
        # thread and the frontend/backend stages; the frontend's own stream
        self._pending: Optional[_PendingOpt] = None
        self._imu_mutex = threading.Lock()
        self._fe_stream = (torch.cuda.Stream(device=self.device)
                           if self.device.type == "cuda" else None)
        self.depth_buffer: List[tuple] = []  # (t, depth)
        self.sonar_buffer: List[tuple] = []  # (t, range, heading)
        self.first_depth: Optional[float] = None
        self.n_states = 0  # valid slots in window
        self.frames: Dict[int, _FrameData] = {}  # slot -> frame data
        self.last_kf_slot: Optional[int] = None
        self._track_miss_streak = 0  # widens the projection gate on losses
        self._cost_last = 0.0
        self._lm_iterations_last = 0
        # camera-pair passes where rotation-only RANSAC beat the relative pose
        self.rotation_only_detections = 0
        # detection_options.threshold mapped into the Harris response units
        self._detect_threshold = float(np.float32(
            config.detection_threshold * detection.BRISK_THRESHOLD_SCALE))
        self.frame_count = 0
        self.kf_count = 0
        # state-id → exported keyframe index (kf_count at export time)
        self._kf_index_by_state_id: Dict[int, int] = {}
        self.sequence = 0
        self.next_state_id = 0
        self.next_lm_id = 0
        self.state_callback: Optional[Callable[[FrameResult], None]] = None
        self.keyframe_callback: Optional[Callable[[dict], None]] = None
        self.trajectory: List[tuple] = []  # (t, r, q) of latest estimates
        self._rng = np.random.RandomState(1234)
        # one-shot scale-refinement diagnostic over the first keyframes
        # (reports, never rescales)
        self.scale_refiner = ScaleRefiner(r_SC=self.rig.T_SC[0].r.cpu().numpy().astype(float))
        self._last_ransac_T_WS: Optional[Transformation] = None
        self._scale_last_t: Optional[float] = None

    # ------------------------------------------------------------ transfer
    def _dev(self, a, dtype=None) -> torch.Tensor:
        """Host array → tensor on the engine's device (floats in the
        engine's dtype, uint32 words as their int32 view;
        ``array_to_tensor``: no host wait on a card). A tensor (an
        un-fetched program output) passes through."""
        if isinstance(a, torch.Tensor):
            return a
        return array_to_tensor(a, self.device, dtype or self.dtype)

    def _up(self, tree):
        """Host numpy tree (window, factors) → tensors on the device."""
        return from_numpy_tree(tree, self.device, self.dtype)

    # ------------------------------------------------------------------ IMU
    def add_imu_measurement(self, t: float, gyro, acc) -> None:
        with self._imu_mutex:
            self.imu_t.append(float(t))
            self.imu_gyro.append(np.asarray(gyro, float))
            self.imu_acc.append(np.asarray(acc, float))
            if len(self.imu_t) > 10000:  # trim very old IMU
                del self.imu_t[:2000], self.imu_gyro[:2000], self.imu_acc[:2000]

    def add_depth_measurement(self, t: float, depth: float) -> None:
        if self.first_depth is None:
            self.first_depth = float(depth)
        self.depth_buffer.append((float(t), float(depth)))

    def add_sonar_measurement(self, t: float, range_m: float, heading: float) -> None:
        self.sonar_buffer.append((float(t), float(range_m), float(heading)))

    def _imu_slice(self, t0: float, t1: float):
        """The buffered IMU samples covering [t0, t1] (with the temporal
        overlap) as (t, gyro, acc, mask), or None with fewer than two. The
        JAX engine pads slices to a multiple of 64 samples with masked
        entries so that its compiled scan sees few distinct lengths; a
        masked segment changes nothing, and eager PyTorch compiles nothing,
        so here the slice has its own length and every sample is valid."""
        with self._imu_mutex:
            t = np.asarray(self.imu_t)
            m = (t >= t0 - TEMPORAL_IMU_OVERLAP) & (t <= t1 + TEMPORAL_IMU_OVERLAP)
            idx = np.nonzero(m)[0]
            if len(idx) < 2:
                return None
            return (t[idx], np.stack([self.imu_gyro[i] for i in idx]),
                    np.stack([self.imu_acc[i] for i in idx]), np.ones(len(idx), bool))

    def _preintegrate(self, t0: float, t1: float, bias):
        """Host-numpy Preintegral over [t0, t1] (None without IMU data)."""
        sl = self._imu_slice(t0, t1)
        if sl is None:
            return None
        ts, gy, ac, mask = sl
        return to_numpy_tree(preintegrate(
            self._dev(ts), self._dev(gy), self._dev(ac), self._dev(mask),
            self._dev(t0), self._dev(t1), self._dev(bias), self.cfg.imu,
        ))

    def _T_WC_np(self, T_WS: Transformation, ci: int):
        """(r, q) of T_WS ∘ T_SC as host numpy."""
        return npq.compose_rq(np.asarray(T_WS.r), np.asarray(T_WS.q),
                              self.window.ext_r[ci], self.window.ext_q[ci])

    # ------------------------------------------------------------- frontend
    def _frontend(self, stacked, g_C):
        return programs.frontend_batch(
            stacked, g_C, self._detect_threshold,
            max_keypoints=self.cfg.max_keypoints, octaves=self.cfg.detection_octaves,
            histogram_method=self.cfg.histogram_method,
            clahe_clip_limit=self.cfg.clahe_clip_limit, resize_factor=self.cfg.resize_factor,
            clahe_tiles=self.cfg.clahe_tiles,
        )

    def _detect_describe(self, images, T_WS_pred: Transformation, extra=None):
        """Stage 1: preprocess + detect + describe every camera image, all
        same-shape cameras as one batched program. ``T_WS_pred`` may hold
        device tensors (the un-fetched IMU propagation): the gravity
        directions then compute on the device, and ``extra`` (device
        outputs) is fetched together with the keypoints. Returns per-camera
        host arrays (uv, desc, valid, score, octave), cam0's processed image
        (on the device), and the fetched ``extra`` when given."""
        if isinstance(T_WS_pred.q, torch.Tensor):
            g_C_all = programs.gravity_dirs(T_WS_pred.q, self._dev(self.window.ext_q))
        else:
            # gravity-aligned extraction direction
            g_Cs = []
            for ci in range(len(images)):
                _, q_WC = npq.compose_rq(np.asarray(T_WS_pred.r), np.asarray(T_WS_pred.q),
                                         self.window.ext_r[ci], self.window.ext_q[ci])
                g_Cs.append(npq.rotate(npq.conjugate(q_WC), np.array([0.0, 0.0, -1.0])))
            g_C_all = self._dev(np.stack(g_Cs), torch.float32)
        ups = [_as_upload(i, self.device) for i in images]
        if len({tuple(u.shape) for u in ups}) == 1:
            outs = [self._frontend(torch.stack(ups), g_C_all)]
        else:
            outs = [self._frontend(u[None], g_C_all[ci:ci + 1]) for ci, u in enumerate(ups)]
        fetch = [o[:5] for o in outs]
        with Timer("2.1.2 detect_fetch"):
            host = to_numpy_tree(fetch if extra is None else (fetch, extra))
        per_prog = host if extra is None else host[0]
        cols = [[], [], [], [], []]
        for out in per_prog:
            for k in range(5):
                cols[k].extend(out[k][c] for c in range(out[k].shape[0]))
        res = tuple(cols) + (outs[0][5],)
        return res if extra is None else res + (host[1],)

    def _new_frame(self, t, images, uvs, descs, valids, scores, octs, img0) -> _FrameData:
        return _FrameData(
            timestamp=t, kp_uv=uvs, kp_desc=descs, kp_valid=valids,
            kp_landmark=[np.full(self.cfg.max_keypoints, -1, np.int64) for _ in images],
            kp_score=scores, kp_octave=[np.asarray(o) for o in octs], image0=img0,
        )

    # --------------------------------------------------------- factor admin
    def _add_observations(self, rows: List[tuple]):
        """rows: (uv(2,), state_slot, lm_slot, cam_idx, sqrt_info)"""
        if not rows:
            return
        f = self.factors.reproj
        free = np.nonzero(~f.valid)[0]
        n = min(len(rows), len(free))
        if n < len(rows):
            # observation table full: tail factors are dropped (they re-enter
            # on later frames via match-to-map)
            _LOG.warning("observation table full: dropping %d of %d new rows (num_obs=%d)",
                         len(rows) - n, len(rows), self.wcfg.num_obs)
            rows = rows[:n]
        idx = free[:n]
        f.uv[idx] = np.stack([r[0] for r in rows])
        f.state_idx[idx] = [r[1] for r in rows]
        f.lm_idx[idx] = [r[2] for r in rows]
        f.cam_idx[idx] = [r[3] for r in rows]
        f.sqrt_info[idx] = [r[4] for r in rows]
        f.valid[idx] = True

    def _allocate_landmarks(self, points_W: np.ndarray, descs, covs: np.ndarray = None) -> np.ndarray:
        """Allocate landmark slots; returns slot indices (-1 on overflow).
        ``covs`` (n,3,3) is the creation-time triangulation covariance."""
        free = np.nonzero(~self.window.lm_valid)[0]
        n = min(len(points_W), len(free))
        slots = np.full(len(points_W), -1, np.int32)
        if n == 0:
            return slots
        slots[:n] = free[:n]
        sl = free[:n]
        self.window.hp_W[sl, :3] = points_W[:n]
        self.window.hp_W[sl, 3] = 1.0
        self.window.lm_valid[sl] = True
        self.window.lm_id[sl] = np.arange(self.next_lm_id, self.next_lm_id + n, dtype=np.int32)
        self._lm_desc[sl] = np.asarray(descs[:n])
        if covs is not None:
            self._lm_cov[sl] = np.asarray(covs[:n])
        else:
            self._lm_cov[sl] = np.eye(3) * self._LM_COV_DEFAULT
        # a reclaimed slot must not inherit the previous landmark's prior
        self.factors.lm_prior.valid[sl] = False
        self.next_lm_id += n
        return slots

    def set_landmark_prior(self, slot: int, mean, sigma: float = 0.05) -> None:
        """Anchor a landmark with a Gaussian position prior."""
        lp = self.factors.lm_prior
        lp.mean[slot] = np.asarray(mean, float)
        lp.sqrt_info[slot] = np.eye(3) / float(sigma)
        lp.valid[slot] = True

    # ------------------------------------------------------------ main step
    def add_frame(self, t: float, images) -> Optional[FrameResult]:
        """Feed one synchronized multi-camera frame (blocking mode). The
        image timestamp is shifted by ``imageDelay`` first."""
        t = float(t) - self.cfg.image_delay
        with _float32_matmuls(), timing.frame():
            if self.n_states == 0:
                return self._initialize(t, images)
            with Timer("2.0 frame_total"):
                return self._track(t, images)

    # ------------------------------------------------- pipelined backend
    def frontend_stage(self, t: float, images):
        """Stage 1 of the pipelined engine: preprocess + detect + describe,
        the gravity-aligned extraction direction from an attitude
        dead-reckoned on the host. Touches no mutable engine state, so it
        may run on a second thread beside ``backend_step``; on CUDA its
        device work runs on the engine's frontend stream. Returns (shifted
        t, frame record)."""
        t = float(t) - self.cfg.image_delay
        T_att = self._attitude_prediction(t)
        with _float32_matmuls(), timing.frame(), self._frontend_stream(images):
            fd = self._new_frame(t, images, *self._detect_describe(images, T_att))
            if self._fe_stream is not None:
                # the backend's stream waits on this before reading image0
                fd.ready = torch.cuda.Event()
                fd.ready.record(self._fe_stream)
        return t, fd

    @contextlib.contextmanager
    def _frontend_stream(self, images):
        """The frontend stream as the calling thread's current stream (CUDA
        engines). It waits on the caller's stream only for images already
        on the device (the caller's own work made them); host images upload
        on the frontend stream itself."""
        if self._fe_stream is None:
            yield
            return
        if any(isinstance(im, torch.Tensor) and im.device.type == "cuda" for im in images):
            self._fe_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._fe_stream):
            yield

    def _attitude_prediction(self, t: float) -> Transformation:
        """Attitude at ``t`` by integrating buffered gyro from the newest
        window state on the host (enough for the descriptor's gravity
        direction; no device round trip, no wait on the backend)."""
        slot = max(self.n_states - 1, 0)
        w = self.window  # local reference: the backend rebinds it atomically
        r = w.r[slot].copy()
        q = w.q[slot].copy()
        bg = w.speed_bias[slot][3:6].copy()
        t0 = float(w.timestamp[slot])
        with self._imu_mutex:
            tt = np.asarray(self.imu_t)
            sel = np.nonzero((tt > t0) & (tt <= t))[0]
            ts = tt[sel]
            gy = [self.imu_gyro[i] for i in sel]
        t_prev = t0
        for ti, wg in zip(ts, gy):
            dt = float(ti) - t_prev
            if dt <= 0:
                continue
            phi = (wg - bg) * dt
            ang = float(np.linalg.norm(phi))
            half = 0.5 * ang
            fac = 0.5 if ang < 1e-12 else np.sin(half) / ang
            dq = np.concatenate([phi * fac, [np.cos(half)]])
            q = npq.normalize(npq.multiply(q, dq))
            t_prev = float(ti)
        return Transformation(r=r, q=q)

    def backend_step(self, t: float, images, fd: _FrameData) -> Optional[FrameResult]:
        """Stages 2-7 for one detected frame, pipelined: the previous
        frame's optimize(+marginalize) program is still in flight; this
        frame's IMU propagation, map matching and speculative stereo are
        queued behind it on the device, reading its un-fetched window, and
        one ``to_numpy_tree`` fetches everything. The previous frame is then
        finalized, this frame's host stages run on the now-consistent
        window, and its solve is queued without a fetch.

        As the JAX engine's: the match stage is dispatched on every frame
        (one ``_rng`` draw, and a miss-streak bump with no landmarks); the
        landmark covariances and descriptors, and the speed used for the
        gate, are the host's from before the previous frame's solve; the
        LM-budget EMA times dispatch to the next fetch.

        Returns the previous frame's result (None on the first pipelined
        frame); ``backend_flush`` drains the last one."""
        with _float32_matmuls(), timing.frame():
            if self.n_states == 0:
                return self._initialize(t, images)
            if self._pending is None and self.n_states >= self.wcfg.num_states:
                # restored sessions only: steady state marginalizes inside
                # the fused program
                self._apply_marginalization_policy()
            if fd.ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(fd.ready)
                fd.image0.record_stream(stream)

            p = self._pending
            if p is not None:
                prev_slot, t_prev, w_dev = p.slot_post, p.t, p.win_dev
                base_r, base_q = w_dev.r[prev_slot], w_dev.q[prev_slot]
                base_sb = w_dev.speed_bias[prev_slot]
                hp_dev, lmv_dev = w_dev.hp_W, w_dev.lm_valid
            else:
                prev_slot = self.n_states - 1
                t_prev = float(self.window.timestamp[prev_slot])
                base_r, base_q = self.window.r[prev_slot], self.window.q[prev_slot]
                base_sb = self.window.speed_bias[prev_slot]
                hp_dev = lmv_dev = None

            d = self._dev
            with Timer("2.3 preint"):
                sl = self._imu_slice(t_prev, t)
                preint_out = None
                if sl is not None:
                    ts, gy, ac, mask = sl
                    preint_out = programs.preint_prop(
                        d(ts), d(gy), d(ac), d(mask), d(t_prev), d(t), d(base_r), d(base_q),
                        d(base_sb), self.cfg.imu,
                    )
            if preint_out is not None:
                T_r_m, T_q_m = preint_out[1].r, preint_out[1].q
            else:
                T_r_m, T_q_m = base_r, base_q

            # association + speculative stereo, queued behind the solve
            m_out = self._dispatch_match(fd, T_r_m, T_q_m, hp_W=hp_dev, lm_valid=lmv_dev)
            s_out = self._dispatch_stereo(fd, T_r_m, T_q_m, hp_W=hp_dev, lm_valid=lmv_dev)
            with Timer("2.4.2 match_fetch"):
                opt_f, pre_f, m_f, s_f, img_f = to_numpy_tree(
                    (None if p is None else p.opt_out, preint_out, m_out, s_out,
                     None if p is None else p.image0))
            prev_result = self._finalize_pending(opt_f, img_f) if p is not None else None

            # ---- this frame's host stages on the now-consistent window ----
            slot = self.n_states
            if pre_f is not None:
                pre, T_h, sb_pred, W_imu = pre_f
                T_pred = Transformation(r=np.array(T_h.r), q=np.array(T_h.q))
                sb_pred = np.array(sb_pred)
            else:
                pre = W_imu = None
                T_pred = Transformation(r=np.array(to_numpy_tree(base_r)),
                                        q=np.array(to_numpy_tree(base_q)))
                sb_pred = np.array(to_numpy_tree(base_sb))
            self._create_state(slot, t, t_prev, T_pred, sb_pred, fd, pre, W_imu)
            n_tracked = self._apply_match(m_f, slot, fd) if m_f is not None else 0
            is_kf, n_new = self._keyframe_decision(slot, t, fd, T_pred, s_f)

            # ---- queue this frame's solve; it is fetched on the next step ----
            n_it = self._iteration_budget()
            victim = self._choose_marg_victim() if self.n_states >= self.wcfg.num_states else None
            lm_valid_before = self.window.lm_valid.copy() if victim is not None else None
            prog, bound = self._opt_program_for(n_it, victim is not None)
            with Timer("3.1.0 opt_upload"):
                w_dev, f_dev = self._up(self.window), self._up(self.factors)
            with Timer("3.1.1 opt_dispatch"):
                opt_out = (prog(w_dev, f_dev, n_it) if victim is None
                           else prog(w_dev, f_dev, n_it, victim))
            self._pending = _PendingOpt(
                opt_out=opt_out, win_dev=opt_out[0], victim=victim,
                lm_valid_before=lm_valid_before,
                slot_post=slot - (1 if victim is not None else 0), t=t, images=images,
                is_kf=is_kf, n_tracked=n_tracked, n_new=n_new, t_dispatch=time.perf_counter(),
                static_iters=bound, image0=fd.image0 if is_kf else None,
            )
            return prev_result

    def _finalize_pending(self, opt_f, image0=None) -> FrameResult:
        """Apply a fetched in-flight optimize and emit its frame's result
        (``image0``: a keyframe's fetched cam0 image, for its export)."""
        p = self._pending
        self._pending = None
        if p.victim is None:
            win_h, cost_h, iters_h, lm_cov_h, pr_valid, pr_err = opt_f
            fac_h = None
        else:
            win_h, fac_h, cost_h, iters_h, lm_cov_h, pr_valid, pr_err = opt_f
        self._apply_opt_results(win_h, fac_h, cost_h, iters_h, lm_cov_h, pr_valid, pr_err,
                                p.victim, p.lm_valid_before, time.perf_counter() - p.t_dispatch,
                                static_iters=p.static_iters)
        slot = p.slot_post
        self.frame_count += 1
        T_WS = self.window.pose(slot)
        result = FrameResult(
            timestamp=p.t, T_WS=Transformation(r=T_WS.r.copy(), q=T_WS.q.copy()),
            speed_bias=self.window.speed_bias[slot].copy(), is_keyframe=p.is_kf,
            num_tracked=p.n_tracked, num_new_landmarks=p.n_new, cost=self._cost_last,
            keyframe_export=self._timed_export(slot, p.images, image0) if p.is_kf else None,
            lm_iterations=self._lm_iterations_last,
        )
        self.trajectory.append((p.t, result.T_WS.r, result.T_WS.q))
        self._publish(result)
        return result

    def backend_flush(self) -> Optional[FrameResult]:
        """Fetch and finalize the last in-flight frame (end of stream)."""
        if self._pending is None:
            return None
        with _float32_matmuls(), timing.frame():
            return self._finalize_pending(*to_numpy_tree((self._pending.opt_out,
                                                          self._pending.image0)))

    def _iteration_budget(self) -> int:
        """Per-frame LM iteration budget from the config's real-time
        envelope (timeLimit / minIterations) and the measured per-iteration
        wall time."""
        max_it = self.wcfg.max_iterations
        if self.cfg.time_limit <= 0 or self._opt_iter_ema is None:
            return max_it
        fit = int(self.cfg.time_limit / max(self._opt_iter_ema, 1e-9))
        return int(np.clip(fit, max(1, self.cfg.min_iterations), max_it))

    def _opt_program_for(self, n_it: int, with_marg: bool):
        """The optimize program with the shortest static LM bound covering
        this frame's budget (``programs.OptProgram``: CUDA graphs on a card,
        the eager program on the CPU)."""
        bound = next((b for b in self._opt_bounds if b >= n_it), self._opt_bounds[-1])
        key = (bound, with_marg)
        if key not in self._opt_programs:
            self._opt_programs[key] = programs.OptProgram(
                self.rig_p, self.cfg.imu, self.wcfg._replace(max_iterations=bound), with_marg,
                solve=self.solve)
        return self._opt_programs[key], bound

    # sigma = 1 px at octave 0, doubling per octave
    _KP_SQRT_INFO = programs.KP_SQRT_INFO

    def _kp_info(self, fd: _FrameData, ci: int, k: int) -> float:
        return self._KP_SQRT_INFO / float(1 << int(fd.kp_octave[ci][k]))

    # per-keypoint ray angular sigma: sqrt(sqrt(2)) · (0.8·kpSize/12) / f
    _RAY_SIGMA_BASE = (2.0 ** 0.25) * 0.8
    # fallback landmark position variance [m²] before any covariance is known
    _LM_COV_DEFAULT = 0.25
    # relative-pose translation variance within one multiframe
    _POSE_VAR_STEREO = 4e-8

    def _pose_var_temporal(self, slot: int) -> float:
        v = float(np.linalg.norm(self.window.speed_bias[slot][:3]))
        return 1e-2 * max(1.0, v) ** 2

    def _initialize(self, t: float, images) -> Optional[FrameResult]:
        # the gravity direction from the last 20 samples up to the frame's
        # stamp: a threaded feeder may have buffered IMU past the frame (the
        # JAX engine averages the buffer's tail whatever its time; a serial
        # feed holds nothing past the frame, and there the two agree)
        with self._imu_mutex:
            n_upto = int(np.searchsorted(self.imu_t, t + self.cfg.image_delay + 1e-9, side="right"))
            if n_upto < 3:
                return None  # wait for IMU
            acc_mean = np.mean(self.imu_acc[max(0, n_upto - 20):n_upto], axis=0)
        self._lm_desc = np.zeros((self.wcfg.num_landmarks, 8), np.int32)
        self._lm_cov = np.tile(np.eye(3) * self._LM_COV_DEFAULT, (self.wcfg.num_landmarks, 1, 1))
        acc_mean = self._dev(acc_mean)
        T0_h = to_numpy_tree(init_pose_from_imu(acc_mean))
        T0 = Transformation(r=np.array(T0_h.r), q=np.array(T0_h.q))
        slot = 0
        w = self.window
        w.r[slot] = T0.r
        w.q[slot] = T0.q
        w.speed_bias[slot] = 0.0
        w.state_valid[slot] = True
        w.is_keyframe[slot] = True
        w.timestamp[slot] = t
        w.state_id[slot] = self.next_state_id
        self.next_state_id += 1
        # gauge priors: strong on position + yaw (unobservable), weak on
        # roll/pitch (gravity-observable)
        pr = self.factors.priors
        sbi = np.diag(np.concatenate([
            np.full(3, 10.0), np.full(3, 1.0 / self.cfg.imu.sigma_bg),
            np.full(3, 1.0 / self.cfg.imu.sigma_ba),
        ]))
        pr.pose_mean_r[slot] = T0.r
        pr.pose_mean_q[slot] = T0.q
        pr.pose_sqrt_info[slot] = np.diag([1e4, 1e4, 1e4, 5.0, 5.0, 1e4])
        pr.pose_valid[slot] = True
        pr.sb_mean[slot] = 0.0
        pr.sb_sqrt_info[slot] = sbi
        pr.sb_valid[slot] = True
        self._attach_depth_factor(slot, t)

        fd = self._new_frame(t, images, *self._detect_describe(images, T0))
        self.frames[slot] = fd
        n_new = self._stereo_initialize_landmarks(slot, fd, T0)
        self.n_states = 1
        self.last_kf_slot = slot
        self.frame_count += 1
        self.kf_count += 1
        self._kf_index_by_state_id[int(self.window.state_id[slot])] = self.kf_count
        res = FrameResult(timestamp=t, T_WS=T0, speed_bias=np.zeros(9), is_keyframe=True,
                          num_tracked=0, num_new_landmarks=n_new, cost=0.0)
        self.trajectory.append((t, np.asarray(T0.r), np.asarray(T0.q)))
        self._publish(res)
        return res

    def _attach_depth_factor(self, slot: int, t: float):
        if not self.cfg.is_depth_used or not self.depth_buffer:
            return
        # mean of depth measurements near the state time
        near = [d for (td, d) in self.depth_buffer if abs(td - t) < 0.6]
        if not near:
            return
        dep = self.factors.depth
        dep.depth[slot] = float(np.mean(near))
        dep.first_depth[...] = self.first_depth or 0.0
        dep.valid[slot] = True

    def _attach_sonar_factor(self, slot: int, t: float, T_WS: Transformation):
        if not self.cfg.is_sonar_used or not self.sonar_buffer:
            return
        near = [s for s in self.sonar_buffer if abs(s[0] - t) < 0.2]
        if not near:
            return
        _, rng, heading = near[-1]
        # beam point in world: T_WS * T_SSo * (r cosθ, r sinθ, 0)
        M = np.asarray(self.cfg.T_SSo, float)
        p_So = np.asarray([rng * np.cos(heading), rng * np.sin(heading), 0.0])
        p_S = M[:3, :3] @ p_So + M[:3, 3]
        beam_W = npq.rotate(np.asarray(T_WS.q), p_S) + np.asarray(T_WS.r)
        # landmark subset within ±0.1 m box of the beam point
        lms = self.window.hp_W[:, :3]
        ok = self.window.lm_valid & (np.all(np.abs(lms - beam_W) < 0.1, axis=1))
        if ok.sum() == 0:
            return
        so = self.factors.sonar
        so.range[slot] = float(rng)
        so.target_W[slot] = lms[ok].mean(axis=0)
        so.valid[slot] = True

    def _dispatch_stereo(self, fd: _FrameData, T_r, T_q, hp_W=None, lm_valid=None):
        """Dispatch the stereo match+triangulate program (speculatively, on
        every frame: ``_apply_stereo`` drops pairs the match stage claimed,
        and the in-program dedup kills near-duplicates of the map). ``T_r``,
        ``T_q``, ``hp_W`` and ``lm_valid`` may be device tensors (the
        un-fetched IMU prediction and optimize output); the landmark tables
        default to the host window's."""
        if self.rig.num_cameras < 2:
            return None
        un_a = fd.kp_landmark[0] < 0
        un_b = fd.kp_landmark[1] < 0
        d = self._dev
        hp_W = self.window.hp_W if hp_W is None else hp_W
        lm_valid = self.window.lm_valid if lm_valid is None else lm_valid
        return programs.stereo_match_tri(
            self.rig_p.camera(0), self.rig_p.camera(1), self._RAY_SIGMA_BASE,
            self._POSE_VAR_STEREO,
            d(fd.kp_desc[0]), d(fd.kp_desc[1]), d(fd.kp_valid[0] & un_a),
            d(fd.kp_valid[1] & un_b), d(fd.kp_uv[0]), d(fd.kp_uv[1]),
            d(fd.kp_octave[0]), d(fd.kp_octave[1]), d(T_r), d(T_q),
            d(self.window.ext_r[0]), d(self.window.ext_q[0]),
            d(self.window.ext_r[1]), d(self.window.ext_q[1]),
            d(hp_W), d(lm_valid), matcher=self.matcher,
        )

    def _apply_stereo(self, fetched, slot: int, fd: _FrameData) -> int:
        """Allocate landmarks + observations from a fetched stereo dispatch."""
        if fetched is None:
            return 0
        ib_all, pts_all, good, cov_all = fetched
        ia = np.nonzero(good)[0]
        if len(ia) == 0:
            return 0
        # drop pairs associated to the map since the (speculative) dispatch
        keep = (fd.kp_landmark[0][ia] < 0) & (fd.kp_landmark[1][ib_all[ia]] < 0)
        ia = ia[keep]
        if len(ia) == 0:
            return 0
        ib = ib_all[ia]
        slots = self._allocate_landmarks(pts_all[ia], fd.kp_desc[0][ia], cov_all[ia])
        rows = []
        for k, (a, b_) in enumerate(zip(ia, ib)):
            if slots[k] < 0:
                continue
            fd.kp_landmark[0][a] = slots[k]
            fd.kp_landmark[1][b_] = slots[k]
            rows.append((fd.kp_uv[0][a], slot, slots[k], 0, self._kp_info(fd, 0, a)))
            rows.append((fd.kp_uv[1][b_], slot, slots[k], 1, self._kp_info(fd, 1, b_)))
        self._add_observations(rows)
        return int((slots >= 0).sum())

    def _stereo_initialize_landmarks(self, slot: int, fd: _FrameData, T_WS: Transformation) -> int:
        """Stereo intra-frame matching + triangulation → new landmarks:
        standalone dispatch + fetch."""
        out = self._dispatch_stereo(fd, np.asarray(T_WS.r), np.asarray(T_WS.q))
        if out is None:
            return 0
        return self._apply_stereo(to_numpy_tree(out), slot, fd)

    def _temporal_initialize_landmarks(self, slot: int, fd: _FrameData, T_WS: Transformation) -> int:
        """2D-2D matching to the last keyframe + two-view triangulation → new
        landmarks: the only landmark source for mono rigs, and
        temporal-baseline landmarks for stereo rigs whose stereo pass found
        none. One program per camera, one fetch for all."""
        prev_slot = self.last_kf_slot
        if prev_slot is None or prev_slot == slot or prev_slot not in self.frames:
            return 0
        fd_prev = self.frames[prev_slot]
        T_prev = self.window.pose(prev_slot)
        # minimum-baseline gate: with no baseline every correct match has
        # zero parallax and the angle gate would keep only mismatches
        if float(np.linalg.norm(np.asarray(T_WS.r) - np.asarray(T_prev.r))) < 0.02:
            return 0
        total = 0
        rows = []
        d = self._dev
        pending = []
        for ci in range(min(self.rig.num_cameras, len(fd_prev.kp_uv))):
            rA, qA = self._T_WC_np(T_WS, ci)
            rB, qB = self._T_WC_np(T_prev, ci)
            seed = self._rng.randint(0, 2**31)
            draw_rot = lambda v, H, s, seed=seed: self.draw_hypotheses(seed, 0, v, H, s)  # noqa: E731
            draw_rel = lambda v, H, s, seed=seed: self.draw_hypotheses(seed, 1, v, H, s)  # noqa: E731
            pending.append((ci, programs.temporal_match_tri(
                self.rig_p.camera(ci), self._RAY_SIGMA_BASE, self._diag[0], self._focal[ci],
                draw_rot, draw_rel,
                d(fd.kp_desc[ci]), d(fd_prev.kp_desc[ci]),
                d(fd.kp_valid[ci] & (fd.kp_landmark[ci] < 0)),
                d(fd_prev.kp_valid[ci] & (fd_prev.kp_landmark[ci] < 0)),
                d(fd.kp_uv[ci]), d(fd_prev.kp_uv[ci]), d(fd.kp_octave[ci]), d(fd_prev.kp_octave[ci]),
                d(rA), d(qA), d(rB), d(qB), d(self._pose_var_temporal(slot)),
                d(self.window.hp_W), d(self.window.lm_valid), matcher=self.matcher,
            )))
        fetched = to_numpy_tree([p[1] for p in pending])
        for (ci, _), (ib_all, pts_all, good, cov_all, rot_only) in zip(pending, fetched):
            if bool(rot_only):
                # the epipolar t is ill-determined; the parallax gate blocks
                # garbage triangulation
                self.rotation_only_detections += 1
            ia = np.nonzero(good)[0]
            if len(ia) == 0:
                continue
            ib = ib_all[ia]
            slots = self._allocate_landmarks(pts_all[ia], fd.kp_desc[ci][ia], cov_all[ia])
            for k, (a, b_) in enumerate(zip(ia, ib)):
                if slots[k] < 0:
                    continue
                fd.kp_landmark[ci][a] = slots[k]
                fd_prev.kp_landmark[ci][b_] = slots[k]
                rows.append((fd.kp_uv[ci][a], slot, slots[k], ci, self._kp_info(fd, ci, a)))
                rows.append((fd_prev.kp_uv[ci][b_], prev_slot, slots[k], ci,
                             self._kp_info(fd_prev, ci, b_)))
                total += 1
        self._add_observations(rows)
        return total

    def _dispatch_match(self, fd: _FrameData, T_r, T_q, hp_W=None, lm_valid=None, lm_cov=None):
        """Dispatch the association stage (projection-gated matching + 3D-2D
        RANSAC + reprojection acceptance), with the velocity-scaled pose
        variance inflated by the tracking-miss streak and each landmark's
        own covariance in the gate. ``T_r``, ``T_q`` and the landmark tables
        ``hp_W``, ``lm_valid``, ``lm_cov`` may be device tensors (un-fetched
        program outputs, which the pipelined backend chains behind the
        in-flight solve); the tables default to the host's."""
        slot_prev = self.last_kf_slot if self.last_kf_slot is not None else 0
        pos_var = self._pose_var_temporal(slot_prev) * (4.0 ** min(self._track_miss_streak, 2))
        kp_sigma = 0.8 * np.stack([np.ldexp(1.0, fd.kp_octave[ci]) for ci in range(len(fd.kp_uv))])
        free = np.stack([fd.kp_landmark[ci] < 0 for ci in range(len(fd.kp_uv))])
        seed = self._rng.randint(0, 2**31)
        d = self._dev
        hp_W = self.window.hp_W if hp_W is None else hp_W
        lm_valid = self.window.lm_valid if lm_valid is None else lm_valid
        lm_cov = self._lm_cov if lm_cov is None else lm_cov
        with Timer("2.4.1 match_dispatch"):
            return programs.match_stage(
                self.rig_p, self._focal[0],
                d(np.stack(fd.kp_uv)), d(np.stack(fd.kp_desc)), d(np.stack(fd.kp_valid)), d(free),
                d(hp_W), d(lm_valid), d(self._lm_desc), d(lm_cov),
                d(T_r), d(T_q), d(self.window.ext_r), d(self.window.ext_q), d(kp_sigma),
                d(pos_var),
                lambda v, H, s: self.draw_hypotheses(seed, None, v, H, s),
                matcher=self.matcher,
            )

    def _apply_match(self, fetched, slot: int, fd: _FrameData) -> int:
        """Host side of the association stage: landmark bookkeeping +
        observation rows from the fetched match outputs."""
        accept, midx, n_cand, success, fit_r, fit_q = fetched
        if int(n_cand) < 6:
            self._track_miss_streak += 1
            return 0
        self._last_ransac_T_WS = (
            Transformation(r=np.array(fit_r), q=np.array(fit_q)) if bool(success) else None
        )
        n_tracked = 0
        rows = []
        refresh_l, refresh_d = [], []
        for ci in range(self.rig.num_cameras):
            for k in np.nonzero(accept[ci])[0]:
                lm = int(midx[ci][k])
                fd.kp_landmark[ci][k] = lm
                rows.append((fd.kp_uv[ci][k], slot, lm, ci, self._kp_info(fd, ci, k)))
                refresh_l.append(lm)
                refresh_d.append(fd.kp_desc[ci][k])
                n_tracked += 1
        if refresh_l:
            self._lm_desc[refresh_l] = np.stack(refresh_d)
        self._add_observations(rows)
        self._track_miss_streak = 0 if n_tracked >= 6 else self._track_miss_streak + 1
        return n_tracked

    def _decay_extrinsics_prior(self, dt: float) -> None:
        """Extrinsics random walk: the shared extrinsics prior re-centred at
        the running estimate, its covariance grown by Q·dt each frame."""
        st = self.cfg.sigma_c_relative_translation
        so = self.cfg.sigma_c_relative_orientation
        if not self.wcfg.estimate_extrinsics or st < 1e-12 or so < 1e-12:
            return
        dt = max(float(dt), 1e-6)
        Q = np.diag([st * st * dt] * 3 + [so * so * dt] * 3)
        ep = self.factors.ext_prior
        S = ep.sqrt_info  # (C,6,6)
        for c in range(S.shape[0]):
            info = S[c].T @ S[c]
            P = np.linalg.inv(info + 1e-12 * np.eye(6)) + Q
            S[c] = np.linalg.cholesky(np.linalg.inv(P)).T
        ep.mean_r[:] = self.window.ext_r
        ep.mean_q[:] = self.window.ext_q

    def _accumulate_scale_state(self, t: float) -> None:
        """One-shot scale refinement over the first keyframes: accumulate the
        RANSAC vision pose + the IMU preintegral from the previously
        accumulated keyframe; the estimate is logged (a diagnostic)."""
        sr = self.scale_refiner
        if sr.refined or self._last_ransac_T_WS is None:
            return
        T = self._last_ransac_T_WS
        C_WS = npq.to_rotation_matrix(np.asarray(T.q))
        p_C = self._T_WC_np(T, 0)[0]
        if not sr.C_WS:  # first accumulated state
            sr.add_state(C_WS, p_C)
            self._scale_last_t = t
            return
        slot = self.n_states - 1
        pre = self._preintegrate(self._scale_last_t, t, self.window.speed_bias[slot][3:9])
        if pre is None:
            return
        sr.add_state(C_WS, p_C, delta_p=np.asarray(pre.acc_doubleintegral),
                     delta_v=np.asarray(pre.acc_integral), dt=float(pre.Delta_t))
        self._scale_last_t = t
        if sr.refined:
            est = sr.result
            _LOG.info("scale refinement: s=%.4f |g|=%.3f over %d keyframes",
                      est.scale, est.gravity_norm, est.n_states)

    def _keyframe_decision(self, slot: int, t: float, fd: _FrameData, T_pred: Transformation, s_f):
        """Hull-overlap keyframe decision + (on keyframes) new landmarks from
        the speculative stereo candidates, with the temporal bootstrap when
        stereo gave none (or the rig is mono)."""
        with Timer("2.8 kf_decision"):
            is_kf = self._need_new_keyframe(fd)
            n_new = 0
            if is_kf:
                with Timer("2.5 stereo_init"):
                    n_new = self._apply_stereo(s_f, slot, fd)
                if self.rig.num_cameras < 2 or n_new == 0:
                    with Timer("2.6 temporal_init"):
                        n_new += self._temporal_initialize_landmarks(slot, fd, T_pred)
                self.window.is_keyframe[slot] = True
                self.last_kf_slot = slot
                self.kf_count += 1
                self._kf_index_by_state_id[int(self.window.state_id[slot])] = self.kf_count
                self._accumulate_scale_state(t)
        return is_kf, n_new

    def _create_state(self, slot: int, t: float, t_prev: float, T_pred: Transformation, sb_pred,
                      fd: _FrameData, pre, W_imu) -> None:
        """New window state at the IMU-predicted pose + its factors (the
        bridging IMU factor, depth/sonar factors, extrinsics random walk)."""
        with Timer("2.7 create_state"):
            w = self.window
            w.r[slot] = np.asarray(T_pred.r)
            w.q[slot] = np.asarray(T_pred.q)
            w.speed_bias[slot] = sb_pred
            w.state_valid[slot] = True
            w.timestamp[slot] = t
            w.state_id[slot] = self.next_state_id
            w.is_keyframe[slot] = False
            self.next_state_id += 1
            self.frames[slot] = fd
            self.n_states += 1

            if pre is not None:  # IMU factor prev_slot -> slot
                imf = self.factors.imu
                k = slot - 1
                for full, new in zip(imf.pre, pre):
                    full[k] = new
                imf.sqrt_info[k] = W_imu
                # a zero-Δt factor (IMU dropout) has no information
                imf.valid[k] = float(np.asarray(pre.Delta_t)) > 0.0

            self._attach_depth_factor(slot, t)
            self._attach_sonar_factor(slot, t, T_pred)
            self._decay_extrinsics_prior(t - t_prev)

    def _need_new_keyframe(self, fd: _FrameData) -> bool:
        """Convex-hull overlap / matching-ratio heuristic: per camera,
        overlap = area(hull of matched) / area(hull of all) and ratio =
        n_matched / #kps strictly inside the matched hull; max over cameras;
        a non-keyframe only when overlap > 0.6 and ratio > 0.2."""
        if self.last_kf_slot is None:
            return True
        all_uv, matched_uv = [], []
        for ci in range(self.rig.num_cameras):
            v = np.asarray(fd.kp_valid[ci])
            uv = np.asarray(fd.kp_uv[ci])[v]
            m = (np.asarray(fd.kp_landmark[ci]) >= 0)[v]
            all_uv.append(uv)
            matched_uv.append(uv[m])
        overlap, ratio = keyframe_overlap_ratio(all_uv, matched_uv)
        return not (overlap > 0.6 and ratio > 0.2)

    def _track(self, t: float, images) -> FrameResult:
        # ---- 2. IMU propagation for prediction ----
        prev_slot = self.n_states - 1
        t_prev = float(self.window.timestamp[prev_slot])
        sb_prev = self.window.speed_bias[prev_slot]
        T_prev = self.window.pose(prev_slot)
        pre = None
        W_imu = None
        d = self._dev
        with Timer("2.3 preint"):
            sl = self._imu_slice(t_prev, t)
            if sl is not None:
                ts, gy, ac, mask = sl
                pre_d, T_d, sb_d, W_d = programs.preint_prop(
                    d(ts), d(gy), d(ac), d(mask), d(t_prev), d(t), d(T_prev.r), d(T_prev.q),
                    d(sb_prev), self.cfg.imu,
                )
        if sl is not None:
            # not fetched yet: detection consumes the device-side attitude and
            # the propagation results ride the keypoint fetch
            with Timer("2.1 detect_describe"):
                (uvs, descs, valids, scores, octs, img0,
                 (pre, T_h, sb_pred, W_imu)) = self._detect_describe(
                    images, T_d, extra=(pre_d, T_d, sb_d, W_d))
            T_pred = Transformation(r=np.array(T_h.r), q=np.array(T_h.q))
            sb_pred = np.array(sb_pred)
        else:
            T_pred, sb_pred = T_prev, sb_prev
            with Timer("2.1 detect_describe"):
                uvs, descs, valids, scores, octs, img0 = self._detect_describe(images, T_pred)
        fd = self._new_frame(t, images, uvs, descs, valids, scores, octs, img0)

        # ---- marginalization BEFORE adding if the window is full ----
        if self.n_states >= self.wcfg.num_states:
            with Timer("2.2 marginalization"):
                self._apply_marginalization_policy()
        slot = self.n_states

        self._create_state(slot, t, t_prev, T_pred, sb_pred, fd, pre, W_imu)

        # ---- 3. data association + speculative stereo, ONE fetch ----
        with Timer("2.4 matching"):
            m_out = (self._dispatch_match(fd, T_pred.r, T_pred.q)
                     if self.window.lm_valid.sum() > 0 else None)
            s_out = self._dispatch_stereo(fd, np.asarray(T_pred.r), np.asarray(T_pred.q))
            with Timer("2.4.2 match_fetch"):
                m_f, s_f = to_numpy_tree((m_out, s_out))
            n_tracked = self._apply_match(m_f, slot, fd) if m_f is not None else 0
        is_kf, n_new = self._keyframe_decision(slot, t, fd, T_pred, s_f)

        # ---- 6. optimize (+ fused marginalization in steady state) ----
        n_it = self._iteration_budget()
        victim = self._choose_marg_victim() if self.n_states >= self.wcfg.num_states else None
        prog, bound = self._opt_program_for(n_it, victim is not None)
        lm_valid_before = self.window.lm_valid.copy() if victim is not None else None
        with Timer("3.1 optimization"):
            t_opt0 = time.perf_counter()
            with Timer("3.1.0 opt_upload"):
                w_dev, f_dev = self._up(self.window), self._up(self.factors)
            if victim is None:
                with Timer("3.1.1 opt_dispatch"):
                    opt_out = prog(w_dev, f_dev, n_it)
                with Timer("3.1.2 opt_fetch"):
                    win_h, cost_h, iters_h, lm_cov_h, pr_valid, pr_err = to_numpy_tree(opt_out)
                fac_h = None
            else:
                with Timer("3.1.1 opt_dispatch"):
                    opt_out = prog(w_dev, f_dev, n_it, victim)
                with Timer("3.1.2 opt_fetch"):
                    (win_h, fac_h, cost_h, iters_h, lm_cov_h, pr_valid,
                     pr_err) = to_numpy_tree(opt_out)
            dt_opt = time.perf_counter() - t_opt0
            self._apply_opt_results(win_h, fac_h, cost_h, iters_h, lm_cov_h, pr_valid, pr_err,
                                    victim, lm_valid_before, dt_opt, static_iters=bound)
        if victim is not None:
            slot -= 1  # the newest slot shifted down by one

        self.frame_count += 1
        T_WS = self.window.pose(slot)
        result = FrameResult(
            timestamp=t, T_WS=Transformation(r=T_WS.r.copy(), q=T_WS.q.copy()),
            speed_bias=self.window.speed_bias[slot].copy(), is_keyframe=is_kf,
            num_tracked=n_tracked, num_new_landmarks=n_new, cost=self._cost_last,
            keyframe_export=self._timed_export(slot, images) if is_kf else None,
            lm_iterations=self._lm_iterations_last,
        )
        self.trajectory.append((t, result.T_WS.r, result.T_WS.q))
        self._publish(result)
        return result

    def _publish(self, result: FrameResult) -> None:
        """The state and keyframe callbacks, each under a span of its own
        (the app's work there is not the engine's)."""
        if self.state_callback:
            with Timer("3.4 state_callback"):
                self.state_callback(result)
        if result.keyframe_export is not None and self.keyframe_callback:
            with Timer("3.3 kf_callback"):
                self.keyframe_callback(result.keyframe_export)

    _PRUNE_PX = 3.0

    def _apply_opt_results(self, win_h, fac_h, cost_h, iters_h, lm_cov_h, pr_valid, pr_err,
                           victim, lm_valid_before, dt_opt, static_iters: int = 0) -> None:
        """Host side of a fetched optimize(+marginalize) program: window and
        factor write-back, the iteration-budget EMA (the first call and >10x
        outliers skipped), the landmark-covariance refresh, observation
        pruning, and the marginalization bookkeeping."""
        with Timer("3.1.3 opt_writeback"):
            per_it = dt_opt / max(static_iters or self.wcfg.max_iterations, 1)
            if self._opt_calls > 0 and (self._opt_iter_ema is None
                                        or per_it < 10.0 * self._opt_iter_ema):
                self._opt_iter_ema = (per_it if self._opt_iter_ema is None
                                      else 0.8 * self._opt_iter_ema + 0.2 * per_it)
            self._opt_calls += 1
            self.window = win_h
            if fac_h is not None:
                self.factors = fac_h
            self._cost_last = float(cost_h)
            self._lm_iterations_last = int(iters_h)
            # refresh landmark covariances (pose-conditioned inv(Hll)) for the
            # projected-covariance gate where the landmark's Hessian block is
            # well conditioned; others keep their creation-time triangulation
            # covariance. A landmark seen once has a rank-2 block whose float32
            # inverse is inf, and its quality sqrt(λmin/λmax) rounds to ~2e-4,
            # above the 1e-6 bound: the finiteness check (not in the JAX
            # engine) keeps that inf out of the gate
            lm_cov_h = np.asarray(lm_cov_h)
            lv = (self.window.lm_valid & (self.window.lm_quality > 1e-6)
                  & np.isfinite(lm_cov_h).all(axis=(1, 2)))
            if lv.any():
                self._lm_cov[lv] = lm_cov_h[lv]
            bad = pr_valid & (pr_err > self._PRUNE_PX)
            if bad.any():
                self.factors.reproj.valid[bad] = False
            if victim is not None:
                self._post_marginalize_bookkeeping(victim, lm_valid_before)

    # --------------------------------------------------- marginalization
    def _choose_marg_victim(self) -> int:
        """Keep the newest numImuFrames; if the oldest of those is not a
        keyframe, drop it; otherwise drop the oldest keyframe slot. Never
        the newest slot."""
        S = self.wcfg.num_states
        is_kf = self.window.is_keyframe
        for s in range(S - self.cfg.num_imu_frames, S - 1):
            if not is_kf[s]:
                return s
        return 0  # oldest keyframe

    def _apply_marginalization_policy(self):
        self._marginalize(self._choose_marg_victim())

    def _marginalize(self, slot: int):
        lm_valid_before = self.window.lm_valid.copy()
        with Timer("2.2.1 marg_dispatch"):
            w_d, f_d = marginalize_slot(self._up(self.window), self._up(self.factors), slot,
                                        self.rig_p, self.cfg.imu, self.wcfg)
        with Timer("2.2.2 marg_fetch"):
            self.window, self.factors = to_numpy_tree((w_d, f_d))
        self._post_marginalize_bookkeeping(slot, lm_valid_before)

    def _post_marginalize_bookkeeping(self, slot: int, lm_valid_before: np.ndarray) -> None:
        """Host-side record shift after a device marginalization."""
        # scrub frame records referencing freed landmark slots (a freed slot
        # is reused, and a stale reference would export the new landmark)
        freed = lm_valid_before & ~self.window.lm_valid
        if freed.any():
            freed_slots = np.nonzero(freed)[0]
            for fdta in self.frames.values():
                for kl in fdta.kp_landmark:
                    kl[np.isin(kl, freed_slots)] = -1
        self.frames = {(s - 1 if s > slot else s): f for s, f in self.frames.items() if s != slot}
        if self.last_kf_slot is not None:
            if self.last_kf_slot == slot:
                self.last_kf_slot = None
            elif self.last_kf_slot > slot:
                self.last_kf_slot -= 1
        self.n_states -= 1

    # --------------------------------------------------------- kf export
    def _timed_export(self, slot: int, images, image0=None) -> dict:
        with Timer("3.2 kf_export"):
            return self._export_keyframe(slot, images, image0)

    def _export_keyframe(self, slot: int, images, image0=None) -> dict:
        """Keyframe payload for loop closure (the pose_graph ABI): processed
        left image (``image0`` when already fetched), T_WC, per-point [3D
        point, landmark id, keypoint uv, quality], covisible keyframe
        indices, and health fields."""
        fd = self.frames[slot]
        T_WS = self.window.pose(slot)
        r_WC, q_WC = self._T_WC_np(T_WS, 0)
        kp_lm = fd.kp_landmark[0]
        sel = np.nonzero(kp_lm >= 0)[0]
        lm_slots = kp_lm[sel]
        W_, H_ = self.rig.cameras[0].width, self.rig.cameras[0].height
        v = fd.kp_valid[0]
        qx = (fd.kp_uv[0][:, 0] >= W_ / 2).astype(int)
        qy = (fd.kp_uv[0][:, 1] >= H_ / 2).astype(int)
        quad = np.bincount((qy * 2 + qx)[v], minlength=4)[:4]
        # per-point covisibility: export indices of the other window
        # keyframes observing each exported landmark
        lm_observers: Dict[int, List[int]] = {}
        for s2, fd2 in self.frames.items():
            if s2 == slot:
                continue
            kf_idx2 = self._kf_index_by_state_id.get(int(self.window.state_id[s2]))
            if kf_idx2 is None:
                continue  # non-keyframe window state
            for lm in np.unique(fd2.kp_landmark[0][fd2.kp_landmark[0] >= 0]):
                lm_observers.setdefault(int(lm), []).append(kf_idx2)
        point_covis = [lm_observers.get(int(lm), []) for lm in lm_slots]
        covis: Dict[int, int] = {}
        for lst in point_covis:
            for k2 in lst:
                covis[k2] = covis.get(k2, 0) + 1
        return {
            "kf_index": self.kf_count,
            "timestamp": fd.timestamp,
            # the processed cam0 image (keyframes only): fetched with the
            # pipelined step's outputs, or here
            "image": (image0 if image0 is not None else to_numpy_tree(fd.image0)
                      if fd.image0 is not None else np.asarray(images[0])),
            "T_WC_r": np.asarray(r_WC),
            "T_WC_q": np.asarray(q_WC),
            "points_W": self.window.hp_W[lm_slots, :3],
            "landmark_ids": self.window.lm_id[lm_slots],
            "keypoints_uv": fd.kp_uv[0][sel],
            "quality": self.window.lm_quality[lm_slots],
            "num_tracked": int(len(sel)),
            "num_new": int((np.asarray(fd.kp_valid[0]) & (fd.kp_landmark[0] < 0)).sum()),
            "quadrant_counts": np.asarray(quad),
            "response_strengths": fd.kp_score[0][sel],
            "covisibilities": covis,  # kf_index -> shared landmark count
            "point_covisibilities": point_covis,
            "sequence": self.sequence,
        }

    # ------------------------------------------------------------- output
    def current_pose(self) -> Transformation:
        T = self.window.pose(max(self.n_states - 1, 0))
        return Transformation(r=np.asarray(T.r), q=np.asarray(T.q))

    def save_trajectory_tum(self, path: str):
        """TUM format: timestamp tx ty tz qx qy qz qw."""
        with open(path, "w") as f:
            for t, r, q in self.trajectory:
                f.write(f"{t:.6f} {r[0]:.6f} {r[1]:.6f} {r[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
