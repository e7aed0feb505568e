"""Asynchronous (live-mode) front door for the VIO engine.

Counterpart of the JAX package's ``pipeline/async_vio.py``: a two-stage
pipeline over the engine's split step. A frontend thread runs detection of
frame k+1 (``VioEngine.frontend_stage``, on the engine's frontend CUDA
stream) while a backend thread runs association and the solve of frame k
(``VioEngine.backend_step``, which keeps one optimize program in flight),
and a publisher thread hands results to the callbacks one frame late.

``blocking=True`` is the deterministic dataset mode: backpressure all the
way to the caller. ``blocking=False`` is live mode: when the frame queue is
full the oldest frame is dropped.

``add_image`` quantizes to uint8 on the feeding thread; the upload to the
card happens inside ``frontend_stage``, on the frontend stream. A stage
that raises shuts the queues down (so a blocked feeder returns) and keeps
its exception in ``error``; ``finish()`` re-raises it.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

import numpy as np

from ..kinematics import npq
from ..native import FrameSynchronizer, ImuGate, ThreadSafeQueue
from ..utils import Timer, timing
from .vio import FrameResult, VioEngine, _as_uint8

_LOG = logging.getLogger("svin_tpu_torch")


class AsyncVioEngine:
    """Threaded front door for a VioEngine (the VioInterface analog)."""

    def __init__(
        self,
        engine: VioEngine,
        blocking: bool = False,
        frame_queue_size: int = 2,
        result_queue_size: int = 8,
        imu_wait_timeout: float = 2.0,
    ):
        self.engine = engine
        self.blocking = blocking
        self._sync = FrameSynchronizer(
            engine.rig.num_cameras, tolerance_s=engine.cfg.timestamp_tolerance
        )
        self._frames = ThreadSafeQueue(frame_queue_size)
        # detected frames staged between the frontend and backend threads
        # (depth 1: at most one frame detected ahead)
        self._staged = ThreadSafeQueue(1)
        self._results = ThreadSafeQueue(result_queue_size)
        self._gate = ImuGate()
        self._imu_lock = threading.Lock()  # guards the dead-reckoning state only
        self.state_callback: Optional[Callable[[FrameResult], None]] = None
        self.keyframe_callback = None
        self.propagated_state_callback = None  # (t, r, q, v) at IMU rate
        self._prop_t = None
        self._prop_r = self._prop_q = self._prop_v = None
        self._prop_bias = np.zeros(6)
        self.error: Optional[Exception] = None  # the first stage exception
        self._fe_worker = threading.Thread(target=self._frontend_loop, daemon=True)
        self._be_worker = threading.Thread(target=self._backend_loop, daemon=True)
        self._publisher = threading.Thread(target=self._publish_loop, daemon=True)
        self.dropped_frames = 0
        self._last_image_t = -np.inf
        self.position_measurements: List[tuple] = []
        self._fe_worker.start()
        self._be_worker.start()
        self._publisher.start()

    # ------------------------------------------------------------- inputs
    def set_blocking(self, blocking: bool) -> None:
        """Backpressure mode from the next ``add_image`` on: blocking
        (deterministic dataset mode) or drop-oldest (live mode)."""
        self.blocking = blocking

    def add_imu_measurement(self, t: float, gyro, acc) -> None:
        self.engine.add_imu_measurement(t, gyro, acc)  # the engine's own lock
        self._gate.announce(int(t * 1e9))
        # IMU-rate propagated state: host dead reckoning from the newest
        # optimized state
        if self.propagated_state_callback is not None:
            st = self._dead_reckon(t, np.asarray(gyro), np.asarray(acc))
            if st is not None:
                self.propagated_state_callback(*st)

    def _dead_reckon(self, t, gyro, acc):
        eng = self.engine
        if getattr(eng, "n_states", 0) == 0:
            return None
        with self._imu_lock:
            slot = eng.n_states - 1
            t0 = float(eng.window.timestamp[slot])
            if self._prop_t is None or self._prop_t < t0:
                T = eng.window.pose(slot)
                self._prop_r = np.asarray(T.r, float).copy()
                self._prop_q = np.asarray(T.q, float).copy()
                sb = np.asarray(eng.window.speed_bias[slot], float)
                self._prop_v = sb[:3].copy()
                self._prop_bias = sb[3:9].copy()
                self._prop_t = t0
        dt = t - self._prop_t
        # cut off 3 s past the newest state (no nonsense after an outage)
        if dt <= 0 or dt > 3.0:
            return None
        # one Euler step on the host (a publishing-rate prediction)
        w = gyro - self._prop_bias[:3]
        a = acc - self._prop_bias[3:6]
        phi = np.asarray(w * dt, float)
        ang = np.linalg.norm(phi)
        half = 0.5 * ang
        fac = 0.5 if ang < 1e-12 else np.sin(half) / ang
        dq = np.concatenate([phi * fac, [np.cos(half)]])
        q = npq.normalize(npq.multiply(self._prop_q, dq))
        C = npq.to_rotation_matrix(self._prop_q)
        g = np.array([0.0, 0.0, self.engine.cfg.imu.g])
        v = self._prop_v + (C @ a - g) * dt
        r = self._prop_r + self._prop_v * dt + 0.5 * (C @ a - g) * dt * dt
        self._prop_r, self._prop_q, self._prop_v, self._prop_t = r, q, v, t
        return t, r, q, v

    def add_position_measurement(self, t: float, position) -> None:
        """Buffered for consumers and loggers; the estimator attaches no
        factor to it."""
        self.position_measurements.append((t, np.asarray(position, float)))
        if len(self.position_measurements) > 10000:
            del self.position_measurements[:5000]

    def add_depth_measurement(self, t: float, depth: float) -> None:
        self.engine.add_depth_measurement(t, depth)

    def add_sonar_measurement(self, t: float, range_m: float, heading: float) -> None:
        self.engine.add_sonar_measurement(t, range_m, heading)

    def add_image(self, t: float, cam: int, image) -> bool:
        """Feed one camera image. Returns False if it was rejected or
        dropped (or the pipeline has shut down)."""
        if t < self._last_image_t - 1e-9 and cam == 0:
            return False  # out of order
        if cam == 0:
            self._last_image_t = t
        group = self._sync.add_frame(cam, t, image)
        if group is None:
            return True
        t_g, images = group
        # quantize on the feeding thread; the upload runs in frontend_stage
        images = [im if hasattr(im, "device") else _as_uint8(im) for im in images]
        if self.blocking:
            return self._frames.push_blocking((t_g, images))
        dropped = self._frames.push_dropping((t_g, images))
        if dropped is not None:
            self.dropped_frames += 1
        return dropped is None

    # ------------------------------------------------------------- loops
    def _die(self, stage: str, exc: Exception) -> None:
        """A stage raised: log, keep the first exception for ``finish()``,
        and shut the queues down so neither the feeder nor another stage
        waits on a dead thread."""
        _LOG.error("%s stage died", stage, exc_info=exc)
        if self.error is None:
            self.error = exc
        self._frames.shutdown()
        self._staged.shutdown()
        self._results.shutdown()

    def _frontend_loop(self) -> None:
        """Detection of frame k+1 beside the backend's solve of frame k."""
        try:
            can_split = hasattr(self.engine, "frontend_stage")
            while True:
                item = self._frames.pop_blocking()  # None: shut down and drained
                if item is None:
                    break
                t, images = item
                # wait for IMU coverage of the frame time (+ overlap)
                self._gate.wait_for(int((t + 0.005) * 1e9), timeout_s=2.0)
                if not can_split or getattr(self.engine, "n_states", 0) == 0:
                    # the first frame initializes whole in the backend (it
                    # needs the IMU attitude); engines without the split API
                    # run add_frame there too
                    self._staged.push_blocking((t, images, None))
                    continue
                with timing.frame(), Timer("1.1 frontend_stage"):
                    t_s, fd = self.engine.frontend_stage(t, images)
                self._staged.push_blocking((t_s, images, fd))
        except Exception as exc:  # kept and re-raised by finish()
            self._die("frontend", exc)

    def _backend_loop(self) -> None:
        """Association + solve; keeps one optimize program in flight."""
        try:
            while True:
                item = self._staged.pop_blocking()
                if item is None:
                    break
                t, images, fd = item
                with timing.frame(), Timer("2.0 frame_total"):
                    if fd is None:
                        result = self.engine.add_frame(t, images)
                    else:
                        result = self.engine.backend_step(t, images, fd)
                if result is not None:
                    self._results.push_blocking(result)
        except Exception as exc:  # kept and re-raised by finish()
            self._die("backend", exc)

    def _publish_loop(self) -> None:
        try:
            while True:
                r = self._results.pop_blocking()  # None: shut down and drained
                if r is None:
                    break
                if self.state_callback:
                    self.state_callback(r)
                if r.keyframe_export is not None and self.keyframe_callback:
                    self.keyframe_callback(r.keyframe_export)
        except Exception as exc:  # kept and re-raised by finish()
            self._die("publisher", exc)

    # ------------------------------------------------------------- drain
    def finish(self) -> None:
        """Drain the queues and stop the threads; re-raises a stage's
        exception. The joins are unbounded: a worker may be deep inside a
        device step. Order: close the frame intake (the frontend drains and
        exits), join it; close the staged queue (the backend drains), join
        it; flush the last in-flight frame; close the result queue (the
        publisher drains), join it."""
        self._gate.shutdown()
        self._frames.shutdown()
        self._fe_worker.join()
        self._staged.shutdown()
        self._be_worker.join()
        if self.error is None:
            flush = getattr(self.engine, "backend_flush", None)
            try:
                tail = flush() if flush is not None else None  # the last in-flight solve
            except Exception as exc:  # kept and re-raised by finish()
                self._die("backend flush", exc)
                tail = None
            if tail is not None:
                self._results.push_blocking(tail)
        self._results.shutdown()
        self._publisher.join()
        if self.error is not None:
            raise RuntimeError("AsyncVioEngine: a pipeline stage died") from self.error


class AsyncLoopCloser:
    """Loop closure in its own worker thread: keyframe exports cross a
    bounded queue (drop-oldest in live mode, blocking in deterministic mode)
    into a thread driving ``closer`` (anything with ``add_keyframe(export)``
    returning a loop or None, and ``flush()``); loop events surface on
    ``loop_callback`` from that thread. Wire as
    ``engine.keyframe_callback = acl.add_keyframe``. A worker exception is
    kept in ``error`` and re-raised by ``finish()``."""

    def __init__(self, closer, queue_size: int = 16, blocking: bool = False):
        self.closer = closer
        self.blocking = blocking
        self._queue = ThreadSafeQueue(queue_size)
        self.loop_callback: Optional[Callable] = None
        self.dropped_keyframes = 0
        self.processed = 0
        self.error: Optional[Exception] = None
        self._lock = threading.Lock()  # guards closer during finish()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def add_keyframe(self, export: dict) -> None:
        if self.blocking:
            self._queue.push_blocking(export)
        elif self._queue.push_dropping(export) is not None:
            self.dropped_keyframes += 1

    def _run(self) -> None:
        try:
            while True:
                export = self._queue.pop_blocking()  # None: shut down and drained
                if export is None:
                    break
                with self._lock:
                    loop = self.closer.add_keyframe(export)
                    self.processed += 1
                if loop is not None and self.loop_callback:
                    self.loop_callback(loop)
        except Exception as exc:  # kept and re-raised by finish()
            _LOG.error("loop-closure stage died", exc_info=exc)
            self.error = exc
            self._queue.shutdown()

    def finish(self) -> None:
        """Drain the queue and stop the worker (shut the intake, join
        unbounded), then flush the closer's deferred optimization."""
        self._queue.shutdown()
        self._worker.join()
        if self.error is not None:
            raise RuntimeError("AsyncLoopCloser: the loop-closure stage died") from self.error
        self.closer.flush()
