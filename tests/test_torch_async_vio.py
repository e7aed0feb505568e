"""The port's asynchronous front door (``pipeline/async_vio.py``) and the
engine's thread safety.

Mirrors the JAX package's ``tests/test_async_vio.py`` (blocking mode
processes every frame in order, out-of-order rejection, IMU-rate propagated
states, the loop-closure worker thread, here over a fake closer) and the
``AsyncVioEngine`` tests of ``tests/test_dataflow.py`` (call counts and
order through a counting fake engine, position-measurement buffering), with
the port's engine on the CPU (two 200x150 cameras, float64). Then what two
threads sharing an engine need: a dead stage makes ``finish()`` raise
instead of returning fewer results; the TF32 guard holds TF32 off until the
last of two threads that enter and leave in crossed order has left, then
restores the caller's flags; IMU appends from a second thread (through the
buffer's trim) never tear an ``_imu_slice``.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from svin_tpu_torch import sim
from svin_tpu_torch.kinematics import Transformation
from svin_tpu_torch.pipeline import VioConfig, VioEngine, synthetic_sequence
from svin_tpu_torch.pipeline.async_vio import AsyncLoopCloser, AsyncVioEngine
from svin_tpu_torch.pipeline.vio import FrameResult, _float32_matmuls
from torch_parity import port_rig

torch.set_num_threads(1)


def small_config() -> VioConfig:
    cfg = VioConfig()
    cfg.num_keyframes = 4
    cfg.num_imu_frames = 2
    cfg.max_keypoints = 150
    cfg.max_iterations = 5
    return cfg


def engine():
    return VioEngine(small_config(), rig=port_rig(), device="cpu")


def sequence(duration, seed=3, rig=None):
    events, _ = synthetic_sequence(
        rig or port_rig(), duration=duration, cam_rate=5.0, imu_rate=100.0,
        imu_params=small_config().imu, seed=seed, n_points=250,
        traj=sim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0, depth_offset=3.0,
        t_first_frame=0.12)
    return list(events)


def feed(ae, events, pace=None):
    """Events into an AsyncVioEngine (optionally paced at ``pace`` x real
    time); the number of frames fed."""
    n_frames = 0
    t_wall0, t_seq0 = time.perf_counter(), None
    for ev in events:
        if pace is not None:
            t_seq0 = ev.t if t_seq0 is None else t_seq0
            lag = (ev.t - t_seq0) / pace - (time.perf_counter() - t_wall0)
            if lag > 0:
                time.sleep(lag)
        if ev.kind == "imu":
            ae.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "frame":
            for ci, img in enumerate(ev.images):
                ae.add_image(ev.t, ci, img)
            n_frames += 1
    return n_frames


def test_async_blocking_mode_processes_all_frames():
    ae = AsyncVioEngine(engine(), blocking=True)
    results = []
    ae.state_callback = results.append
    n_frames = feed(ae, sequence(1.6))
    ae.finish()
    # the first frame initializes (it needs IMU); every later one gives a result
    assert len(results) >= n_frames - 1, (len(results), n_frames)
    ts = [r.timestamp for r in results]
    assert ts == sorted(ts)
    assert ae.dropped_frames == 0
    assert all(np.isfinite(r.T_WS.r).all() for r in results)


def test_async_out_of_order_image_rejected():
    ae = AsyncVioEngine(engine(), blocking=True)
    img = np.zeros((150, 200), np.float32)
    assert ae.add_image(1.0, 0, img)
    assert not ae.add_image(0.5, 0, img)
    ae.finish()


def test_async_propagated_state_publishing():
    """IMU-rate propagated states stream between frames once the engine is
    initialized (fed at 3x real time: the dead reckoning refuses to
    extrapolate past 3 s, so an unpaced burst could legitimately give
    none)."""
    ae = AsyncVioEngine(engine(), blocking=True)
    prop = []
    ae.propagated_state_callback = lambda t, r, q, v: prop.append((t, r))
    feed(ae, sequence(2.4), pace=3.0)
    ae.finish()
    assert len(prop) > 20
    ts = [p[0] for p in prop]
    assert ts == sorted(ts)
    assert all(np.isfinite(p[1]).all() for p in prop)


class FakeCloser:
    """Counting stand-in for a loop closer: ``add_keyframe`` returns a loop
    event for every third keyframe, ``flush`` records the call."""

    def __init__(self):
        self.keyframes, self.flushed = [], False

    def add_keyframe(self, export):
        self.keyframes.append(export["kf_index"])
        return ("loop", export["kf_index"]) if len(self.keyframes) % 3 == 0 else None

    def flush(self):
        self.flushed = True


def test_async_loop_closer_thread():
    """Keyframe exports of the real engine cross a bounded queue into the
    loop-closure worker thread."""
    closer = FakeCloser()
    acl = AsyncLoopCloser(closer, blocking=True)
    loops = []
    acl.loop_callback = loops.append
    engine_kf = [0]

    def on_kf(export):
        engine_kf[0] += 1
        acl.add_keyframe(export)

    ae = AsyncVioEngine(engine(), blocking=True)
    ae.keyframe_callback = on_kf
    feed(ae, sequence(1.6, seed=5))
    ae.finish()
    acl.finish()
    assert engine_kf[0] >= 1
    assert acl.processed == engine_kf[0] == len(closer.keyframes)
    assert acl.dropped_keyframes == 0 and closer.flushed
    assert closer.keyframes == sorted(closer.keyframes)
    assert len(loops) == engine_kf[0] // 3


class FakeEngine:
    """Counting stand-in for VioEngine (no split API: every frame goes
    through ``add_frame`` on the backend thread). ``fail_at`` makes the
    ``fail_at``-th frame raise."""

    def __init__(self, num_cameras=2, fail_at=None):
        class _Rig:
            pass

        self.rig = _Rig()
        self.rig.num_cameras = num_cameras
        self.cfg = VioConfig()
        self.calls = {"imu": 0, "frame": 0, "depth": 0, "sonar": 0}
        self.frame_times = []
        self.fail_at = fail_at
        self.lock = threading.Lock()

    def add_imu_measurement(self, t, gyro, acc):
        with self.lock:
            self.calls["imu"] += 1

    def add_depth_measurement(self, t, d):
        with self.lock:
            self.calls["depth"] += 1

    def add_sonar_measurement(self, t, r, h):
        with self.lock:
            self.calls["sonar"] += 1

    def add_frame(self, t, images):
        with self.lock:
            self.calls["frame"] += 1
            self.frame_times.append(t)
            if self.calls["frame"] == self.fail_at:
                raise ValueError("stage failure")
        return FrameResult(timestamp=t, T_WS=Transformation(r=np.zeros(3), q=np.array([0, 0, 0, 1.0])),
                           speed_bias=np.zeros(9), is_keyframe=False, num_tracked=0,
                           num_new_landmarks=0, cost=0.0)


def feed_fake(ae, n=300):
    """300 IMU samples at 100 Hz with a stereo frame at 10 Hz; (imu, frames)."""
    img = np.random.RandomState(0).rand(30, 40).astype(np.float32)
    n_imu = n_frames = 0
    for k in range(n):
        t = k * 0.01
        ae.add_imu_measurement(t, np.zeros(3), np.array([0, 0, 9.81]))
        n_imu += 1
        if k % 10 == 5:
            for ci in range(2):
                ae.add_image(t, ci, img)
            n_frames += 1
    return n_imu, n_frames


def test_dataflow_call_counts():
    fake = FakeEngine()
    ae = AsyncVioEngine(fake, blocking=True)
    results = []
    ae.state_callback = results.append
    n_imu, n_frames = feed_fake(ae)
    ae.finish()
    # every IMU sample reached the engine; every synchronized frame processed, in order
    assert fake.calls["imu"] == n_imu
    assert fake.calls["frame"] == n_frames, fake.calls
    assert fake.frame_times == sorted(fake.frame_times)
    assert len(results) == n_frames


def test_position_measurement_buffering():
    """Position measurements are accepted and buffered; the estimator
    attaches no factor to them."""
    ae = AsyncVioEngine(FakeEngine(), blocking=True)
    for k in range(5):
        ae.add_position_measurement(0.1 * k, np.array([1.0, 2.0, 3.0 + k]))
    assert len(ae.position_measurements) == 5
    t, p = ae.position_measurements[-1]
    assert t == pytest.approx(0.4) and p[2] == pytest.approx(7.0)
    ae.finish()


class SplitFake(FakeEngine):
    """A fake with the split API whose frontend stage raises on its first
    call (the first frame initializes through add_frame)."""

    n_states = 0

    def add_frame(self, t, images):
        self.n_states = 1
        return super().add_frame(t, images)

    def frontend_stage(self, t, images):
        raise ValueError("frontend failure")

    def backend_step(self, t, images, fd):  # pragma: no cover - never reached
        return None


@pytest.mark.parametrize("stage", ["frontend", "backend", "publisher"])
def test_dead_stage_makes_finish_raise(stage):
    """A stage that raises shuts the pipeline down (a blocking feeder does not
    hang on it) and ``finish()`` re-raises its exception."""
    fake = SplitFake() if stage == "frontend" else FakeEngine(fail_at=3 if stage == "backend" else None)
    ae = AsyncVioEngine(fake, blocking=True)
    if stage == "publisher":
        def bad_callback(r):
            raise ValueError("callback failure")

        ae.state_callback = bad_callback
    feed_fake(ae)
    with pytest.raises(RuntimeError, match="stage died") as info:
        ae.finish()
    assert isinstance(info.value.__cause__, ValueError)
    assert ae.error is info.value.__cause__


def test_loop_closer_dead_worker_makes_finish_raise():
    class BadCloser(FakeCloser):
        def add_keyframe(self, export):
            raise ValueError("closer failure")

    closer = BadCloser()
    acl = AsyncLoopCloser(closer, blocking=True)
    acl.add_keyframe({"kf_index": 1})
    with pytest.raises(RuntimeError, match="died"):
        acl.finish()
    assert not closer.flushed


def test_tf32_guard_two_threads_crossed_order():
    """Thread A enters, B enters, A leaves while B is inside (TF32 must stay
    off), B leaves: the caller's flags come back."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    a_in, b_in, a_out, b_may_leave = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with _float32_matmuls():
            a_in.set()
            b_in.wait(5)
        a_out.set()

    def thread_b():
        a_in.wait(5)
        with _float32_matmuls():
            b_in.set()
            a_out.wait(5)
            seen["inside_b_after_a_left"] = (torch.backends.cuda.matmul.allow_tf32,
                                             torch.backends.cudnn.allow_tf32)
            b_may_leave.wait(5)

    try:
        ta, tb = threading.Thread(target=thread_a), threading.Thread(target=thread_b)
        ta.start()
        tb.start()
        ta.join(10)
        assert a_out.is_set()
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            False, False)  # B is still inside
        b_may_leave.set()
        tb.join(10)
        assert seen["inside_b_after_a_left"] == (False, False)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_imu_appends_from_a_second_thread_during_slices():
    """A feeder thread appends 25,000 samples (the buffer trims its oldest
    2,000 past 10,000) while this thread takes slices and the frontend's
    attitude prediction reads the buffer: every slice is consistent (each
    sample's gyro and acc rows carry its own timestamp)."""
    eng = engine()
    stop = threading.Event()
    N = 25_000

    def feeder():
        for k in range(N):
            t = 0.001 * k
            eng.add_imu_measurement(t, [t, t, t], [t, -t, t])
        stop.set()

    th = threading.Thread(target=feeder)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        th.start()
        n_slices = 0
        while not stop.is_set() or n_slices < 50:
            with eng._imu_mutex:
                t_new = eng.imu_t[-1] if eng.imu_t else 0.0
            sl = eng._imu_slice(t_new - 0.5, t_new)
            if sl is not None:
                ts, gy, ac, mask = sl
                np.testing.assert_array_equal(gy, np.stack([ts] * 3, axis=1))
                np.testing.assert_array_equal(ac, np.stack([ts, -ts, ts], axis=1))
                assert mask.all() and (np.diff(ts) > 0).all()
                n_slices += 1
            eng.window.timestamp[0] = t_new - 0.05
            eng._attitude_prediction(t_new)
        th.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not th.is_alive()
    assert n_slices >= 50
    assert len(eng.imu_t) == len(eng.imu_gyro) == len(eng.imu_acc) <= 10000


def test_initialization_reads_imu_up_to_the_frame_only():
    """A threaded feeder can buffer IMU past the first frame before the
    backend initializes it; the initial attitude comes from the samples up
    to the frame's stamp all the same (the JAX engine averages the buffer's
    tail whatever its time, and here that tail is tilted)."""
    rng = np.random.default_rng(0)
    ts = 0.01 * np.arange(100)
    acc = np.array([0.3, -0.2, 9.81]) + 0.01 * rng.standard_normal((100, 3))
    acc[ts > 0.3] = [4.0, 0.0, 8.9]  # the platform tilts after the frame
    img = np.random.default_rng(1).random((150, 200)).astype(np.float32)
    poses = []
    for n in (int(np.sum(ts <= 0.25 + 1e-9)), 100):  # fed up to the frame, or a second past it
        eng = engine()
        for k in range(n):
            eng.add_imu_measurement(ts[k], np.zeros(3), acc[k])
        r = eng.add_frame(0.25, [img, img])
        poses.append(np.asarray(r.T_WS.q))
    np.testing.assert_array_equal(poses[1], poses[0])
