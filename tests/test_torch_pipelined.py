"""The port's pipelined engine (``frontend_stage`` → ``backend_step``, then
``backend_flush``) against the JAX engine's, frame by frame.

Input: the events of ``test_torch_engine.py``'s run (two 200x150 cameras,
water-depth and sonar events, seed 3), replayed into both engines' split
drive on one thread in float64 on the CPU, ``time_limit`` 0, the port drawing
its RANSAC samples with the JAX engine's keys (``jax_engine_draw``). The frame
that initializes goes through ``add_frame``, every later one through the two
stages; results come out one frame late and the flush emits the last.

Per frame: identical ``is_keyframe``, ``num_tracked``, ``num_new_landmarks``
and timestamps, positions within 1e-6 m; as many results as the port's
serial path; equal ``lm_valid`` at the end. Then one frame with no landmarks
in the map through both engines: the match stage is dispatched anyway (one
draw from ``_rng``) and the miss streak grows, as the JAX engine does.
"""
import numpy as np
import pytest
import torch

from svin_tpu.pipeline import VioEngine as JaxEngine
from svin_tpu.pipeline import synthetic_sequence as jax_sequence
from svin_tpu import sim as jsim
from svin_tpu_torch.pipeline import run_events
from test_torch_engine import T_SSO, _check_frames, _jax_config, port_engine
from vio_fixtures import small_rig

torch.set_num_threads(1)


def split_drive(engine, events):
    """Events into an engine's split steps on one thread; the results in
    order (the initializing frame's from ``add_frame``)."""
    results = []

    def keep(r):
        if r is not None:
            results.append(r)

    for ev in events:
        if ev.kind == "imu":
            engine.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "depth":
            engine.add_depth_measurement(ev.t, ev.depth)
        elif ev.kind == "sonar":
            engine.add_sonar_measurement(ev.t, *ev.sonar)
        elif engine.n_states == 0:
            keep(engine.add_frame(ev.t, ev.images))
        else:
            t_s, fd = engine.frontend_stage(ev.t, ev.images)
            keep(engine.backend_step(t_s, ev.images, fd))
    keep(engine.backend_flush())
    return results


def draws_between(before, after, limit=10):
    """How many ``randint(0, 2**31)`` draws take RandomState state ``before``
    to ``after`` (None if more than ``limit``)."""
    r = np.random.RandomState()
    r.set_state(before)
    for n in range(limit + 1):
        st = r.get_state()
        if st[2] == after[2] and np.array_equal(st[1], after[1]):
            return n
        r.randint(0, 2**31)
    return None


def empty_map_frame(engine, t, images):
    """One more split frame through ``engine`` after the map is emptied:
    (miss streak before, after, draws from ``_rng``)."""
    engine.window.lm_valid[:] = False
    streak, rng = engine._track_miss_streak, engine._rng.get_state()
    t_s, fd = engine.frontend_stage(t, images)
    engine.backend_step(t_s, images, fd)
    engine.backend_flush()
    return streak, engine._track_miss_streak, draws_between(rng, engine._rng.get_state())


@pytest.fixture(scope="module")
def run():
    events, _ = jax_sequence(
        small_rig(), duration=2.6, cam_rate=6.0, imu_rate=100.0, imu_params=_jax_config().imu,
        seed=3, n_points=300, traj=jsim.default_trajectory(scale=0.4, ramp_tau=0.8),
        spread=6.0, depth_offset=3.0, t_first_frame=0.12, depth_enabled=True,
        sonar_enabled=True, sonar_T_SSo=T_SSO,
    )
    events = list(events)
    jeng = JaxEngine(_jax_config(), rig=small_rig())
    jres = split_drive(jeng, events)
    jlm = jeng.window.lm_valid.copy()
    last = [ev for ev in events if ev.kind == "frame"][-1]
    j_empty = empty_map_frame(jeng, last.t + 0.05, last.images)
    return dict(events=events, jres=jres, jlm=jlm, last=last, j_empty=j_empty)


@pytest.fixture(scope="module")
def port_run(run):
    eng = port_engine()
    res = split_drive(eng, run["events"])
    lm = eng.window.lm_valid.copy()
    last = run["last"]
    return dict(eng=eng, res=res, lm=lm, empty=empty_map_frame(eng, last.t + 0.05, last.images))


def test_split_drive_matches_jax_frame_by_frame(run, port_run):
    _check_frames(port_run["res"], run["jres"])
    assert sum(r.is_keyframe for r in port_run["res"]) >= 3
    np.testing.assert_array_equal(port_run["lm"], run["jlm"])


def test_split_drive_emits_every_frame_in_order(run, port_run):
    """One result per frame, in order, the last one from the flush: as many
    as the serial path gives on the same events."""
    res = port_run["res"]
    n_frames = sum(ev.kind == "frame" for ev in run["events"])
    serial = run_events(port_engine(), run["events"])
    assert len(res) == len(serial) == n_frames
    ts = [r.timestamp for r in res]
    assert ts == sorted(ts) and len(set(ts)) == len(ts)
    assert ts == [r.timestamp for r in serial]


def test_flush_emits_the_last_frame_once(port_run):
    eng = port_run["eng"]
    assert eng._pending is None
    assert eng.backend_flush() is None


def test_frame_without_landmarks_draws_and_bumps_the_streak(run, port_run):
    """With no landmark in the map the pipelined match stage still runs: a
    draw from ``_rng`` and a miss-streak bump, in both engines alike."""
    before, after, n_draws = port_run["empty"]
    assert after == before + 1
    assert n_draws is not None and n_draws >= 1
    assert port_run["empty"] == run["j_empty"]
