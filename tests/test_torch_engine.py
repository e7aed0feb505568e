"""The port's ``VioEngine`` against the JAX package's, frame by frame, and
the JAX pipeline tests' contracts on the port.

Input: one JAX event stream at ``vio_fixtures.standard_run``'s parameters
(two 200x150 cameras, 300 blobs, 6 Hz for 2.6 s, start-from-rest
trajectory, seed 3) with water-depth and sonar events, replayed into both
engines in float64 on the CPU. The port engine draws its RANSAC samples
with the JAX engine's keys (``jax_engine_draw``). ``time_limit`` is 0 in
both: the per-frame LM budget would otherwise follow each engine's own wall
clock.

Per frame: identical ``is_keyframe``, ``num_tracked`` and
``num_new_landmarks``, and positions within 1e-6 m (the two engines'
float64 LM solves and RANSAC Jacobians differ by rounding; detection and
descriptors agree exactly on these frames). The hand-over case loads the
JAX engine's host state after frame 6 into a fresh port engine
(``convert.engine_from_state``) and steps both over the rest.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from svin_tpu import sim as jsim
from svin_tpu.pipeline import VioEngine as JaxEngine
from svin_tpu.pipeline import synthetic_sequence as jax_sequence
from svin_tpu_torch import sim as tsim
from svin_tpu_torch.convert import ENGINE_STATE_FIELDS, config_from_numpy, engine_from_state
from svin_tpu_torch.evaluation import ate_rmse
from svin_tpu_torch.pipeline import VioEngine, run_events, synthetic_sequence
from torch_parity import jax_engine_draw, port_rig
from vio_fixtures import IMG_H, IMG_W, small_config, small_rig

torch.set_num_threads(1)

T_SSO = np.array([[1.0, 0, 0, 0.05], [0, 1.0, 0, 0], [0, 0, 1.0, -0.1], [0, 0, 0, 1.0]])
HANDOVER_FRAME = 6
POS_TOL = 1e-6


def _jax_config():
    cfg = small_config()
    cfg.time_limit = 0.0
    cfg.is_depth_used = True
    cfg.is_sonar_used = True
    cfg.T_SSo = T_SSO
    return cfg


def port_engine(dtype=torch.float64, jax_draws=True):
    eng = VioEngine(config_from_numpy(_jax_config()), rig=port_rig(), dtype=dtype, device="cpu")
    if jax_draws:
        eng.draw_hypotheses = jax_engine_draw
    return eng


def jax_state(e) -> dict:
    """A copy of the JAX engine's host state as numpy and Python values
    (the engine goes on mutating its arrays in place)."""
    st = {k: jax.device_get(getattr(e, k)) for k in ENGINE_STATE_FIELDS
          if k not in ("frames", "_rng", "scale_refiner", "_last_ransac_T_WS")}
    st["frames"] = {
        s: {f.name: getattr(fd, f.name) for f in dataclasses.fields(fd) if f.name != "image0"}
        | {"image0": None if fd.image0 is None else np.asarray(jax.device_get(fd.image0))}
        for s, fd in e.frames.items()
    }
    st["_rng"] = e._rng.get_state()
    sr = dict(vars(e.scale_refiner))
    sr["result"] = None if sr["result"] is None else dict(vars(sr["result"]))
    st["scale_refiner"] = sr
    T = e._last_ransac_T_WS
    st["_last_ransac_T_WS"] = None if T is None else (np.asarray(T.r), np.asarray(T.q))
    return copy.deepcopy(st)


@pytest.fixture(scope="module")
def run():
    events, renderer = jax_sequence(
        small_rig(), duration=2.6, cam_rate=6.0, imu_rate=100.0, imu_params=_jax_config().imu,
        seed=3, n_points=300, traj=jsim.default_trajectory(scale=0.4, ramp_tau=0.8),
        spread=6.0, depth_offset=3.0, t_first_frame=0.12, depth_enabled=True,
        sonar_enabled=True, sonar_T_SSo=T_SSO,
    )
    events = list(events)
    jeng = JaxEngine(_jax_config(), rig=small_rig())
    jres, state, n_frames, handover_at = [], None, 0, None
    for i, ev in enumerate(events):
        if ev.kind == "imu":
            jeng.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "depth":
            jeng.add_depth_measurement(ev.t, ev.depth)
        elif ev.kind == "sonar":
            jeng.add_sonar_measurement(ev.t, *ev.sonar)
        else:
            r = jeng.add_frame(ev.t, ev.images)
            if r is not None:
                jres.append(r)
                n_frames += 1
                if n_frames == HANDOVER_FRAME:
                    state, handover_at = jax_state(jeng), i + 1
    gt = {r.timestamp: np.asarray(renderer.pose(r.timestamp).r) for r in jres}
    return dict(events=events, jres=jres, jeng=jeng, state=state, handover_at=handover_at, gt=gt)


def _check_frames(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a.is_keyframe, a.num_tracked, a.num_new_landmarks) == (
            b.is_keyframe, b.num_tracked, b.num_new_landmarks), f"frame {i}"
        assert a.timestamp == b.timestamp
        np.testing.assert_allclose(a.T_WS.r, np.asarray(b.T_WS.r), rtol=0, atol=POS_TOL,
                                   err_msg=f"frame {i}")


def test_engine_matches_jax_frame_by_frame(run):
    eng = port_engine()
    res = run_events(eng, run["events"])
    _check_frames(res, run["jres"])
    assert sum(r.is_keyframe for r in res) >= 3
    assert eng.n_states == run["jeng"].n_states
    np.testing.assert_array_equal(eng.window.lm_valid, run["jeng"].window.lm_valid)


def test_engine_handover_from_jax_state(run):
    eng = engine_from_state(port_engine(), run["state"])
    res = run_events(eng, run["events"][run["handover_at"]:])
    _check_frames(res, run["jres"][HANDOVER_FRAME:])


@pytest.fixture(scope="module")
def own_run(run):
    """The port engine with its own device draws and the config's real-time
    LM budget, on the same events."""
    eng = port_engine(jax_draws=False)
    eng.cfg.time_limit = 0.035
    return eng, run_events(eng, run["events"])


def test_pipeline_runs_and_tracks(own_run):
    eng, results = own_run
    assert len(results) >= 10
    assert np.median([r.num_tracked for r in results[1:]]) >= 20
    assert results[0].is_keyframe


def test_pipeline_trajectory_accuracy(own_run, run):
    _, results = own_run
    est = np.stack([r.T_WS.r for r in results])
    gt = np.stack([run["gt"][r.timestamp] for r in results])
    rmse, _ = ate_rmse(est, gt, with_scale=False)
    assert rmse < 0.05, rmse
    _, align_s = ate_rmse(est, gt, with_scale=True)
    assert abs(align_s.scale - 1.0) < 0.05, align_s.scale


def test_pipeline_marginalization_bounded_window(own_run):
    eng, _ = own_run
    assert eng.n_states == eng.wcfg.num_states - 1  # full window after the fused marginalization
    assert int(eng.window.state_valid.sum()) == eng.n_states


def test_pipeline_keyframe_export_contract(own_run):
    _, results = own_run
    kfs = [r.keyframe_export for r in results if r.keyframe_export is not None]
    assert len(kfs) >= 1
    kf = kfs[-1]
    for key in ("kf_index", "timestamp", "image", "T_WC_r", "T_WC_q", "points_W",
                "landmark_ids", "keypoints_uv", "quality", "num_tracked", "quadrant_counts",
                "response_strengths", "covisibilities"):
        assert key in kf, key
    assert kf["points_W"].shape[1] == 3
    assert len(kf["landmark_ids"]) == len(kf["points_W"])
    assert kf["image"].shape == (IMG_H, IMG_W) and kf["image"].dtype == np.uint8


def test_trajectory_save_tum(tmp_path, own_run):
    eng, _ = own_run
    p = tmp_path / "traj.txt"
    eng.save_trajectory_tum(str(p))
    rows = np.loadtxt(p)
    assert rows.shape == (len(eng.trajectory), 8)


def test_landmark_covariance_stays_finite_in_float32():
    """float32 engine on the port's own sequence; after frame 4 every
    landmark but one observation of 20 is cut (as outlier pruning leaves
    them). Their rank-2 Hessian blocks give inf covariances in float32 that
    pass the quality bound alone; the engine's gate table stays finite."""
    rig = port_rig()
    cfg = config_from_numpy(small_config())
    eng = VioEngine(cfg, rig=rig, dtype=torch.float32, device="cpu")
    events, _ = synthetic_sequence(
        rig, duration=1.3, cam_rate=6.0, imu_rate=100.0, imu_params=cfg.imu, seed=3,
        n_points=300, traj=tsim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0,
        depth_offset=3.0, t_first_frame=0.12)
    raw = []
    apply = eng._apply_opt_results

    def record(win_h, fac_h, cost_h, iters_h, lm_cov_h, *a, **k):
        raw.append((win_h.lm_valid & (win_h.lm_quality > 1e-6)
                    & ~np.isfinite(lm_cov_h).all(axis=(1, 2))).sum())
        return apply(win_h, fac_h, cost_h, iters_h, lm_cov_h, *a, **k)

    eng._apply_opt_results = record
    n = 0
    for ev in events:
        if ev.kind == "imu":
            eng.add_imu_measurement(ev.t, *ev.imu)
            continue
        eng.add_frame(ev.t, ev.images)
        n += 1
        assert np.isfinite(eng._lm_cov).all(), f"frame {n}"
        if n == 4:
            f = eng.factors.reproj
            for lm in np.nonzero(eng.window.lm_valid)[0][:20]:
                f.valid[np.nonzero(f.valid & (f.lm_idx == lm))[0][1:]] = False
    assert n >= 7
    assert max(raw) > 0  # the quality bound alone would have let inf in
