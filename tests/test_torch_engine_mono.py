"""The port's ``VioEngine`` on a monocular rig against the JAX package's:
the temporal 2D-2D bootstrap (flow-gated matching, rotation-only vs
relative-pose RANSAC, triangulation) is the only landmark source, so this
drives ``temporal_match_tri`` and its bookkeeping every keyframe.

Input: the JAX event stream at ``tests/test_mono.py``'s parameters (one
200x150 camera, 300 blobs, 6 Hz for 2.6 s, seed 3), replayed into both
engines in float64 on the CPU, the JAX engine's RANSAC draws injected,
``time_limit`` 0 (the LM budget would follow each engine's wall clock).

Per frame: identical ``is_keyframe``, ``num_tracked`` and
``num_new_landmarks``, positions within 1e-6 m; then ``test_mono.py``'s
contracts on the port.
"""
import numpy as np
import pytest
import torch

from svin_tpu import sim as jsim
from svin_tpu.cameras import NCameraSystem as JaxRig
from svin_tpu.cameras import make_camera as jax_camera
from svin_tpu.kinematics import from_rq as jax_from_rq
from svin_tpu.pipeline import VioEngine as JaxEngine
from svin_tpu.pipeline import run_events as jax_run_events
from svin_tpu.pipeline import synthetic_sequence as jax_sequence
from svin_tpu_torch.cameras import NCameraSystem, make_camera
from svin_tpu_torch.convert import config_from_numpy
from svin_tpu_torch.evaluation import ate_rmse
from svin_tpu_torch.kinematics import from_rq
from svin_tpu_torch.pipeline import VioEngine, run_events
from torch_parity import jax_engine_draw
from vio_fixtures import IMG_H, IMG_W, small_config

torch.set_num_threads(1)


def _config():
    cfg = small_config()
    cfg.time_limit = 0.0
    return cfg


def _rigs():
    jrig, trig = JaxRig(), NCameraSystem()
    jrig.add_camera(jax_from_rq([0.0, 0.0, 0.0], [0, 0, 0, 1]),
                    jax_camera(IMG_W, IMG_H, 160.0, 160.0, 100.0, 75.0, model="none"))
    trig.add_camera(from_rq([0.0, 0.0, 0.0], [0, 0, 0, 1]),
                    make_camera(IMG_W, IMG_H, 160.0, 160.0, 100.0, 75.0, model="none"))
    return jrig, trig


@pytest.fixture(scope="module")
def runs():
    jrig, trig = _rigs()
    events, renderer = jax_sequence(
        jrig, duration=2.6, cam_rate=6.0, imu_rate=100.0, imu_params=_config().imu, seed=3,
        n_points=300, traj=jsim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0,
        depth_offset=3.0, t_first_frame=0.12)
    events = list(events)
    jres = jax_run_events(JaxEngine(_config(), rig=jrig), events)
    eng = VioEngine(config_from_numpy(_config()), rig=trig, device="cpu")
    eng.draw_hypotheses = jax_engine_draw
    res = run_events(eng, events)
    gt = np.stack([np.asarray(renderer.pose(r.timestamp).r) for r in jres])
    return jres, res, gt


def test_mono_engine_matches_jax_frame_by_frame(runs):
    jres, res, _ = runs
    assert len(res) == len(jres)
    for i, (a, b) in enumerate(zip(res, jres)):
        assert (a.is_keyframe, a.num_tracked, a.num_new_landmarks) == (
            b.is_keyframe, b.num_tracked, b.num_new_landmarks), f"frame {i}"
        np.testing.assert_allclose(a.T_WS.r, np.asarray(b.T_WS.r), rtol=0, atol=1e-6,
                                   err_msg=f"frame {i}")


def test_mono_creates_landmarks_tracks_and_stays_bounded(runs):
    _, res, gt = runs
    assert sum(r.num_new_landmarks for r in res) >= 20
    assert np.median([r.num_tracked for r in res[2:]][-5:]) >= 10
    rmse, _ = ate_rmse(np.stack([r.T_WS.r for r in res]), gt, with_scale=True)
    assert rmse < 0.25, rmse
