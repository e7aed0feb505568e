"""The gauntlet variants (``tests/test_gauntlet_variants.py``) through the
port's CLI: (a) the 6-DoF pose graph on a sequence with 5x gyro noise in
the simulator only, where the SE(3) mode must improve the rotation drift
over raw VIO without degrading the position ATE past 1.05x; (b) a mono
rig, where every landmark comes from the temporal bootstrap, held to the
JAX test's ATE bounds. The configs, ``SVIN_SYNTH_*`` settings and bounds
are the JAX tests'; the sequences are the port's own realization, run by
``svin_tpu_torch.apps.run_synchronous`` with ``--device cpu`` (float64).
One module-scoped run per fixture, ~100 s for the two on one core: marked
``slow`` to keep tier-1 within its time, with the stereo gauntlet
(``test_torch_gauntlet.py``) and the CLI parity quick case as its cover
there. On the port's realization of the 6-DoF sequence the closer takes
49 keyframes, fewer than the 51 its recency window needs before it
queries, so it closes no loop (the JAX realization takes 62 and closes
7); the assertions then compare the keyframe trajectory with the frame
trajectory. The mono run closes no loop in either package.
"""
import os

import pytest
import torch

from test_gauntlet_variants import _CAM0, _CAM1, _COMMON
from test_torch_gauntlet import evaluate, run_port_cli

torch.set_num_threads(1)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def gauntlet_6dof(tmp_path_factory):
    yaml_text = ("%YAML:1.0\ncameras:\n" + _CAM0 + _CAM1 + _COMMON + """
loop_closure_params:
    enable: 1
    min_correspondences: 12
    pgo_mode: "6dof"
""")
    return run_port_cli(tmp_path_factory.mktemp("g6dof"), yaml_text,
                        {"SVIN_SYNTH_DURATION": "45", "SVIN_SYNTH_REVISIT": "1",
                         "SVIN_SYNTH_GYRO_NOISE_SCALE": "5"})


def test_gauntlet_6dof_corrects_full_rotation_drift(gauntlet_6dof):
    n_v, rmse_v, r_v = evaluate(gauntlet_6dof, "svin_vio")
    n_l, rmse_l, r_l = evaluate(gauntlet_6dof, "svin_loop")
    assert n_v >= 120 and n_l >= 40
    assert rmse_l < 1.05 * rmse_v, (rmse_l, rmse_v)
    assert r_l["rpe_rot_rmse_deg"] < r_v["rpe_rot_rmse_deg"], (r_l, r_v)


@pytest.fixture(scope="module")
def gauntlet_mono(tmp_path_factory):
    yaml_text = ("%YAML:1.0\ncameras:\n" + _CAM0 + _COMMON + """
loop_closure_params:
    enable: 1
    min_correspondences: 12
""")
    return run_port_cli(tmp_path_factory.mktemp("gmono"), yaml_text,
                        {"SVIN_SYNTH_DURATION": "40", "SVIN_SYNTH_REVISIT": "1"})


def test_gauntlet_mono_end_to_end(gauntlet_mono):
    n_v, rmse_v, r_v = evaluate(gauntlet_mono, "svin_vio")
    assert n_v >= 100
    assert rmse_v < 0.8, rmse_v
    n_l, rmse_l, _ = evaluate(gauntlet_mono, "svin_loop")
    assert n_l >= 30
    assert rmse_l <= rmse_v * 1.05, (rmse_l, rmse_v)


def test_gauntlet_mono_outputs(gauntlet_mono):
    files = set(os.listdir(gauntlet_mono))
    assert {"svin_vio.txt", "svin_loop.txt", "state.csv"} <= files
