"""The accuracy gauntlet (``tests/test_gauntlet.py``) through the port's CLI.

One 63 s rendered sonar-visual-inertial-depth sequence with revisits and a
featureless stretch at 30-32 s runs through
``svin_tpu_torch.apps.run_synchronous`` with ``--device cpu`` (float64, the
kernels' plain versions): VIO with sonar and depth factors, loop closure,
the health gate and the switching estimator against primitive odometry,
and the TUM / CSV / PLY outputs. The config and the ``SVIN_SYNTH_*``
settings are the JAX test's, with the config's real-time LM budget as
there; the sequence is the port's own ``--synthetic`` realization (its
scene and noise streams differ from the JAX renderer's by design).

The assertions and bounds are the JAX test's: Sim(3)-ATE within
``tolerance_factor`` (1.3) x ``calibrated_cpu_f64`` of
``artifacts/ACCURACY_TREND.json`` for the VIO, loop and robust
trajectories, the VIO RPE likewise, at least 180 poses, the loop
trajectory below 0.75x the VIO ATE, the switch to the primitive estimator
within [30, 34] s and back after it, every output written and more than 50
map vertices. Ground truth, ATE and RPE come from ``svin_tpu_torch.sim`` and
``svin_tpu_torch.evaluation``. One module-scoped run, ~90-120 s on one core.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_gauntlet import CONFIG_YAML

torch.set_num_threads(1)

_TREND = json.load(open(os.path.join(os.path.dirname(__file__), "..", "artifacts",
                                     "ACCURACY_TREND.json")))
CAL = _TREND["calibrated_cpu_f64"]
TOL = float(_TREND["tolerance_factor"])
SETTINGS = {"SVIN_SYNTH_DURATION": "63", "SVIN_SYNTH_REVISIT": "1",
            "SVIN_SYNTH_DEGRADE": "30:32", "SVIN_SYNTH_PRIMITIVE": "1"}


def run_port_cli(tmp, yaml_text, env):
    """The port's run_synchronous on the CPU under ``env``'s settings."""
    from svin_tpu_torch.apps.run_synchronous import main

    cfg_path = tmp / "rig.yaml"
    cfg_path.write_text(yaml_text)
    out_dir = tmp / "out"
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc = main([str(cfg_path), "--synthetic", str(out_dir), "--device", "cpu"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0
    return out_dir


def evaluate(out_dir, name):
    """(poses, Sim(3)-ATE, RPE over 5 s) of ``<name>.txt`` against the
    revisiting trajectory's ground truth."""
    from svin_tpu_torch import sim
    from svin_tpu_torch.evaluation import ate_rmse, load_tum, rpe

    t, p, q = load_tum(str(out_dir / f"{name}.txt"))
    traj = sim.default_trajectory(scale=0.4, ramp_tau=0.8)
    traj = traj._replace(r_lin=traj.r_lin * 0.0)
    T = sim.pose(traj, torch.as_tensor(t, dtype=torch.float64))
    gt_p, gt_q = T.r.numpy(), T.q.numpy()
    rmse, _ = ate_rmse(p, gt_p, with_scale=True)
    r = rpe(t, p, q, gt_p, gt_q, delta_s=5.0)
    return len(p), rmse, r


@pytest.fixture(scope="module")
def gauntlet_run(tmp_path_factory):
    return run_port_cli(tmp_path_factory.mktemp("gauntlet"), CONFIG_YAML, SETTINGS)


def test_gauntlet_vio_accuracy(gauntlet_run):
    n, rmse, r = evaluate(gauntlet_run, "svin_vio")
    assert n >= 180  # ~189 frames over 63 s at 3 Hz
    assert rmse < TOL * CAL["svin_vio_ate_m"], (rmse, CAL["svin_vio_ate_m"])
    assert r["rpe_trans_rmse"] < TOL * CAL["svin_vio_rpe_trans_m"], r


def test_gauntlet_loop_correction_improves(gauntlet_run):
    n_v, rmse_v, _ = evaluate(gauntlet_run, "svin_vio")
    n_l, rmse_l, r_l = evaluate(gauntlet_run, "svin_loop")
    assert n_l >= 50
    assert rmse_l < TOL * CAL["svin_loop_ate_m"], (rmse_l, CAL["svin_loop_ate_m"])
    assert rmse_l < 0.75 * rmse_v, (rmse_l, rmse_v)


def test_gauntlet_robust_trajectory_and_switching(gauntlet_run):
    n, rmse, _ = evaluate(gauntlet_run, "svin_robust")
    assert n >= 50
    assert rmse < TOL * CAL["svin_robust_ate_m"], (rmse, CAL["svin_robust_ate_m"])
    log = (gauntlet_run / "switch_info.txt").read_text()
    lines = [x for x in log.splitlines() if x.strip()]
    to_prim = [x for x in lines if "VIO->PRIMITIVE" in x]
    to_vio = [x for x in lines if "PRIMITIVE->VIO" in x]
    assert to_prim and to_vio, log
    t_switch = float(to_prim[0].split()[0])
    assert 30.0 <= t_switch <= 34.0, log
    t_back = float(to_vio[0].split()[0])
    assert t_back > t_switch


def test_gauntlet_outputs_complete(gauntlet_run):
    files = set(os.listdir(gauntlet_run))
    assert {
        "svin_vio.txt", "svin_loop.txt", "svin_robust.txt",
        "global_map.ply", "state.csv", "landmarks.csv", "switch_info.txt",
    } <= files
    ply = (gauntlet_run / "global_map.ply").read_text().splitlines()
    n_pts = int(next(x for x in ply if x.startswith("element vertex")).split()[-1])
    assert n_pts > 50, n_pts


def test_ground_truth_matches_the_jax_simulator(gauntlet_run):
    """The port's ground truth at the run's stamps is the JAX simulator's
    (both packages evaluate one analytic trajectory)."""
    from svin_tpu import sim as jsim
    from svin_tpu_torch import sim

    t = np.loadtxt(gauntlet_run / "svin_vio.txt", ndmin=2)[:, 0]
    jt = jsim.default_trajectory(scale=0.4, ramp_tau=0.8)
    jt = jt._replace(r_lin=jt.r_lin * 0.0)
    tt = sim.default_trajectory(scale=0.4, ramp_tau=0.8)
    tt = tt._replace(r_lin=tt.r_lin * 0.0)
    T = sim.pose(tt, torch.as_tensor(t, dtype=torch.float64))
    for k in (0, len(t) // 2, len(t) - 1):
        Tj = jsim.pose(jt, t[k])
        np.testing.assert_allclose(T.r[k].numpy(), np.asarray(Tj.r), rtol=0, atol=1e-12)
        np.testing.assert_allclose(T.q[k].numpy(), np.asarray(Tj.q), rtol=0, atol=1e-12)
