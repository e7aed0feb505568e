"""C3: the JAX package's ``run_synchronous`` and the port's on the same input.

The two ``--synthetic`` sequences are different realizations by design: the
JAX renderer draws its scene and IMU noise with ``jax.random``, the port's
with ``numpy.random.Generator`` streams. And the LM budget follows the wall
clock: each frame gets ``clip(timeLimit / EMA(s per iteration), 3, 5)``
iterations. So the two CLIs run here on

- the same events: the JAX package's ``events_from_source("--synthetic")``
  under the gauntlet's ``SVIN_SYNTH_*`` settings, rendered once and fed to
  both CLIs (``events_from_source`` patched in both packages);
- the same draws: the port's engine and closer draw the JAX engine's
  RANSAC samples and the JAX closer's P3P samples (``build`` patched to set
  ``draw_hypotheses`` and ``draw_p3p``);
- a fixed LM budget: the JAX gauntlet's config with ``timeLimit: 0.0``.

Compared, float64 on the CPU: ``state.csv`` row by row (stamps equal,
positions and orientations within 1e-6); ``switch_info.txt`` equal; the
keyframe and loop counts, the closer's funnel counters and each
pose-graph solve's ``cost_loop_before`` / ``cost_loop_after`` (within 1e-6
relative plus the log's 5-decimal rounding) from ``loop_stats.json``;
``svin_loop.txt`` and ``svin_robust.txt`` positions within 1e-6 m (the
files print 6 decimals, so one unit of the last digit is allowed).

Quick case (tier-1): 6 s with the featureless stretch at 2-4 s and
primitive odometry. It is the shortest sequence found on which the JAX CLI
switches to the primitive estimator inside the stretch (3.45 s) and back
(4.79 s). Sequences of 6-12 s with the 2 s stretch ending 2 s before the
end, and of 14 s with it at 8-10 s, all agree within 2.4e-7 m. Full case
(``-m slow``, ~6 min): the 63 s gauntlet, where loops close; measured on
the CPU: 189 frames within 6.1e-8 m, 85 keyframes, 29 loops, 29 pose-graph
solves with equal logged costs.
"""
import json

import numpy as np
import pytest
import torch

from test_gauntlet import CONFIG_YAML
from torch_parity import jax_engine_draw, jax_p3p_draws

torch.set_num_threads(1)

PARITY_YAML = CONFIG_YAML.replace("    maxIterations: 5\n",
                                  "    maxIterations: 5\n    timeLimit: 0.0\n")
QUICK = {"SVIN_SYNTH_DURATION": "6", "SVIN_SYNTH_REVISIT": "1", "SVIN_SYNTH_DEGRADE": "2:4",
         "SVIN_SYNTH_PRIMITIVE": "1"}
FULL = {"SVIN_SYNTH_DURATION": "63", "SVIN_SYNTH_REVISIT": "1", "SVIN_SYNTH_DEGRADE": "30:32",
        "SVIN_SYNTH_PRIMITIVE": "1"}
POS_TOL = 1e-6
TUM_TOL = 1e-6 * (1 + 1e-6)  # 6 printed decimals: one unit of the last digit
COST_RTOL, COST_ROUND = 1e-6, 1e-5  # the pose-graph log rounds costs to 5 decimals


def run_both(tmp, env, monkeypatch):
    """Both CLIs on one JAX event list: (JAX output dir, port output dir)."""
    import svin_tpu.pipeline as jpipe
    import svin_tpu_torch.pipeline as tpipe
    from svin_tpu.apps.run_synchronous import main as jax_main
    from svin_tpu.pipeline import load_config
    from svin_tpu_torch.apps import run_synchronous

    assert "timeLimit: 0.0" in PARITY_YAML
    cfg_path = tmp / "rig.yaml"
    cfg_path.write_text(PARITY_YAML)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = load_config(str(cfg_path))
    events = list(jpipe.events_from_source("--synthetic", cfg, cfg.build_rig()))
    monkeypatch.setattr(jpipe, "events_from_source", lambda *a: iter(events))
    monkeypatch.setattr(tpipe, "events_from_source", lambda *a: iter(events))
    build = run_synchronous.build

    def build_with_jax_draws(cfg, device):
        engine, closer = build(cfg, device)
        engine.draw_hypotheses = jax_engine_draw
        closer.draw_p3p = jax_p3p_draws
        return engine, closer

    monkeypatch.setattr(run_synchronous, "build", build_with_jax_draws)
    assert jax_main([str(cfg_path), "--synthetic", str(tmp / "jax")]) == 0
    assert run_synchronous.main([str(cfg_path), "--synthetic", str(tmp / "port"),
                                 "--device", "cpu"]) == 0
    return tmp / "jax", tmp / "port"


def first_departure(a, b, tol):
    """The first row where two state logs' stamps differ or their positions
    part by more than ``tol``, else None."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i, 0] != b[i, 0] or np.abs(a[i, 1:4] - b[i, 1:4]).max() > tol:
            return i
    return None if len(a) == len(b) else n


def assert_same_run(jdir, pdir):
    js = np.loadtxt(jdir / "state.csv", delimiter=",", ndmin=2)
    ps = np.loadtxt(pdir / "state.csv", delimiter=",", ndmin=2)
    i = first_departure(js, ps, POS_TOL)
    assert i is None, (f"state.csv parts at row {i}: JAX {js[i, :4] if i < len(js) else None}, "
                       f"port {ps[i, :4] if i < len(ps) else None}")
    np.testing.assert_allclose(ps[:, 4:8], js[:, 4:8], rtol=0, atol=POS_TOL, err_msg="q_WS")
    assert (pdir / "switch_info.txt").read_text() == (jdir / "switch_info.txt").read_text()
    jl = json.loads((jdir / "loop_stats.json").read_text())
    pl = json.loads((pdir / "loop_stats.json").read_text())
    for k in ("n_keyframes", "n_loops", "n_restored", "stats", "earliest_loop_index"):
        assert pl[k] == jl[k], (k, pl[k], jl[k])
    assert len(pl["pgo_log"]) == len(jl["pgo_log"])
    for n, (p, j) in enumerate(zip(pl["pgo_log"], jl["pgo_log"])):
        assert (p["n_nodes"], p["n_edges"]) == (j["n_nodes"], j["n_edges"]), n
        for k in ("cost_loop_before", "cost_loop_after"):
            assert abs(p[k] - j[k]) <= COST_RTOL * abs(j[k]) + COST_ROUND, (n, k, p[k], j[k])
    assert [(x["i"], x["j"]) for x in pl["loops"]] == [(x["i"], x["j"]) for x in jl["loops"]]
    for name in ("svin_loop.txt", "svin_robust.txt", "svin_vio.txt"):
        a = np.loadtxt(pdir / name, ndmin=2)
        b = np.loadtxt(jdir / name, ndmin=2)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a[:, 0], b[:, 0], err_msg=name)
        np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], rtol=0, atol=TUM_TOL, err_msg=name)
    return js, jl


def switches(out_dir):
    lines = [x for x in (out_dir / "switch_info.txt").read_text().splitlines() if x.strip()]
    to_prim = [float(x.split()[0]) for x in lines if "VIO->PRIMITIVE" in x]
    to_vio = [float(x.split()[0]) for x in lines if "PRIMITIVE->VIO" in x]
    return to_prim, to_vio


def test_cli_parity_through_the_degraded_stretch(tmp_path, monkeypatch):
    jdir, pdir = run_both(tmp_path, QUICK, monkeypatch)
    js, jl = assert_same_run(jdir, pdir)
    # the case exercises the health gate: the JAX CLI switches inside the
    # stretch and back after it
    to_prim, to_vio = switches(jdir)
    assert to_prim and to_vio and 2.0 <= to_prim[0] <= 4.0 and to_vio[0] > to_prim[0]
    assert len(js) == 18 and jl["n_keyframes"] >= 5


@pytest.mark.slow
def test_cli_parity_over_the_gauntlet(tmp_path, monkeypatch):
    jdir, pdir = run_both(tmp_path, FULL, monkeypatch)
    js, jl = assert_same_run(jdir, pdir)
    to_prim, to_vio = switches(jdir)
    assert to_prim and to_vio and 30.0 <= to_prim[0] <= 34.0 and to_vio[0] > to_prim[0]
    assert len(js) >= 180 and jl["n_loops"] > 0
