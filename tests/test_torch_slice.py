"""The port's per-frame backend slice against the JAX package's engine
programs, end to end.

The problem is built by the JAX package's ``build_window_problem`` (S=4
states, L=64 landmark slots, O=512 observation slots, two 752x480 cameras)
with depth, sonar and landmark-prior factors, converted with
``from_numpy_tree``. The frame: the newest state's projections of the
landmarks with pixel noise and descriptors a few bits off the landmark's,
padded with random distractors.

- ``gate_match_all`` vs the JAX engine's ``VioEngine._gate_match_all``.
- ``opt_program`` vs the engine program's composition: JAX ``optimize`` →
  ``marginalize_slot`` → reprojection error.
- ``BackendStep`` vs both in sequence.

Tolerances: match flags and indices, accepted-iteration counts and pruning
flags are exact; bearings agree to 1e-12; LM outputs (through up to six
solves) to 1e-7 relative; the marginal prior to 1e-6 of sqrt(H_ii·H_jj)
(see test_torch_estimator.py for why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu.estimator import factors as jfac
from svin_tpu.estimator import gauss_newton as jgn
from svin_tpu.estimator import marginalization as jmarg
from svin_tpu.pipeline.config import VioConfig
from svin_tpu.pipeline.vio import VioEngine
from svin_tpu.problems import IMU_PARAMS as JIMU
from svin_tpu.problems import euroc_like_rig as jax_rig
from svin_tpu_torch import problems as tproblems
from svin_tpu_torch.convert import from_numpy_tree, tree_to
from svin_tpu_torch.estimator import WindowConfig
from svin_tpu_torch.pipeline import BackendStep, gate_match_all, opt_program
from svin_tpu_torch.problems import IMU_PARAMS as TIMU
from torch_parity import assert_close, assert_prior_close, assert_tree_close, jax_problem, port

torch.set_num_threads(1)

N_ITERS = 6
VICTIM = 1


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg, jw, jf, jrig, truth = jax_problem(max_iterations=N_ITERS)
    tw, tf, trig = port(jw), port(jf), port(jrig)
    rng = np.random.default_rng(0)
    lm_desc = tproblems.random_descriptors(rng, tcfg.num_landmarks)
    ttruth = {k: from_numpy_tree(np.asarray(v)) for k, v in truth.items() if k != "rig"}
    frame, tidx = tproblems.make_frame(rng, tw, ttruth, trig, lm_desc, slot=tcfg.num_states - 1, K=60)
    return dict(jcfg=jcfg, tcfg=tcfg, jw=jw, jf=jf, jrig=jrig, tw=tw, tf=tf, trig=trig,
                frame=frame, tidx=tidx)


def _jax_gate_args(c):
    fr, w = c["frame"], c["jw"]
    u32 = lambda t: jnp.asarray(t.numpy().view(np.uint32))  # noqa: E731
    f64 = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return (f64(fr.uv), u32(fr.desc), jnp.asarray(fr.valid.numpy()), w.hp_W, w.lm_valid,
            u32(fr.lm_desc), f64(fr.lm_cov), f64(fr.T_WS_r), f64(fr.T_WS_q), w.ext_r, w.ext_q,
            f64(fr.sigma), f64(fr.pos_var))


@pytest.fixture(scope="module")
def jax_gate(case):
    engine = VioEngine(VioConfig(), rig=jax_rig())
    return jax.device_get(engine._gate_match_all(*_jax_gate_args(case)))


def _jax_opt(c, with_marg):
    rig, cfg = c["jrig"], c["jcfg"]

    def err(w, f):
        ev = jfac.eval_reprojection(w, f, rig, cfg)
        return ev.valid, jnp.linalg.norm(ev.res, axis=-1) / jnp.sqrt(jnp.maximum(ev.weight, 1e-9))

    def prog(w, f, n_it, victim):
        res = jgn.optimize(w, f, rig, JIMU, cfg, n_iters=n_it)
        if not with_marg:
            return (res.window, res.cost, res.iterations, res.lm_cov, *err(res.window, f))
        w2, f2 = jmarg.marginalize_slot(res.window, f, victim, rig, JIMU, cfg)
        return (w2, f2, res.cost, res.iterations, res.lm_cov, *err(w2, f2))

    return jax.device_get(jax.jit(prog)(c["jw"], c["jf"], jnp.int32(N_ITERS), jnp.int32(VICTIM)))


@pytest.fixture(scope="module")
def jax_opt_marg(case):
    return _jax_opt(case, with_marg=True)


def _check_gate(got, want, tidx):
    valid, idx, rays = got
    np.testing.assert_array_equal(valid.numpy(), want[0])
    np.testing.assert_array_equal(idx.numpy(), want[1])
    assert_close(rays, want[2], rtol=1e-12)
    ok = valid.numpy()
    assert ok.sum() >= 0.9 * (tidx >= 0).sum()  # most true associations found
    np.testing.assert_array_equal(idx.numpy()[ok], tidx[ok])  # and none wrong


def test_gate_match_all_matches_jax_engine(case, jax_gate):
    c, fr = case, case["frame"]
    got = gate_match_all(c["trig"], fr.uv, fr.desc, fr.valid, c["tw"].hp_W, c["tw"].lm_valid,
                         fr.lm_desc, fr.lm_cov, fr.T_WS_r, fr.T_WS_q, c["tw"].ext_r,
                         c["tw"].ext_q, fr.sigma, fr.pos_var)
    _check_gate(got, jax_gate, c["tidx"])


def _check_opt(got, want, with_marg):
    if with_marg:
        w2, f2, cost, iters, lm_cov, pv, pe = got
        jw2, jf2, jcost, jiters, jlm_cov, jpv, jpe = want
        assert_tree_close(f2._replace(marg=None), jf2._replace(marg=None), rtol=1e-7,
                          atol_rel=1e-9, name="factors")
        assert_prior_close(f2.marg, jf2.marg, rtol=1e-6)
    else:
        w2, cost, iters, lm_cov, pv, pe = got
        jw2, jcost, jiters, jlm_cov, jpv, jpe = want
    assert int(iters) == int(jiters) > 0
    assert_tree_close(w2, jw2, rtol=1e-7, atol_rel=1e-9, name="window")
    assert_close(cost, jcost, rtol=1e-7)
    assert_close(lm_cov, jlm_cov, rtol=1e-7, atol_rel=1e-9)
    np.testing.assert_array_equal(pv.numpy(), jpv)
    assert_close(pe, jpe, rtol=1e-7, atol_rel=1e-9)


@pytest.mark.parametrize("with_marg", [True, False])
def test_opt_program_matches_jax_composition(case, jax_opt_marg, with_marg):
    c = case
    prog = opt_program(c["trig"], TIMU, c["tcfg"], with_marg)
    if with_marg:
        got, want = prog(c["tw"], c["tf"], N_ITERS, VICTIM), jax_opt_marg
    else:
        got, want = prog(c["tw"], c["tf"], N_ITERS), _jax_opt(c, with_marg=False)
    _check_opt(got, want, with_marg)


def test_backend_step_matches_jax(case, jax_gate, jax_opt_marg):
    c = case
    step = BackendStep(c["trig"], TIMU, c["tcfg"])
    out = step(c["tw"], c["tf"], c["frame"], N_ITERS, VICTIM)
    _check_gate((out.match_valid, out.match_idx, out.rays), jax_gate, c["tidx"])
    _check_opt((out.window, out.factors, out.cost, out.iterations, out.lm_cov,
                out.prune_valid, out.prune_err), jax_opt_marg, with_marg=True)
    assert float(out.cost) < float(out.cost0)


def _port_case(dtype):
    cfg = WindowConfig(num_states=5, num_landmarks=96, num_obs=768, max_iterations=5)
    rng = np.random.default_rng(3)
    w, f, rig, truth = tproblems.build_window_problem(rng, cfg, n_landmarks=80)
    f = tproblems.attach_depth_and_sonar(f, truth, w, [1, 3], rng)
    lm_desc = tproblems.random_descriptors(rng, cfg.num_landmarks)
    frame, tidx = tproblems.make_frame(rng, w, truth, rig, lm_desc, slot=cfg.num_states - 1, K=120)
    conv = lambda t: tree_to(t, dtype=dtype)  # noqa: E731
    return cfg, conv(w), conv(f), conv(rig), conv(frame), tidx


def test_backend_step_float32_tracks_float64():
    """The step in float32 (the card's working type) on the port-built
    problem: the same matches as float64, the cost reduced, the states
    within a millimetre, and the marginal prior finite."""
    outs = {}
    for dtype in (torch.float64, torch.float32):
        cfg, w, f, rig, frame, tidx = _port_case(dtype)
        step = BackendStep(rig, TIMU, cfg).to(dtype)
        outs[dtype] = step(w, f, frame, cfg.max_iterations, 0)
    o64, o32 = outs[torch.float64], outs[torch.float32]
    assert torch.equal(o32.match_idx, o64.match_idx)
    assert (o32.match_idx.numpy()[o32.match_valid.numpy()] == tidx[o32.match_valid.numpy()]).all()
    assert float(o32.cost) < 0.01 * float(o32.cost0)
    assert abs(float(o32.cost) - float(o64.cost)) <= 1e-2 * float(o64.cost)
    assert float((o32.window.r - o64.window.r.float()).abs().max()) < 1e-3
    assert bool(torch.isfinite(o32.factors.marg.H).all())
