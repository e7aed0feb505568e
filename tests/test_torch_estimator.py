"""Parity of the port's estimator with the JAX package: factors, assemble,
the Schur solve step, the LM loop and FEJ marginalization, on one small
synthetic window (S=4 states, L=64 landmark slots, O=512 observation slots,
2 cameras) with depth, sonar and landmark-prior factors, in float64.

Tolerances, with their reason: the port sums segments with ``index_add_``
where the JAX package uses one-hot matmuls, and assembles blocks in another
order, so sums differ in rounding only — factor evaluations agree to 1e-10
relative and the normal equations (entries spanning ~1e-2..1e14) to 1e-9
relative plus 1e-12 of the largest entry. The LM loop amplifies rounding
through up to six solves: states, costs and covariances agree to 1e-7
relative, and the accepted-iteration counts exactly. The marginal prior
goes through two eigendecompositions of ill-conditioned matrices whose
rounding the two LAPACK paths resolve differently: its entries agree to
1e-6 of sqrt(H_ii·H_jj), the scale its eigenvalue clipping works at.

The problem comes from the port's builder and reaches the JAX package
through ``torch_parity.to_jax`` (the slice test uses the JAX builder).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu.estimator import WindowConfig as JaxWindowConfig
from svin_tpu.estimator import factors as jfac
from svin_tpu.estimator import gauss_newton as jgn
from svin_tpu.estimator import marginalization as jmarg
from svin_tpu.problems import IMU_PARAMS as JIMU
from svin_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from svin_tpu_torch.estimator import WindowState
from svin_tpu_torch.estimator import factors as tfac
from svin_tpu_torch.estimator import gauss_newton as tgn
from svin_tpu_torch.estimator import marginalization as tmarg
from svin_tpu_torch.problems import IMU_PARAMS as TIMU
from torch_parity import assert_close, assert_prior_close, assert_tree_close, port_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def prob():
    jcfg, tcfg, (jw, jf, jrig), (tw, tf, trig) = port_problem()
    return dict(jcfg=jcfg, tcfg=tcfg, jw=jw, jf=jf, jrig=jrig, tw=tw, tf=tf, trig=trig)


@pytest.fixture(scope="module")
def marg_case(prob):
    """One marginalization of slot 1 by both packages, from which the
    marginal-prior paths (assemble, total cost) are checked too."""
    p = prob
    jfn = jax.jit(lambda w, f, s: jmarg.marginalize_slot(w, f, s, p["jrig"], JIMU, p["jcfg"]))
    jw2, jf2 = jfn(p["jw"], p["jf"], jnp.int32(1))
    tw2, tf2 = tmarg.marginalize_slot(p["tw"], p["tf"], 1, p["trig"], TIMU, p["tcfg"])
    return jw2, jf2, tw2, tf2


FACTOR_EVALS = {
    "reprojection": lambda m, p, w, f, rig, cfg: m.eval_reprojection(w, f, rig, cfg),
    "imu": lambda m, p, w, f, rig, cfg: m.eval_imu(w, f, p),
    "depth": lambda m, p, w, f, rig, cfg: m.eval_depth(w, f),
    "sonar": lambda m, p, w, f, rig, cfg: m.eval_sonar(w, f),
    "priors": lambda m, p, w, f, rig, cfg: m.eval_priors(w, f),
    "lm_prior": lambda m, p, w, f, rig, cfg: m.eval_lm_prior(w, f),
    "ext_prior": lambda m, p, w, f, rig, cfg: m.eval_ext_prior(w, f),
    "marg_delta": lambda m, p, w, f, rig, cfg: m.marg_delta(w, f),
}


@pytest.mark.parametrize("name", sorted(FACTOR_EVALS))
def test_factor_eval_matches_jax(prob, name):
    p = prob
    fn = FACTOR_EVALS[name]
    want = jax.jit(lambda w, f: fn(jfac, JIMU, w, f, p["jrig"], p["jcfg"]))(p["jw"], p["jf"])
    got = fn(tfac, TIMU, p["tw"], p["tf"], p["trig"], p["tcfg"])
    if name in ("depth", "sonar"):
        assert bool(got.valid.any())  # the factor is live in this problem
    assert_tree_close(got, want, rtol=1e-10, atol_rel=1e-12, name=name)


@pytest.mark.parametrize("with_marg_prior", [False, True])
def test_assemble_and_total_cost_match_jax(prob, marg_case, with_marg_prior):
    p = prob
    if with_marg_prior:
        jw, jf, tw, tf = marg_case
    else:
        jw, jf, tw, tf = p["jw"], p["jf"], p["tw"], p["tf"]
    want, want_cost = jax.jit(lambda w, f: (
        jgn.assemble(w, f, p["jrig"], JIMU, p["jcfg"]),
        jgn.total_cost(w, f, p["jrig"], JIMU, p["jcfg"])))(jw, jf)
    got = tgn.assemble(tw, tf, p["trig"], TIMU, p["tcfg"])
    assert_tree_close(got, want, rtol=1e-9, atol_rel=1e-12, name="eqs")
    assert_close(tgn.total_cost(tw, tf, p["trig"], TIMU, p["tcfg"]), want_cost, rtol=1e-10)


def test_assemble_with_extrinsics_matches_jax():
    jcfg, tcfg, (jw, jf, jrig), (tw, tf, trig) = port_problem(estimate_extrinsics=True)
    want = jax.jit(lambda w, f: jgn.assemble(w, f, jrig, JIMU, jcfg))(jw, jf)
    got = tgn.assemble(tw, tf, trig, TIMU, tcfg)
    assert got.H.shape == (tcfg.full_dim, tcfg.full_dim)
    assert_tree_close(got, want, rtol=1e-9, atol_rel=1e-12, name="eqs")


def test_solve_step_and_apply_step_match_jax(prob):
    p = prob
    teqs = tgn.assemble(p["tw"], p["tf"], p["trig"], TIMU, p["tcfg"])
    lam = 1e-3
    jdx, jdl = jax.jit(lambda w, f: jgn._solve_step(
        jgn.assemble(w, f, p["jrig"], JIMU, p["jcfg"]), w, jnp.asarray(lam), p["jcfg"]))(p["jw"], p["jf"])
    tdx, tdl = tgn._solve_step(teqs, p["tw"], torch.tensor(lam, dtype=torch.float64), p["tcfg"])
    assert_close(tdx, jdx, rtol=1e-7, atol_rel=1e-9, name="dx")
    assert_close(tdl, jdl, rtol=1e-7, atol_rel=1e-9, name="dl")
    assert_tree_close(tgn.apply_step(p["tw"], tdx, tdl), jgn.apply_step(p["jw"], jdx, jdl),
                      rtol=1e-9, atol_rel=1e-9, name="window")


@pytest.fixture(scope="module")
def jax_optimize(prob):
    p = prob
    return jax.jit(lambda w, f, n: jgn.optimize(w, f, p["jrig"], JIMU, p["jcfg"], n_iters=n))


@pytest.mark.parametrize("n_iters", [6, 2])
def test_optimize_matches_jax(prob, jax_optimize, n_iters):
    p = prob
    want = jax_optimize(p["jw"], p["jf"], jnp.int32(n_iters))
    got = tgn.optimize(p["tw"], p["tf"], p["trig"], TIMU, p["tcfg"], n_iters=n_iters)
    assert int(got.iterations) == int(want.iterations) > 0
    assert float(got.cost) < float(got.cost0)
    assert_tree_close(got, want, rtol=1e-7, atol_rel=1e-9, name="result")


def test_optimize_freezes_past_budget(prob):
    """Iterations at or past n_iters leave the state bit-identical: a loop
    of 5 with a budget of 2 equals a loop of 2."""
    p = prob
    short = tgn.optimize(p["tw"], p["tf"], p["trig"], TIMU, p["tcfg"]._replace(max_iterations=2))
    long = tgn.optimize(p["tw"], p["tf"], p["trig"], TIMU, p["tcfg"]._replace(max_iterations=5),
                        n_iters=torch.tensor(2, dtype=torch.int32))
    for a, b in zip(jax.tree_util.tree_leaves(tuple(short)), jax.tree_util.tree_leaves(tuple(long))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("part", ["window", "factors"])
def test_marginalize_slot_matches_jax(marg_case, part):
    jw2, jf2, tw2, tf2 = marg_case
    if part == "window":
        assert_tree_close(tw2, jw2, rtol=1e-12, atol_rel=1e-12, name="window")
        return
    assert bool(tf2.marg.valid)
    assert_tree_close(tf2._replace(marg=None), jf2._replace(marg=None),
                      rtol=1e-12, atol_rel=1e-12, name="factors")
    assert_prior_close(tf2.marg, jf2.marg, rtol=1e-6)


def test_marginalize_with_extrinsics_matches_jax():
    jcfg, tcfg, (jw, jf, jrig), (tw, tf, trig) = port_problem(
        S=3, L=32, O=256, n_landmarks=24, estimate_extrinsics=True, seed=1)
    jw2, jf2 = jax.jit(lambda w, f: jmarg.marginalize_slot(w, f, jnp.int32(0), jrig, JIMU, jcfg))(jw, jf)
    tw2, tf2 = tmarg.marginalize_slot(tw, tf, 0, trig, TIMU, tcfg)
    assert_tree_close(tw2, jw2, rtol=1e-12, atol_rel=1e-12, name="window")
    assert_tree_close(tf2.priors, jf2.priors, rtol=1e-12, name="priors")  # gauge re-fixed
    assert_prior_close(tf2.marg, jf2.marg, rtol=1e-6)


def test_convert_round_trip(prob):
    """JAX trees → the port's NamedTuples and back: exact, with uint32
    descriptor words as their int32 view and JAX-only fields dropped."""
    p = prob
    tw = from_numpy_tree(p["jw"])
    assert isinstance(tw, WindowState) and tw.r.dtype == torch.float64
    assert tw.lm_id.dtype == torch.int32 and tw.lm_valid.dtype == torch.bool
    back = to_numpy_tree(tw)
    for field, a, b in zip(tw._fields, back, p["jw"]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)
    f32 = from_numpy_tree(p["jf"], dtype=torch.float32)
    assert f32.imu.pre.P_delta.dtype == torch.float32 and f32.reproj.lm_idx.dtype == torch.int32
    words = np.array([[0xFFFFFFFF, 1]], np.uint32)
    t = from_numpy_tree(words)
    assert t.dtype == torch.int32 and t[0, 0] == -1 and t[0, 1] == 1
    cfg = from_numpy_tree(JaxWindowConfig(num_states=3, unroll=True))
    assert cfg == p["tcfg"]._replace(num_states=3, num_landmarks=256, num_obs=2048,
                                     max_iterations=10)
