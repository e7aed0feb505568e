"""The port's triangulation and RANSAC against the JAX package's, in float64
on the CPU.

RANSAC hypotheses: the JAX functions draw their samples inside from a PRNG
key (``jax.random.split`` + ``jax.random.choice`` with probabilities ∝
valid + 1e-9). The tests rebuild exactly those draws from the same key and
feed them to the port as ``hyp_idx``.

Tolerances: triangulated points, flags and parallel flags to 1e-10
relative; the two-view covariance to 1e-8 of its largest entry (adjugate
inverse against LU inverse of a matrix whose condition number is ~1e4).
RANSAC: identical inlier masks, counts and success flags, and the fitted
pose to 1e-9 (the final pose and inliers follow from the best hypothesis,
so they agree only if it is the same one; the Jacobians are analytic here
and by ``jacfwd`` there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu.frontend import ransac as jr
from svin_tpu.frontend import triangulation as jt
from svin_tpu.kinematics import Transformation as JT
from svin_tpu.kinematics import oplus as joplus
from svin_tpu.kinematics import quaternion as jquat
from svin_tpu_torch.frontend import ransac as tr
from svin_tpu_torch.frontend import triangulation as tt
from svin_tpu_torch.kinematics import Transformation as TT
from torch_parity import assert_close, jax_draws

torch.set_num_threads(1)


def t64(a):
    return torch.as_tensor(np.array(a, np.float64))


def _rays(rng, n):
    p1 = rng.normal(size=(n, 3)) * 0.1
    p2 = p1 + np.array([0.2, 0.0, 0.0]) + rng.normal(size=(n, 3)) * 0.05
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 5.0])
    e1 = X - p1 + rng.normal(size=(n, 3)) * 1e-3
    e2 = X - p2 + rng.normal(size=(n, 3)) * 1e-3
    e2[:4] = e1[:4]  # parallel rays
    e2[4:8] = -e1[4:8]  # diverging
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    sigma = np.full(n, 2e-3)
    return p1, e1, p2, e2, sigma


def test_triangulation_matches_jax():
    rng = np.random.default_rng(0)
    args = _rays(rng, 64)
    want = jt.triangulate_fast(*(jnp.asarray(a) for a in args))
    got = tt.triangulate_fast(*(t64(a) for a in args))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.parallel.numpy(), np.asarray(want.parallel))
    assert got.parallel[:4].all() and not got.valid[4:8].any()
    assert_close(got.hp, want.hp, rtol=1e-10)
    pts = tt.point_from_homogeneous(got.hp)
    assert_close(pts, jt.point_from_homogeneous(want.hp), rtol=1e-10)
    ok = got.valid & ~got.parallel
    c1, c2 = args[0], args[2]
    pose_var = np.full(64, 1e-2)
    sa, sb = args[4], args[4] * 2.0
    want_cov = jt.triangulation_covariance(*(jnp.asarray(np.asarray(a)[ok.numpy()]) for a in (
        pts.numpy(), c1, c2, sa, sb, pose_var)))
    got_cov = tt.triangulation_covariance(*(t64(np.asarray(a)[ok.numpy()]) for a in (
        pts.numpy(), c1, c2, sa, sb, pose_var)))
    assert_close(got_cov, want_cov, rtol=0.0, atol_rel=1e-8)


def _abs_pose_case(seed, n=60, n_out=18):
    rng = np.random.default_rng(seed)
    p_W = rng.uniform(-3, 3, (n, 3)) + np.array([0, 0, 6.0])
    T_true = JT(r=jnp.asarray([0.3, -0.2, 0.5]), q=jquat.exp(jnp.asarray([0.05, 0.1, -0.08])))
    p_C = np.asarray(jquat.rotate(jquat.conjugate(T_true.q), jnp.asarray(p_W) - T_true.r))
    b = p_C / np.linalg.norm(p_C, axis=1, keepdims=True)
    rnd = rng.normal(size=(n_out, 3))
    b[:n_out] = rnd / np.linalg.norm(rnd, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    valid[-5:] = False
    prior = joplus(T_true, jnp.asarray([0.1, -0.1, 0.08, 0.05, -0.04, 0.06]))
    return p_W, b, valid, prior, T_true


@pytest.mark.parametrize("seed", [0, 1])
def test_absolute_pose_ransac_matches_jax(seed):
    p_W, b, valid, prior, T_true = _abs_pose_case(seed)
    key = jax.random.PRNGKey(seed + 10)
    min_inl = max(8, int(valid.sum()) // 3)
    want = jr.absolute_pose_ransac(key, jnp.asarray(p_W), jnp.asarray(b), jnp.asarray(valid), prior,
                                   focal_px=160.0, threshold_px=4.0, num_hypotheses=50,
                                   min_inliers=min_inl)
    hyp = jax_draws(key, valid, 50, 3)
    got = tr.absolute_pose_ransac(hyp, t64(p_W), t64(b), torch.as_tensor(valid),
                                  TT(r=t64(prior.r), q=t64(prior.q)), focal_px=160.0,
                                  threshold_px=4.0, min_inliers=min_inl)
    assert bool(got.success) and bool(want.success)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers)
    assert_close(got.T.r, want.T.r, rtol=0, atol=1e-9)
    assert_close(got.T.q, want.T.q, rtol=0, atol=1e-9)
    assert float(np.linalg.norm(got.T.r.numpy() - np.asarray(T_true.r))) < 0.02


def test_absolute_pose_ransac_degenerate_returns_prior():
    N = 20
    prior = TT(r=torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64),
               q=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64))
    valid = torch.zeros(N, dtype=torch.bool)
    hyp = tr.draw_hypotheses(valid, 8, 3, torch.Generator().manual_seed(4))
    res = tr.absolute_pose_ransac(hyp, torch.zeros(N, 3, dtype=torch.float64),
                                  torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64).repeat(N, 1),
                                  valid, prior)
    assert not bool(res.success)
    assert torch.equal(res.T.r, prior.r)


def test_rotation_only_ransac_matches_jax():
    rng = np.random.default_rng(5)
    N = 40
    dirs = rng.normal(size=(N, 3))
    b_b = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    q_ab = jquat.exp(jnp.asarray([0.1, -0.2, 0.3]))
    b_a = np.array(jquat.rotate(q_ab, jnp.asarray(b_b)))
    out = rng.normal(size=(8, 3))
    b_a[:8] = out / np.linalg.norm(out, axis=1, keepdims=True)
    valid = np.ones(N, bool)
    valid[10:13] = False
    key = jax.random.PRNGKey(3)
    want = jr.rotation_only_ransac(key, jnp.asarray(b_a), jnp.asarray(b_b), jnp.asarray(valid),
                                   focal_px=160.0, num_hypotheses=32)
    got = tr.rotation_only_ransac(jax_draws(key, valid, 32, 2), t64(b_a), t64(b_b),
                                  torch.as_tensor(valid), focal_px=160.0)
    assert bool(got.success) == bool(want.success) is True
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    q, jq = got.T.q.numpy(), np.asarray(want.T.q)
    assert_close(q * np.sign(q[3]), jq * np.sign(jq[3]), rtol=0, atol=1e-9)


def _rel_case(seed):
    rng = np.random.RandomState(seed)
    N = 120
    p_A = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(2, 8, (N, 1))], axis=1)
    q_true = np.asarray(jquat.exp(jnp.asarray([0.06, -0.11, 0.18])))
    t_true = np.array([0.4, 0.15, -0.1])
    R_AB = np.asarray(jquat.to_rotation_matrix(jnp.asarray(q_true)))
    p_B = (p_A - t_true) @ R_AB
    bA = p_A / np.linalg.norm(p_A, axis=1, keepdims=True)
    bB = p_B / np.linalg.norm(p_B, axis=1, keepdims=True)
    n_out = N * 3 // 10
    out_idx = rng.choice(N, n_out, replace=False)
    bB[out_idx] = rng.randn(n_out, 3)
    bB[out_idx] /= np.linalg.norm(bB[out_idx], axis=1, keepdims=True)
    q_prior = np.asarray(jquat.normalize(jquat.multiply(
        jquat.exp(jnp.asarray([0.03, 0.02, -0.04])), jnp.asarray(q_true))))
    valid = np.ones(N, bool)
    valid[::17] = False
    return bA, bB, valid, t_true + [0.1, -0.05, 0.1], q_prior


@pytest.mark.parametrize("seed", [0, 1])
def test_relative_pose_ransac_matches_jax(seed):
    bA, bB, valid, t_prior, q_prior = _rel_case(seed)
    key = jax.random.PRNGKey(seed + 1)
    want = jr.relative_pose_ransac(key, jnp.asarray(bA), jnp.asarray(bB), jnp.asarray(valid),
                                   JT(r=jnp.asarray(t_prior), q=jnp.asarray(q_prior)),
                                   threshold_px=2.0, focal_px=450.0, num_hypotheses=32,
                                   min_inliers=30)
    got = tr.relative_pose_ransac(jax_draws(key, valid, 32, 5), t64(bA), t64(bB),
                                  torch.as_tensor(valid), TT(r=t64(t_prior), q=t64(q_prior)),
                                  threshold_px=2.0, focal_px=450.0, min_inliers=30)
    assert bool(got.success) and bool(want.success)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert_close(got.T.r, want.T.r, rtol=0, atol=1e-9)
    assert_close(got.T.q, want.T.q, rtol=0, atol=1e-9)


def test_draw_hypotheses_uniform_over_valid():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 11, 20, 21, 40]] = True
    g = torch.Generator().manual_seed(0)
    idx = tr.draw_hypotheses(valid, 2000, 3, g)
    assert idx.shape == (2000, 3) and idx.dtype == torch.int64
    assert bool(valid[idx].all())  # never an invalid index with >= s valid
    assert all(len(set(row)) == 3 for row in idx.tolist())  # without replacement
    counts = torch.bincount(idx.reshape(-1), minlength=50)[valid].double()
    assert float((counts / counts.mean() - 1).abs().max()) < 0.1  # ~uniform
    few = torch.zeros(50, dtype=torch.bool)
    few[[5, 9]] = True
    idx = tr.draw_hypotheses(few, 100, 3, g)
    assert bool((few[idx].sum(dim=1) == 2).all())  # every valid entry first
