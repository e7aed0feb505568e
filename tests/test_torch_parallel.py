"""The port's scalable solvers (``svin_tpu_torch.parallel``) against the JAX
package's, in float64 on the CPU.

Inputs: the JAX tests' drifted 40-node pose graph (``_make_drifted_graph``)
and its SE(3) form, the 4,096-node drifted circles of ``tests/test_pcg.py``
(numpy-seeded), and the JAX tests' global BA problems (``test_dist_ba``'s
``build_global_problem``), each converted to the port.

Tolerances, each port result against the JAX function's on the same input:
pose graphs, positions and yaw within 1e-6 m / rad and 6-DoF quaternions
with |dot| within 1e-8 of 1; BA poses within 1e-7 m and costs within rtol
1e-8; ``band_posegraph``'s fields equal. The JAX tests' own bounds (against
the dense solves, the truth, the loop residuals) are applied to the port's
results as they are.

Where a pose-graph solve stops its CG far from convergence (the closer's
budgets: 64-96 CG iterations on chains of hundreds of nodes), its result is
chaotic in the last bits of its input: the JAX solver itself moves by 1e-4
to 4e-4 m on these graphs when the node positions are scaled by 1 ± 1e-15
(a few ulps), and the two packages' summation orders differ by as much.
Those cases hold the port's first GN step at 20 CG iterations, before
rounding grows, within 1e-9 of the JAX step; the whole solve within 1e-6 of
the JAX solve at a CG budget where CG converges (CONVERGED_GN_CG); and the
port's own result at the mirrored test's budget to that test's bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svin_tpu.parallel as jpar
from svin_tpu.kinematics import npq
from svin_tpu.loopclosure import posegraph as jpg
from svin_tpu.loopclosure.posegraph import ypr_to_matrix_np
from svin_tpu.parallel import pcg as jpcg
from svin_tpu.parallel import pg_band as jband
from svin_tpu_torch import parallel as tpar
from svin_tpu_torch import problems as tproblems
from svin_tpu_torch.convert import (from_numpy_tree, parallel_from_numpy, posegraph_from_numpy,
                                    to_numpy_tree)
from svin_tpu_torch.loopclosure import posegraph as tpg
from svin_tpu_torch.parallel import pcg as tpcg
from svin_tpu_torch.parallel import pg_band as tband
from test_dist_ba import build_global_problem
from test_loopclosure import _make_drifted_graph

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _rot(yaw):
    return ypr_to_matrix_np(yaw, 0.0, 0.0)


def _close_4dof(got, want, n=None, tol=1e-6):
    n = want.p.shape[0] if n is None else n
    np.testing.assert_allclose(got.p[:n].numpy(), np.asarray(want.p)[:n], rtol=0, atol=tol)
    np.testing.assert_allclose(got.yaw[:n].numpy(), np.asarray(want.yaw)[:n], rtol=0, atol=tol)


# GN and CG iterations at which the pose-graph PCG converges on the drifted
# circles of 600-640 nodes: the port and the JAX solve then agree to ~1e-7
# (banded, 600) and ~1e-12 (PCG, 640); at 1,000 CG they still part by up
# to 5e-5
CONVERGED_GN_CG = (2, 2500)


def _jnodes(nodes, scale):
    return jax.tree_util.tree_map(jnp.asarray, nodes._replace(p=np.asarray(nodes.p) * scale))


def _close_6dof(got, want):
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), rtol=0, atol=1e-6)
    dots = np.abs(np.sum(got.q.numpy() * np.asarray(want.q), axis=1))
    np.testing.assert_allclose(dots, 1.0, rtol=0, atol=1e-8)


# ------------------------------------------------------------ pose graphs
def test_pcg_posegraph_matches_dense():
    """test_pcg.py:200 on the port: PCG with CG past the dimension lands on
    the dense solve; and on the JAX PCG."""
    nodes, edges, *_ = _make_drifted_graph()
    tn, te = posegraph_from_numpy(nodes), posegraph_from_numpy(edges)
    cap = nodes.p.shape[0]
    want = jpar.optimize_4dof_pcg(nodes, edges, jnp.int32(1), iters=10, cg_iters=cap * 4 + 8)
    got = tpar.optimize_4dof_pcg(tn, te, 1, iters=10, cg_iters=cap * 4 + 8)
    _close_4dof(got, want)
    dense = tpg.optimize_4dof(tn, te, 1, iters=10)
    va = nodes.valid
    np.testing.assert_allclose(got.p.numpy()[va], dense.p.numpy()[va], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.yaw.numpy()[va], dense.yaw.numpy()[va], rtol=0, atol=1e-6)


def _circle_4dof(N, seed=7):
    """test_pcg.py:240's graph: a circle of radius 20 m lapped twice, exact
    odometry edges, a yaw-drifted initial guess, loop edges (weight 5) from
    the second lap to the first every 64 nodes."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 4 * np.pi, N)
    t_gt = np.stack([20.0 * np.cos(th), 20.0 * np.sin(th), 0.1 * np.sin(3 * th)], 1)
    yaw_gt = th + np.pi / 2
    yaw_init = yaw_gt + np.cumsum(rng.normal(0, 2e-3, N))
    p_init = np.zeros((N, 3))
    p_init[0] = t_gt[0]
    for k in range(1, N):
        d_local = _rot(yaw_gt[k - 1]).T @ (t_gt[k] - t_gt[k - 1])
        p_init[k] = p_init[k - 1] + _rot(yaw_init[k - 1]) @ d_local
    pairs = [(k - 1, k, 1.0, False) for k in range(1, N)]
    pairs += [(k - N // 2, k, 5.0, True) for k in range(N // 2 + 8, N, 64)]
    i, j, w, il = (np.array(x) for x in zip(*pairs))
    t_ij = np.stack([_rot(yaw_gt[a]).T @ (t_gt[b] - t_gt[a]) for a, b in zip(i, j)])
    nodes = jpg.PoseGraphNodes(p=p_init, yaw=yaw_init, pitch=np.zeros(N), roll=np.zeros(N),
                               valid=np.ones(N, bool))
    edges = jpg.PoseGraphEdges(i=i.astype(np.int32), j=j.astype(np.int32), t_ij=t_ij,
                               yaw_ij=yaw_gt[j] - yaw_gt[i], weight=w.astype(float), is_loop=il,
                               valid=np.ones(len(i), bool))
    return nodes, edges


def _loop_residuals_4dof(p, yaw, edges):
    il = edges.is_loop
    return np.array([np.linalg.norm(_rot(yaw[a]).T @ (p[b] - p[a]) - t)
                     for a, b, t in zip(edges.i[il], edges.j[il], edges.t_ij[il])])


@pytest.mark.parametrize("N", [640, pytest.param(4096, marks=pytest.mark.slow)])
def test_pcg_posegraph_large_graph(N):
    """test_pcg.py:240 (4,096 nodes under -m slow; 640 runs the same code):
    6 GN x 96 CG pull every loop residual under 0.01, as the JAX PCG's; the
    first GN step and the converged solve match the JAX PCG."""
    nodes, edges = _circle_4dof(N)
    assert _loop_residuals_4dof(nodes.p, nodes.yaw, edges).max() > 1.0
    tn, te, je = posegraph_from_numpy(nodes), posegraph_from_numpy(edges), _np(edges)
    dx_j, _ = jpcg._pg4_gn_step_pcg(_jnodes(nodes, 1.0), jax.tree_util.tree_map(jnp.asarray, je),
                                    jnp.int32(1), N, 20, 16)
    dx_t, _ = tpcg._pg4_gn_step_pcg(tn, te, 1, N, 20, 16)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), rtol=0, atol=1e-9)
    gn, cg = CONVERGED_GN_CG
    want = jpar.optimize_4dof_pcg(_jnodes(nodes, 1.0), je, jnp.int32(1), iters=gn, cg_iters=cg)
    _close_4dof(tpar.optimize_4dof_pcg(tn, te, 1, iters=gn, cg_iters=cg), want)
    got = tpar.optimize_4dof_pcg(tn, te, 1, iters=6, cg_iters=96)
    assert _loop_residuals_4dof(got.p.numpy(), got.yaw.numpy(), edges).max() < 0.01


def test_band_posegraph_fields_match_jax():
    """``band_posegraph``'s split and padding, field by field (the JAX
    package's window starts ``lo`` and size ``S`` are TPU-only and not
    kept)."""
    nodes, edges = _circle_4dof(600)
    want, wmeta = jpar.band_posegraph(_np(nodes), _np(edges), block=256, wmax=4, coarse_group=32)
    got, meta = tpar.band_posegraph(posegraph_from_numpy(nodes), posegraph_from_numpy(edges),
                                    block=256, wmax=4, coarse_group=32)
    assert (meta.B, meta.N, meta.n_blocks, meta.Ec, meta.coarse_group) == (
        wmeta.B, wmeta.N, wmeta.n_blocks, wmeta.Ec, wmeta.coarse_group)
    got = to_numpy_tree(got)
    for f in got._fields:
        if f in ("nodes", "co"):
            for g in getattr(got, f)._fields:
                np.testing.assert_array_equal(getattr(getattr(got, f), g),
                                              np.asarray(getattr(getattr(want, f), g)), err_msg=g)
        else:
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)


def _banded_matches_jax(nodes, edges, prob, meta, iters, cg_iters, **kw):
    """The port's banded solve within 1e-6 of the JAX banded solve, both at
    ``iters`` GN x ``cg_iters`` CG (a converging budget); the costs, near
    the optimum (~1e-4), within 1e-9."""
    jprob, jmeta = jpar.band_posegraph(_jnodes(nodes, 1.0), edges, **kw)
    solve = jax.jit(jpar.optimize_4dof_banded, static_argnames=("meta", "iters", "cg_iters"))
    want, want_cost = solve(jprob, jmeta, jnp.int32(1), iters=iters, cg_iters=cg_iters)
    got, cost = tpar.optimize_4dof_banded(prob, meta, 1, iters=iters, cg_iters=cg_iters)
    _close_4dof(got, want, n=nodes.p.shape[0])
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=0, atol=1e-9)


def _banded_first_step(nodes, edges, prob, meta, **kw):
    """The first GN step at 20 CG iterations, port against JAX, within 1e-9."""
    jprob, jmeta = jpar.band_posegraph(_jnodes(nodes, 1.0), edges, **kw)
    dx_j, _ = jband._gn_step_banded(jprob, jmeta, jnp.int32(1), 20)
    dx_t, _ = tband._gn_step_banded(prob, meta, 1, 20)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), rtol=0, atol=1e-9)


def test_banded_posegraph_matches_pcg():
    """test_pcg.py:350 on the port: the banded solver (block 64, wmax 4,
    coarse group 32) against the JAX banded solver (the first GN step; the
    solve with CG past the dimension); at 8 GN x 64 CG against the port's
    PCG within the JAX test's 5e-4, the end node corrected."""
    nodes, edges, t_gt, yaw_gt, N = _make_drifted_graph()
    nodes, edges = _np(nodes), _np(edges)
    tn, te = posegraph_from_numpy(nodes), posegraph_from_numpy(edges)
    kw = dict(block=64, wmax=4, coarse_group=32)
    prob, meta = tpar.band_posegraph(tn, te, **kw)
    _banded_first_step(nodes, edges, prob, meta, **kw)
    cap = nodes.p.shape[0]
    _banded_matches_jax(nodes, edges, prob, meta, 8, cap * 4 + 8, **kw)
    got, cost = tpar.optimize_4dof_banded(prob, meta, 1, iters=8, cg_iters=64)
    pcg = tpar.optimize_4dof_pcg(tn, te, 1, iters=8, cg_iters=64, coarse_group=32)
    va = nodes.valid
    np.testing.assert_allclose(got.p.numpy()[:cap][va], pcg.p.numpy()[va], atol=5e-4)
    np.testing.assert_allclose(got.yaw.numpy()[:cap][va], pcg.yaw.numpy()[va], atol=5e-4)
    assert np.linalg.norm(got.p.numpy()[N - 1] - t_gt[N - 1]) < 0.15
    assert torch.isfinite(cost)


@pytest.mark.parametrize("N", [600, pytest.param(4096, marks=pytest.mark.slow)])
def test_banded_posegraph_large_graph(N):
    """The loop closer's settings (block 1024, wmax 4, coarse group 32) on
    the drifted circle: the JAX banded solver's first GN step and converged
    solve, and at 6 GN x 96 CG every loop residual under 0.01."""
    nodes, edges = _circle_4dof(N)
    kw = dict(block=1024, wmax=4, coarse_group=32)
    prob, meta = tpar.band_posegraph(posegraph_from_numpy(nodes), posegraph_from_numpy(edges),
                                     **kw)
    _banded_first_step(nodes, edges, prob, meta, **kw)
    _banded_matches_jax(nodes, edges, prob, meta, *CONVERGED_GN_CG, **kw)
    got, _ = tpar.optimize_4dof_banded(prob, meta, 1, iters=6, cg_iters=96)
    assert _loop_residuals_4dof(got.p.numpy()[:N], got.yaw.numpy()[:N], edges).max() < 0.01


def _graph6_from_4dof():
    """test_pcg.py's SE(3) form of the drifted graph (yaw-only rotations,
    the reference's sequential sqrt information)."""
    nodes, edges, t_gt, _, N = _make_drifted_graph()
    q = np.stack([npq.from_rotation_matrix(_rot(float(y))) for y in np.asarray(nodes.yaw)])
    q_ij = np.stack([npq.from_rotation_matrix(_rot(float(y))) for y in np.asarray(edges.yaw_ij)])
    E = edges.i.shape[0]
    W = np.broadcast_to(np.diag([20.0, 20.0, 20.0, 100.0, 100.0, 57.3]), (E, 6, 6)).copy()
    n6 = jpg.PoseGraph6Nodes(r=np.asarray(nodes.p), q=q, valid=np.asarray(nodes.valid))
    e6 = jpg.PoseGraph6Edges(i=np.asarray(edges.i), j=np.asarray(edges.j),
                             t_ij=np.asarray(edges.t_ij), q_ij=q_ij, sqrt_info=W,
                             valid=np.asarray(edges.valid))
    return n6, e6, t_gt, N


def test_pcg_posegraph_6dof_matches_dense():
    """test_pcg.py:419 on the port: 6 GN x 800 CG on the SE(3) graph land
    on the dense 6-DoF solve (within 1e-5, quaternions up to sign); and on
    the JAX PCG."""
    n6, e6, t_gt, N = _graph6_from_4dof()
    tn, te = posegraph_from_numpy(n6), posegraph_from_numpy(e6)
    want = jpar.optimize_6dof_pcg(n6, e6, jnp.int32(1), iters=6, cg_iters=800, coarse_group=16)
    got = tpar.optimize_6dof_pcg(tn, te, 1, iters=6, cg_iters=800, coarse_group=16)
    _close_6dof(got, want)
    dense = tpg.optimize_6dof(tn, te, 1, iters=6)
    va = n6.valid
    np.testing.assert_allclose(got.r.numpy()[va], dense.r.numpy()[va], atol=1e-5)
    dots = np.abs(np.sum(got.q.numpy()[va] * dense.q.numpy()[va], axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-8)
    assert np.linalg.norm(got.r.numpy()[N - 1] - t_gt[N - 1]) < 0.15


def _circle_6dof(N, seed=11):
    """test_pcg.py:449's graph: the circle with roll, pitch and yaw random
    walks in the initial guess and the reference's sqrt information."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 4 * np.pi, N)
    t_gt = np.stack([20 * np.cos(th), 20 * np.sin(th), 0.2 * np.sin(3 * th)], 1)
    yaw_gt = th + np.pi / 2
    R_gt = [_rot(y) for y in yaw_gt]
    d_yaw = np.cumsum(rng.normal(0, 1.5e-3, N))
    d_pitch = np.cumsum(rng.normal(0, 8e-4, N))
    d_roll = np.cumsum(rng.normal(0, 8e-4, N))
    R_init = [ypr_to_matrix_np(yaw_gt[k] + d_yaw[k], d_pitch[k], d_roll[k]) for k in range(N)]
    p_init = np.zeros((N, 3))
    p_init[0] = t_gt[0]
    for k in range(1, N):
        p_init[k] = p_init[k - 1] + R_init[k - 1] @ (R_gt[k - 1].T @ (t_gt[k] - t_gt[k - 1]))
    pairs = [(k - 1, k) for k in range(1, N)] + [(k - N // 2, k) for k in range(N // 2 + 8, N, 64)]
    i, j = (np.array(x) for x in zip(*pairs))
    ts = np.stack([R_gt[a].T @ (t_gt[b] - t_gt[a]) for a, b in pairs])
    qs = np.stack([npq.from_rotation_matrix(R_gt[a].T @ R_gt[b]) for a, b in pairs])
    E = len(pairs)
    n6 = jpg.PoseGraph6Nodes(r=p_init, q=np.stack([npq.from_rotation_matrix(R) for R in R_init]),
                             valid=np.ones(N, bool))
    W = np.broadcast_to(np.diag([20.0, 20.0, 20.0, 100.0, 100.0, 57.3]), (E, 6, 6)).copy()
    e6 = jpg.PoseGraph6Edges(i=i.astype(np.int32), j=j.astype(np.int32), t_ij=ts, q_ij=qs,
                             sqrt_info=W, valid=np.ones(E, bool))
    return n6, e6, t_gt


@pytest.mark.parametrize("N,G", [(768, 32), pytest.param(4096, 64, marks=pytest.mark.slow)])
def test_pcg_posegraph_6dof_large_graph(N, G):
    """test_pcg.py:449 (4,096 nodes under -m slow; 768 runs the same code):
    12 GN x 192 CG pull the loop residuals, roll and pitch included, under
    0.01 m and 0.02 rad, as the JAX PCG's."""
    n6, e6, t_gt = _circle_6dof(N)
    assert np.linalg.norm(n6.r - t_gt, axis=1).max() > 1.0
    want = jpar.optimize_6dof_pcg(_np(n6), _np(e6), jnp.int32(1), iters=12, cg_iters=192,
                                  coarse_group=G)
    got = tpar.optimize_6dof_pcg(posegraph_from_numpy(n6), posegraph_from_numpy(e6), 1, iters=12,
                                 cg_iters=192, coarse_group=G)
    _close_6dof(got, want)
    r_out, q_out = got.r.numpy(), got.q.numpy()
    worst_t = worst_q = 0.0
    for k in range(N - 1, len(e6.i)):
        a, b = e6.i[k], e6.j[k]
        Ra = npq.to_rotation_matrix(q_out[a])
        worst_t = max(worst_t, float(np.linalg.norm(Ra.T @ (r_out[b] - r_out[a]) - e6.t_ij[k])))
        dq = npq.multiply(npq.conjugate(e6.q_ij[k]),
                          npq.multiply(npq.conjugate(q_out[a]), q_out[b]))
        worst_q = max(worst_q, float(2 * np.arccos(min(1.0, abs(dq[3])))))
    assert worst_t < 0.01 and worst_q < 0.02, (worst_t, worst_q)


def test_pcg_core_and_block_inverse():
    """``_pcg`` with CG past the dimension solves an SPD system exactly, and
    a zero right-hand side stays zero through the guards; the unrolled
    block inverse inverts SPD blocks."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((5, 12, 12))
    M = torch.as_tensor(A @ A.transpose(0, 2, 1) + 12 * np.eye(12))
    np.testing.assert_allclose((tpcg._inv_blocks(M) @ M).numpy(), np.broadcast_to(np.eye(12),
                               (5, 12, 12)), atol=1e-12)
    H, b = M[0], torch.as_tensor(rng.standard_normal(12))
    x = tpcg._pcg(lambda v: H @ v, b, lambda v: v / torch.diagonal(H), 20)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(H.numpy(), b.numpy()), atol=1e-10)
    assert torch.equal(tpcg._pcg(lambda v: H @ v, torch.zeros(12, dtype=torch.float64),
                                 lambda v: v, 5), torch.zeros(12, dtype=torch.float64))


# ------------------------------------------------------------- global BA
def _problem(seed, **kw):
    prob, rig_p, truth = build_global_problem(jax.random.PRNGKey(seed), **kw)
    return prob, rig_p, truth, parallel_from_numpy(_np(prob)), from_numpy_tree(_np(rig_p))


def _close_ba(got, want, cost_got, cost_want, pose_tol=1e-7):
    np.testing.assert_allclose(float(cost_got), float(cost_want), rtol=1e-8)
    np.testing.assert_allclose(got.pose_r.numpy(), np.asarray(want.pose_r), rtol=0, atol=pose_tol)
    np.testing.assert_allclose(got.pose_q.numpy(), np.asarray(want.pose_q), rtol=0, atol=pose_tol)


def test_local_ba_converges():
    """test_dist_ba.py:66 on the port, and the JAX ``ba_solve_local``'s
    result."""
    prob, rig_p, truth, tprob, trig = _problem(0)
    want, wcost = jpar.ba_solve_local(prob, rig_p, iters=10)
    got, cost = tpar.ba_solve_local(tprob, trig, iters=10)
    _close_ba(got, want, cost, wcost)
    err = np.linalg.norm(got.pose_r.numpy() - np.asarray(truth["r"]), axis=1)
    assert err.max() < 0.01, err
    lerr = np.linalg.norm(got.lm.numpy() - np.asarray(truth["lms"]), axis=1)
    assert np.median(lerr) < 0.02


def test_partition_preserves_observations():
    """test_dist_ba.py:96 on the port: every valid observation kept, on its
    landmark's shard; the layout equal to the JAX one's."""
    prob, _, _, tprob, _ = _problem(2)
    want = jpar.partition_problem(prob, 4)
    got = tpar.partition_problem(tprob, 4)
    for f in ("obs_uv", "obs_pose", "obs_lm", "obs_cam", "obs_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert int(got.obs_valid.sum()) == int(tprob.obs_valid.sum())
    cap = got.obs_uv.shape[0] // 4
    ok = got.obs_valid.numpy()
    assert (got.obs_lm.numpy()[ok] // (tprob.lm.shape[0] // 4)
            == (np.arange(got.obs_uv.shape[0]) // cap)[ok]).all()


def _two_sessions():
    prob_a, rig_p, truth = build_global_problem(jax.random.PRNGKey(4), K=8, L=48, perturb=0.0)
    prob_b, _, _ = build_global_problem(jax.random.PRNGKey(4), K=8, L=48, perturb=0.0)
    off = jnp.array([0.3, -0.2, 0.15])
    prob_b = prob_b._replace(pose_r=prob_b.pose_r + off, lm=prob_b.lm + off)
    shared = [(0, k, 1, k) for k in range(48)]
    want = jpar.merge_sessions([prob_a, prob_b], shared, anchor=0)
    got = tpar.merge_sessions([parallel_from_numpy(_np(p)) for p in (prob_a, prob_b)], shared,
                              anchor=0)
    for f in got[0]._fields:
        np.testing.assert_array_equal(getattr(got[0], f).numpy(), np.asarray(getattr(want[0], f)))
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(a, b)
    return want, got, rig_p, truth


def test_multisession_joint_mapping():
    """test_dist_ba.py:108 on the port: the merge equal to the JAX one's,
    duplicates merged, and the joint BA pulls session B onto A."""
    (jjoint, _, _), (joint, pose_maps, _), rig_p, truth = _two_sessions()
    assert int(joint.lm_valid.sum()) == 48
    want, wcost = jpar.ba_solve_local(jjoint, rig_p, iters=12)
    got, cost = tpar.ba_solve_local(joint, from_numpy_tree(_np(rig_p)), iters=12)
    _close_ba(got, want, cost, wcost)
    err = np.linalg.norm(got.pose_r.numpy()[pose_maps[1]] - np.asarray(truth["r"]), axis=1)
    assert err.max() < 0.02, err


def test_multisession_joint_pcg():
    """test_pcg.py:170 on the port: the merged sessions through the
    bucketed PCG with a pose-major index."""
    (jjoint, _, _), (joint, pose_maps, _), rig_p, truth = _two_sessions()
    jb = jpar.bucket_problem(jjoint)
    tb = tpar.bucket_problem(joint)
    K = joint.pose_r.shape[0]
    want, wcost = jpar.ba_solve_pcg(jb, rig_p, iters=12, cg_iters=48,
                                    pose_perm=jpar.pose_major_index(jb.obs_pose, jb.obs_valid, K))
    got, cost = tpar.ba_solve_pcg(tb, from_numpy_tree(_np(rig_p)), iters=12, cg_iters=48,
                                  pose_perm=tpar.pose_major_index(tb.obs_pose, tb.obs_valid, K))
    _close_ba(got, want, cost, wcost)
    err = np.linalg.norm(got.pose_r.numpy()[pose_maps[1]] - np.asarray(truth["r"]), axis=1)
    assert err.max() < 0.02, err


def test_bucketed_matches_flat():
    """test_dist_ba.py:137 on the port: the bucketed layout equal to the
    JAX one's and solving to the flat path's optimum; the JAX
    ``ba_solve_bucketed``'s result."""
    prob, rig_p, _, tprob, trig = _problem(3)
    jb = jpar.bucket_problem(prob)
    tb = tpar.bucket_problem(tprob)
    for f in ("obs_uv", "obs_pose", "obs_cam", "obs_valid"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    assert int(tb.obs_valid.sum()) == int(tprob.obs_valid.sum())
    want, wcost = jpar.ba_solve_bucketed(jb, rig_p, iters=10)
    got_b, cost_b = tpar.ba_solve_bucketed(tb, trig, iters=10)
    _close_ba(got_b, want, cost_b, wcost)
    got_f, cost_f = tpar.ba_solve_local(tprob, trig, iters=10)
    np.testing.assert_allclose(float(cost_b), float(cost_f), rtol=1e-6)
    np.testing.assert_allclose(got_b.pose_r.numpy(), got_f.pose_r.numpy(), atol=1e-7)
    np.testing.assert_allclose(got_b.lm.numpy(), got_f.lm.numpy(), atol=1e-7)


def test_pcg_ba_matches_dense_reduced():
    """test_pcg.py:27 on the port: PCG with CG past the dimension reaches
    the dense Schur path's optimum; and the JAX ``ba_solve_pcg``'s."""
    prob, rig_p, _, tprob, trig = _problem(3)
    jb, tb = jpar.bucket_problem(prob), tpar.bucket_problem(tprob)
    K = tprob.pose_r.shape[0]
    want, wcost = jpar.ba_solve_pcg(jb, rig_p, iters=25, cg_iters=K * 6 + 8)
    got, cost = tpar.ba_solve_pcg(tb, trig, iters=25, cg_iters=K * 6 + 8)
    _close_ba(got, want, cost, wcost)
    dense, cost_d = tpar.ba_solve_bucketed(tb, trig, iters=25)
    np.testing.assert_allclose(float(cost), float(cost_d), rtol=1e-6)
    np.testing.assert_allclose(got.pose_r.numpy(), dense.pose_r.numpy(), atol=1e-7)
    np.testing.assert_allclose(got.lm.numpy(), dense.lm.numpy(), atol=1e-4)


def test_pcg_linear_solve_exact():
    """test_pcg.py:49 on the port: with CG past the dimension one PCG solve
    of the reduced system equals a dense solve of the matrix materialised
    column by column through the matvec."""
    _, _, _, tprob, trig = _problem(3)
    tb = tpar.bucket_problem(tprob)
    K = tprob.pose_r.shape[0]
    r, Jp, Jl, Hll_inv, Hpp_d, Minv, b_red, bl, cost = tpcg._ba_assemble_pcg(tb, trig, K, 1e-3)
    pose = tb.obs_pose.long()
    L, R = pose.shape

    def matvec(v):
        t = (Jp @ v[pose][..., None])[..., 0]
        u = (Hll_inv @ (Jl.transpose(-1, -2) @ t[..., None])[..., 0].sum(1)[..., None])[..., 0]
        g = Jp.transpose(-1, -2) @ (Jl @ u[:, None, :, None])
        y2 = torch.zeros(K, 6, dtype=v.dtype).index_add_(0, pose.reshape(-1), g.reshape(L * R, 6))
        return (Hpp_d @ v[..., None])[..., 0] - y2

    D = K * 6
    H = torch.stack([matvec(e.view(K, 6)).reshape(D) for e in torch.eye(D, dtype=torch.float64)], 1)
    want = -np.linalg.solve(H.numpy(), b_red.reshape(D).numpy())
    got = tpcg._pcg(matvec, -b_red, lambda v: (Minv @ v[..., None])[..., 0], D + 10)
    np.testing.assert_allclose(got.reshape(D).numpy(), want, atol=1e-10)


def test_pcg_ba_truncated_still_converges():
    """test_pcg.py:88 on the port: 12 GN x 32 CG reach the truth; and the
    JAX ``ba_solve_pcg``'s result."""
    prob, rig_p, truth, tprob, trig = _problem(0)
    want, wcost = jpar.ba_solve_pcg(jpar.bucket_problem(prob), rig_p, iters=12, cg_iters=32)
    got, cost = tpar.ba_solve_pcg(tpar.bucket_problem(tprob), trig, iters=12, cg_iters=32)
    _close_ba(got, want, cost, wcost)
    err = np.linalg.norm(got.pose_r.numpy() - np.asarray(truth["r"]), axis=1)
    assert err.max() < 0.01, err
    lerr = np.linalg.norm(got.lm.numpy() - np.asarray(truth["lms"]), axis=1)
    assert np.median(lerr) < 0.02


def test_pcg_pose_major_index_equivalent():
    """test_pcg.py:121 on the port: the gather-based per-pose sums give the
    index_add_ path's result; the index equal to the JAX one's."""
    _, _, _, tprob, trig = _problem(3)
    tb = tpar.bucket_problem(tprob)
    K = tprob.pose_r.shape[0]
    perm = tpar.pose_major_index(tb.obs_pose, tb.obs_valid, K)
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jpar.pose_major_index(tb.obs_pose.numpy(), tb.obs_valid.numpy(), K)))
    a, cost_a = tpar.ba_solve_pcg(tb, trig, iters=8, cg_iters=40)
    b, cost_b = tpar.ba_solve_pcg(tb, trig, iters=8, cg_iters=40, pose_perm=perm)
    np.testing.assert_allclose(float(cost_a), float(cost_b), rtol=1e-10)
    np.testing.assert_allclose(a.pose_r.numpy(), b.pose_r.numpy(), atol=1e-12)
    np.testing.assert_allclose(a.lm.numpy(), b.lm.numpy(), atol=1e-12)


def test_global_ba_problem_builder():
    """The port's numpy-seeded ``build_global_ba_problem`` (the JAX one
    draws with ``jax.random``): the JAX builder's slot layout and
    validity rule on its own draws, exact observations at the truth, and a
    perturbed start that every route solves back to the truth; it runs on
    the card unless asked for the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tproblems.build_global_ba_problem(np.random.default_rng(0), K=8, L=64, O=256)
    prob, rig_p = tproblems.build_global_ba_problem(np.random.default_rng(0), K=12, L=256, O=2048,
                                                    dtype=torch.float64, device="cpu")
    o = np.arange(2048)
    np.testing.assert_array_equal(prob.obs_pose.numpy(), o % 12)
    np.testing.assert_array_equal(prob.obs_cam.numpy(), (o // 12) % 2)
    assert 0.2 < float(prob.obs_valid.float().mean()) < 1.0
    bp = tpar.bucket_problem(prob)
    _, cost0 = tpar.ba_solve_bucketed(bp, rig_p, iters=0)
    assert float(cost0) < 1e-12  # the truth reprojects exactly
    rng = np.random.default_rng(1)
    dp = torch.as_tensor(rng.normal(0, 0.05, (12, 3)))
    dp[:2] = 0
    start = prob._replace(pose_r=prob.pose_r + dp)
    for out, _ in (tpar.ba_solve_local(start, rig_p, iters=10),
                   tpar.ba_solve_bucketed(tpar.bucket_problem(start), rig_p, iters=10),
                   tpar.ba_solve_pcg(tpar.bucket_problem(start), rig_p, iters=10, cg_iters=48)):
        assert np.abs(out.pose_r.numpy() - prob.pose_r.numpy()).max() < 1e-6
