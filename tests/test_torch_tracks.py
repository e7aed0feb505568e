"""The port's track-structured global BA (``svin_tpu_torch.parallel.tracks``)
and its problem builder against the JAX package's, in float64 on the CPU.

Inputs: the JAX tests' problems (``tests/test_tracks.py``), built by the JAX
builders (``build_global_ba_tracks``, ``build_global_ba_problem``) and
converted to the port; perturbations drawn from numpy seeds.

Tolerances, each port result against the JAX function's on the same input:
the distortion channels within 1e-12 relative (the same formulas; and
within 1e-10 of the autograd Jacobian of the port's
``cameras.distortion``); the reductions within 1e-12 (float64 sums in
another order); ``tracks_from_problem``'s fields and ``order`` equal; the
assembly within 1e-10 relative plus 1e-12 of each output's largest entry
(the port sums W over a pose's cameras and reduces by ``index_add_`` where
the JAX package uses one-hot matmuls: rounding only); the first GN step
within 1e-9 m / rad; the whole solve (3 GN x 40 CG) within 1e-7 m and its
cost within rtol 1e-8, the BA bounds of tests/test_torch_parallel.py. The
JAX tests' own bounds against the generic PCG solver and on the cost drop
are applied to the port as they are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu.cameras import distortion as jdist
from svin_tpu.parallel import tracks as jtracks
from svin_tpu.problems import build_global_ba_problem as jax_build_problem
from svin_tpu.problems import build_global_ba_tracks as jax_build_tracks
from svin_tpu_torch import parallel as tpar
from svin_tpu_torch import problems as tproblems
from svin_tpu_torch.cameras import distortion as tdist
from svin_tpu_torch.convert import from_numpy_tree, parallel_from_numpy
from svin_tpu_torch.parallel import tracks as ttracks
from torch_parity import assert_close

torch.set_num_threads(1)

LAM = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _perturbed(prob, seed):
    """``prob`` (the JAX builder's, numpy leaves) with its free poses moved
    by 2 cm and its landmarks by 5 cm (tests/test_tracks.py:122's sizes)."""
    rng = np.random.default_rng(seed)
    free = ~np.asarray(prob.pose_fixed)
    return prob._replace(
        pose_r=np.asarray(prob.pose_r) + 0.02 * rng.standard_normal(prob.pose_r.shape) * free[:, None],
        lm=np.asarray(prob.lm) + 0.05 * rng.standard_normal(prob.lm.shape))


@pytest.fixture(scope="module")
def revisits():
    """tests/test_tracks.py:100's problem in float64, perturbed: both
    packages' layouts and rigs."""
    prob, rig = jax_build_tracks(jax.random.PRNGKey(2), K=64, L=512, span=6, revisit_frac=0.05,
                                 dtype=jnp.float64)
    prob = _perturbed(_np(prob), 0)
    jtp, jmeta, jorder = jtracks.tracks_from_problem(jax.tree_util.tree_map(jnp.asarray, prob),
                                                     span=6, block=64)
    ttp, tmeta, torder = tpar.tracks_from_problem(parallel_from_numpy(prob), span=6, block=64)
    return dict(prob=prob, jrig=rig, trig=from_numpy_tree(_np(rig)), jtp=jtp, jmeta=jmeta,
                jorder=jorder, ttp=ttp, tmeta=tmeta, torder=torder)


# --------------------------------------------------------------- pieces
@pytest.mark.parametrize("model,params", [
    ("none", []),
    ("radialtangential", [-0.28, 0.07, 2e-4, 1.8e-5]),
    ("radialtangential8", [-0.28, 0.07, 2e-4, 1.8e-5, 0.01, -0.005, 0.002, -0.001]),
    ("equidistant", [-0.01, 0.02, -0.005, 0.001]),
])
def test_distort_channels_match_jax_and_autograd(model, params):
    """test_tracks.py:32 on the port: the hand-derived channels equal the
    JAX package's and the autograd Jacobian of ``cameras.distortion``."""
    pts = np.random.default_rng(3).uniform(-0.5, 0.5, size=(64, 2))
    want = jtracks._distort_channels(model, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
                                     [jnp.asarray(p) for p in params])
    tp = torch.as_tensor(pts)
    pa = torch.tensor(params, dtype=torch.float64)
    got = ttracks._distort_channels(model, tp[:, 0], tp[:, 1], list(pa))
    for name, g, w in zip(("xd", "yd", "j00", "j01", "j10", "j11"), got, want):
        assert_close(torch.broadcast_to(g, tp[:, 0].shape), np.broadcast_to(w, (64,)), rtol=1e-12,
                     atol_rel=1e-15, name=name)
    ref = tdist.distort(model, tp, pa)
    J = torch.func.vmap(torch.func.jacrev(lambda p: tdist.distort(model, p, pa)))(tp)
    np.testing.assert_allclose(torch.stack(got[:2], -1).numpy(), ref.numpy(), rtol=1e-12, atol=1e-14)
    for (i, j), g in zip(((0, 0), (0, 1), (1, 0), (1, 1)), got[2:]):
        np.testing.assert_allclose(torch.broadcast_to(g, (64,)).numpy(), J[:, i, j].numpy(),
                                   rtol=1e-10, atol=1e-12)
    # and the JAX package's own model definitions agree (the mirrored test's check)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jdist.distort(
        model, jnp.asarray(pts), jnp.asarray(params, jnp.float64))), rtol=1e-12, atol=1e-14)


def test_banded_reduce_matches_jax_and_a_plain_sum():
    """test_tracks.py:51 on the port: rows summed by their landmark's base,
    equal to the JAX one-hot block reduction and to a plain per-row sum;
    with track offsets, row (l, r) lands on pose base_l + r."""
    rng = np.random.default_rng(0)
    K, L, B, D = 64, 256, 32, 12
    base = np.sort(rng.integers(0, K - 8, size=L))
    NB = L // B
    lo = np.minimum(base[np.arange(NB) * B], K - 24)
    meta = jtracks.TrackMeta(span=8, C=1, B=B, S=24, K=K, n_blocks=NB, M=8)
    rows = rng.standard_normal((L, D))
    want = jtracks._banded_reduce(jnp.asarray(rows), jnp.asarray(base, jnp.int32),
                                  jnp.asarray(lo, jnp.int32), meta)
    plain = np.zeros((K, D))
    np.add.at(plain, base, rows)
    got = ttracks._banded_reduce(torch.as_tensor(rows)[:, None], torch.as_tensor(base)[:, None], K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), plain, rtol=0, atol=1e-12)
    span = 8
    rows3 = rng.standard_normal((L, span, D))
    pose_rows = base[:, None] + np.arange(span)
    plain3 = np.zeros((K, D))
    np.add.at(plain3, pose_rows.reshape(-1), rows3.reshape(-1, D))
    got3 = ttracks._banded_reduce(torch.as_tensor(rows3), torch.as_tensor(pose_rows), K)
    np.testing.assert_allclose(got3.numpy(), plain3, rtol=0, atol=1e-12)


def test_reduction_folds_slot_offsets_as_shift_add():
    """test_tracks.py:65 on the port: slot j of base k contributes to pose
    k + j // C (base 4, slot r=2, cam=1 → pose 6), as the JAX
    ``_shift_add`` folds it."""
    K, C, span, ch = 16, 2, 3, 2
    Z = np.zeros((K, span * C * ch))
    Z[4, (2 * C + 1) * ch] = 1.0  # base 4, slot r=2, cam=1
    meta = jtracks.TrackMeta(span=span, C=C, B=1, S=8, K=K, n_blocks=1, M=1)
    want = np.asarray(jtracks._shift_add(jnp.asarray(Z), meta, ch))
    slots = torch.as_tensor(Z[4].reshape(1, span, C, ch))  # landmark with base 4
    got = ttracks._banded_reduce(slots.sum(2), torch.tensor([[4, 5, 6]]), K)
    assert float(got[6, 0]) == 1.0 and float(got.abs().sum()) == 1.0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_shards,block", [(1, 64), (2, 32)])
def test_tracks_from_problem_matches_jax(n_shards, block):
    """The relayout of tests/test_tracks.py:100's problem equal to the JAX
    one's field by field, ``order`` and the layout constants included, one
    and two shards; every in-track row inside its block's pose window, the
    condition under which the JAX one-hot form and the port's index_add_
    sum the same rows."""
    prob, _ = jax_build_tracks(jax.random.PRNGKey(2), K=64, L=512, span=6, revisit_frac=0.05,
                               dtype=jnp.float64)
    jtp, jmeta, jorder = jtracks.tracks_from_problem(prob, span=6, block=block, n_shards=n_shards)
    ttp, tmeta, torder = tpar.tracks_from_problem(parallel_from_numpy(_np(prob)), span=6,
                                                  block=block, n_shards=n_shards)
    assert tuple(tmeta) == tuple(jmeta)
    np.testing.assert_array_equal(torder, np.asarray(jorder))
    for f in ttp._fields:
        np.testing.assert_array_equal(getattr(ttp, f).numpy(), np.asarray(getattr(jtp, f)),
                                      err_msg=f)
    assert ttp.base.dtype == ttp.ov_pose.dtype == ttp.ov_lm.dtype == torch.int64
    assert bool(ttp.ov_valid.any())
    base = ttp.base.numpy()
    lo_c = np.clip(ttp.lo.numpy(), 0, max(tmeta.K - tmeta.S, 0))
    local = base - np.repeat(lo_c, tmeta.B)
    in_track = ttp.obs_valid.numpy().any(0)
    assert in_track.sum() > 200
    assert ((local[in_track] >= 0) & (local[in_track] < tmeta.S)).all()


# ---------------------------------------------------------- against JAX
def test_assemble_matches_jax(revisits):
    """``_assemble_tracks`` on the perturbed revisit problem: the JAX
    outputs, its W laid out as the port's (summed over each pose's
    cameras, (L, 3, span·6))."""
    p = revisits
    want = jax.jit(lambda tp: jtracks._assemble_tracks(tp, p["jrig"], p["jmeta"],
                                                        jnp.asarray(LAM)))(p["jtp"])
    got = ttracks._assemble_tracks(p["ttp"], p["trig"], p["tmeta"], LAM)
    span, C = p["tmeta"].span, p["tmeta"].C
    L = got.Wl.shape[0]
    Wl = np.asarray(want.Wrm).reshape(L, span, C, 3, 6).sum(2).transpose(0, 2, 1, 3)
    tol = dict(rtol=1e-10, atol_rel=1e-12)
    assert_close(got.Wl, Wl.reshape(L, 3, span * 6), name="W", **tol)
    assert_close(got.Wov, np.asarray(want.Wov).reshape(-1, 3, 6), name="Wov", **tol)
    assert_close(got.Hll_inv, np.asarray(want.Hll_inv).T.reshape(L, 3, 3), name="Hll_inv", **tol)
    assert_close(got.bl, np.asarray(want.bl).T, name="bl", **tol)
    for f in ("Hpp_d", "Minv", "b_red", "cost"):
        assert_close(getattr(got, f), getattr(want, f), name=f, **tol)
    assert float(got.cost) > 1.0  # the perturbation shows


def test_first_gn_step_matches_jax(revisits):
    """One GN step (40 CG) equal to the JAX step within 1e-9."""
    p = revisits
    jdx, jdl, jcost = jax.jit(lambda tp: jtracks._gn_step_tracks(
        tp, p["jrig"], p["jmeta"], jnp.asarray(LAM), 40))(p["jtp"])
    dx, dl, cost = ttracks._gn_step_tracks(p["ttp"], p["trig"], p["tmeta"], LAM, 40)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), rtol=0, atol=1e-9)
    assert_close(cost, jcost, rtol=1e-12)
    assert float(np.abs(np.asarray(jdx)).max()) > 1e-3  # a real step


def test_ba_solve_tracks_matches_jax(revisits):
    """``ba_solve_tracks``, 3 GN x 40 CG (tests/test_tracks.py's budget):
    poses within 1e-7 m, landmarks within 1e-7 m, cost within rtol 1e-8 of
    the JAX solve's."""
    p = revisits
    want, wcost = jax.jit(lambda tp: jtracks.ba_solve_tracks(
        tp, p["jrig"], p["jmeta"], iters=3, cg_iters=40))(p["jtp"])
    got, cost = tpar.ba_solve_tracks(p["ttp"], p["trig"], p["tmeta"], iters=3, cg_iters=40)
    assert_close(cost, wcost, rtol=1e-8)
    for f in ("pose_r", "pose_q", "lm"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-7, err_msg=f)
    assert float(cost) < 1e-3 * float(ttracks._assemble_tracks(p["ttp"], p["trig"], p["tmeta"],
                                                               LAM).cost)


# ------------------------------------------- the JAX tests, on the port
def _solve_both(prob, rig, iters=3, cg=40, span=8, block=64):
    """test_tracks.py:76 on the port: the bucketed PCG (pose-major index,
    buckets of 2·span) and the track solver on the same problem."""
    K = prob.pose_r.shape[0]
    bprob = tpar.bucket_problem(prob, R=2 * span)
    perm = tpar.pose_major_index(bprob.obs_pose, bprob.obs_valid, K)
    p1, c1 = tpar.ba_solve_pcg(bprob, rig, iters=iters, cg_iters=cg, pose_perm=perm)
    tp, meta, order = tpar.tracks_from_problem(prob, span=span, block=block)
    p2, c2 = tpar.ba_solve_tracks(tp, rig, meta, iters=iters, cg_iters=cg)
    return (p1, c1), (p2, c2), order


def test_tracks_equivalent_to_pcg_random_problem():
    """test_tracks.py:89 on the port: on a random-assignment problem most
    observations overflow; the solve matches the PCG path."""
    prob, rig = jax_build_problem(jax.random.PRNGKey(1), K=48, L=256, O=2048, dtype=jnp.float64)
    tprob, trig = parallel_from_numpy(_np(prob)), from_numpy_tree(_np(rig))
    (p1, c1), (p2, c2), _ = _solve_both(tprob, trig)
    np.testing.assert_allclose(float(c1), float(c2), rtol=5e-3, atol=1e-9)
    np.testing.assert_allclose(p1.pose_r.numpy(), p2.pose_r.numpy(), atol=5e-5)
    np.testing.assert_allclose(p1.pose_q.numpy(), p2.pose_q.numpy(), atol=5e-5)


def test_tracks_equivalent_on_track_problem_with_revisits():
    """test_tracks.py:100 on the port (its problem): the track solver and
    the PCG path (whose buckets of 12 drop the revisits of full tracks)
    agree on cost, poses and, through the sort permutation, landmarks."""
    prob, rig = jax_build_tracks(jax.random.PRNGKey(2), K=64, L=512, span=6, revisit_frac=0.05,
                                 dtype=jnp.float64)
    tprob, trig = parallel_from_numpy(_np(prob)), from_numpy_tree(_np(rig))
    assert int(tprob.obs_valid.sum()) > 1000
    (p1, c1), (p2, c2), order = _solve_both(tprob, trig, span=6)
    np.testing.assert_allclose(float(c1), float(c2), rtol=5e-3, atol=5e-7)
    np.testing.assert_allclose(p1.pose_r.numpy(), p2.pose_r.numpy(), atol=5e-5)
    L0 = tprob.lm.shape[0]
    sel = order < L0
    lm_back = np.zeros((L0, 3))
    lm_back[order[sel]] = p2.lm.numpy()[sel]
    mask = tpar.bucket_problem(tprob, R=12).lm_valid.numpy()
    np.testing.assert_allclose(lm_back[mask], p1.lm.numpy()[mask], atol=2e-4)


def test_tracks_improves_perturbed_problem():
    """test_tracks.py:122 on the port: its problem with poses moved by 2 cm
    and landmarks by 5 cm (numpy-seeded) converges back, the cost down
    more than 100x."""
    prob, rig = jax_build_tracks(jax.random.PRNGKey(4), K=64, L=512, span=6, dtype=jnp.float64)
    noisy = parallel_from_numpy(_perturbed(_np(prob), 7))
    tp, meta, _ = tpar.tracks_from_problem(noisy, span=6, block=64)
    trig = from_numpy_tree(_np(rig))
    _, c0 = tpar.ba_solve_tracks(tp, trig, meta, iters=0, cg_iters=8)
    _, c1 = tpar.ba_solve_tracks(tp, trig, meta, iters=6, cg_iters=48)
    assert float(c1) < float(c0) / 100.0


def test_global_ba_tracks_builder():
    """The port's numpy-seeded ``build_global_ba_tracks`` (the JAX one draws
    with ``jax.random``): the (L, span, C) slot grid plus the revisits,
    > 1,000 valid observations, runs of 2..span keyframes, a non-empty
    overflow after the relayout, the truth reprojecting exactly; it runs
    on the card unless asked for the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tproblems.build_global_ba_tracks(np.random.default_rng(0), K=16, L=64)
    K, L, span, C = 64, 512, 6, 2
    prob, rig = tproblems.build_global_ba_tracks(np.random.default_rng(2), K=K, L=L, span=span,
                                                 revisit_frac=0.05, dtype=torch.float64,
                                                 device="cpu")
    n_rev = int(L * 0.05)
    O = L * span * C + n_rev
    assert prob.obs_uv.shape == (O, 2) and prob.obs_pose.shape == (O,)
    assert prob.pose_r.shape == (K, 3) and prob.lm.shape == (L, 3)
    assert prob.pose_fixed.tolist() == [True, True] + [False] * (K - 2)
    assert int(prob.obs_valid.sum()) > 1000
    grid = prob.obs_pose[:L * span * C].view(L, span, C)
    assert (grid[:, 1:] - grid[:, :-1]).le(1).all() and (grid[..., 0] == grid[..., 1]).all()
    assert (prob.obs_cam[:L * span * C].view(L, span, C) == torch.arange(C)).all()
    assert (prob.obs_cam[L * span * C:] == 0).all()
    runs = prob.obs_valid[:L * span * C].view(L, span, C).any(2).sum(1)
    assert int(runs.max()) <= span
    tp, meta, _ = tpar.tracks_from_problem(prob, span=span, block=64)
    assert bool(tp.ov_valid.any())
    _, cost = tpar.ba_solve_tracks(tp, rig, meta, iters=0)
    assert float(cost) < 1e-16
