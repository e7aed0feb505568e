"""The port's sharded solvers (``make_sharded_*`` on ``torch.distributed``)
against the port's local solvers at world 1 and the JAX package's sharded
steps at 2 devices, in float64 on the CPU.

Inputs: the JAX tests' problems (``test_dist_ba.build_global_problem`` at
K=12, L=64 with keys 1 and 4; ``test_loopclosure._make_drifted_graph``; the
track problem of ``test_tracks.py:143``, K=64, L=512, span 6, blocks of 32,
its free poses moved by 2 cm and landmarks by 5 cm from a numpy seed so the
steps are real), built by the JAX builders.

World 1: each factory in this process, on a gloo group of one rank (the
all_reduce runs), equal to the port's local solver on the same input (max
abs difference 0). The dense pose graph has no local solver of the same
arithmetic (``optimize_4dof`` solves an equilibrated Cholesky): it is held
to ``optimize_4dof`` within 1e-8, the JAX test's bound (test_dist_posegraph.py:15).

World 2: two gloo worker processes (``torch_dist_worker.py``), fed the JAX
builders' inputs through an ``.npz``, against the JAX step on 2 of
conftest's 8 CPU devices: ``make_sharded_ba``, ``make_sharded_ba_bucketed``
and ``make_sharded_posegraph`` within 1e-8 (poses, landmarks, nodes) and
rtol 1e-6 (cost); the PCG and track factories under the "Parity of
truncated CG" rule: the first GN step (40 / 20 / 32 CG) within 1e-9, the
whole solve within 1e-6 at a CG budget past the system's dimension, where
CG converges. A worker failure or timeout fails the tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import svin_tpu.parallel as jpar
from svin_tpu.parallel import tracks as jtracks
from svin_tpu.problems import build_global_ba_tracks as jax_build_tracks
from svin_tpu_torch import parallel as tpar
from svin_tpu_torch.convert import from_numpy_tree, parallel_from_numpy, posegraph_from_numpy
from svin_tpu_torch.loopclosure import optimize_4dof
from test_dist_ba import build_global_problem
from test_loopclosure import _make_drifted_graph
from torch_dist_worker import launch, save_tree

torch.set_num_threads(1)

K, L = 12, 64
PCG_CG = K * 6 + 8  # past the reduced system's dimension (test_pcg.py:27's budget)
PG_CG = 64 * 4 + 8  # the drifted graph's 64 node slots
TRACKS_CG = 64 * 6 + 8


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


@pytest.fixture(scope="module")
def problems():
    """The JAX builders' inputs (numpy leaves)."""
    ba1, rig, _ = build_global_problem(jax.random.PRNGKey(1))
    ba4, _, _ = build_global_problem(jax.random.PRNGKey(4))
    nodes, edges, t_gt, _, n_live = _make_drifted_graph()
    tprob, trig = jax_build_tracks(jax.random.PRNGKey(5), K=64, L=512, span=6, revisit_frac=0.05,
                                   dtype=jnp.float64)
    tprob = _np(tprob)
    rng = np.random.default_rng(0)
    free = ~np.asarray(tprob.pose_fixed)
    tprob = tprob._replace(
        pose_r=tprob.pose_r + 0.02 * rng.standard_normal(tprob.pose_r.shape) * free[:, None],
        lm=tprob.lm + 0.05 * rng.standard_normal(tprob.lm.shape))
    return dict(ba1=_np(ba1), ba4=_np(ba4), rig=_np(rig), nodes=_np(nodes), edges=_np(edges),
                t_gt=t_gt, n_live=n_live, tracks=tprob, tracks_rig=_np(trig))


@pytest.fixture(scope="module")
def world2(problems, tmp_path_factory):
    """Every sharded factory on two gloo ranks: rank 0's outputs."""
    inputs = {"pcg_cg": np.asarray(PCG_CG), "pg_cg": np.asarray(PG_CG),
              "tracks_cg": np.asarray(TRACKS_CG)}
    for tag in ("ba1", "ba4", "rig", "nodes", "edges", "tracks", "tracks_rig"):
        save_tree(inputs, tag, problems[tag])
    return launch("solvers", 2, tmp_path_factory.mktemp("world2"), inputs)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A gloo group of one rank in this process, torn down after the module."""
    rdv = tmp_path_factory.mktemp("world1") / "rendezvous"
    tpar.initialize_distributed(f"file://{rdv}", 1, 0, backend="gloo", device="cpu")
    try:
        yield tpar.make_process_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _jmesh():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _jtree(tree):
    """numpy leaves as JAX arrays (strings and ints kept)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a,
                                  tree)


def _equal(got, want, *fields):
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _close(out, name, want, cost, fields, atol, cost_rtol=None):
    for f in fields:
        np.testing.assert_allclose(out[f"{name}.{f}"], np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol, err_msg=f"{name}.{f}")
    if cost_rtol is not None:
        np.testing.assert_allclose(float(out[f"{name}.cost"]), float(cost), rtol=cost_rtol)


# ------------------------------------------------------------------- world 1
def test_sharded_ba_world1_equals_local(problems, mesh1):
    """test_dist_ba.py:75 at world 1: ``make_sharded_ba`` on the
    partitioned problem == ``ba_solve_local`` on it."""
    prob = tpar.partition_problem(parallel_from_numpy(problems["ba1"]), 1)
    rig = from_numpy_tree(problems["rig"])
    step, shard = tpar.make_sharded_ba(mesh1, rig, K, L, prob.obs_uv.shape[0], iters=10)
    got, cost = step(shard(prob))
    want, wcost = tpar.ba_solve_local(prob, rig, iters=10)
    _equal(tpar.gather(mesh1, got), want, "pose_r", "pose_q", "lm")
    assert torch.equal(cost, wcost)


def test_sharded_bucketed_world1_equals_local(problems, mesh1):
    """test_dist_ba.py:156 at world 1."""
    bp = tpar.bucket_problem(parallel_from_numpy(problems["ba4"]))
    rig = from_numpy_tree(problems["rig"])
    step, shard = tpar.make_sharded_ba_bucketed(mesh1, rig, K, L, iters=10)
    got, cost = step(shard(bp))
    want, wcost = tpar.ba_solve_bucketed(bp, rig, iters=10)
    _equal(got, want, "pose_r", "pose_q", "lm")
    assert torch.equal(cost, wcost)


@pytest.mark.parametrize("use_pose_perm", [False, True])
def test_sharded_pcg_world1_equals_local(problems, mesh1, use_pose_perm):
    """test_pcg.py:102 and :143 at world 1: 8 GN x 40 CG, with scatters
    and with the per-shard pose-major gathers."""
    bp = tpar.bucket_problem(parallel_from_numpy(problems["ba4"]))
    rig = from_numpy_tree(problems["rig"])
    step, shard = tpar.make_sharded_ba_pcg(mesh1, rig, K, L, iters=8, cg_iters=40,
                                           use_pose_perm=use_pose_perm)
    if use_pose_perm:
        perm = tpar.sharded_pose_major_index(bp, K, 1)
        got, cost = step(shard[0](bp), shard[1](perm))
        want, wcost = tpar.ba_solve_pcg(bp, rig, iters=8, cg_iters=40, pose_perm=perm[0])
    else:
        got, cost = step(shard(bp))
        want, wcost = tpar.ba_solve_pcg(bp, rig, iters=8, cg_iters=40)
    _equal(got, want, "pose_r", "pose_q", "lm")
    assert torch.equal(cost, wcost)


def test_sharded_posegraph_world1(problems, mesh1):
    """test_dist_posegraph.py:15 at world 1: within 1e-8 of
    ``optimize_4dof`` and the drift removed."""
    nodes, edges = posegraph_from_numpy(problems["nodes"]), posegraph_from_numpy(problems["edges"])
    step, shard = tpar.make_sharded_posegraph(mesh1, nodes.p.shape[0], edges.i.shape[0], iters=10)
    got, cost = step(nodes, shard(edges), 1)
    want = optimize_4dof(nodes, edges, 1, iters=10)
    np.testing.assert_allclose(got.p.numpy(), want.p.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.yaw.numpy(), want.yaw.numpy(), rtol=0, atol=1e-8)
    n = problems["n_live"]
    assert np.linalg.norm(got.p[n - 1].numpy() - problems["t_gt"][n - 1]) < 0.15
    assert torch.isfinite(cost)


def test_sharded_posegraph_pcg_world1_equals_local(problems, mesh1):
    """test_pcg.py:216 at world 1: 10 GN x 64 CG == ``optimize_4dof_pcg``."""
    nodes, edges = posegraph_from_numpy(problems["nodes"]), posegraph_from_numpy(problems["edges"])
    step, shard = tpar.make_sharded_posegraph_pcg(mesh1, nodes.p.shape[0], edges.i.shape[0],
                                                  iters=10, cg_iters=64)
    got, _ = step(nodes, shard(edges), 1)
    want = tpar.optimize_4dof_pcg(nodes, edges, 1, iters=10, cg_iters=64)
    _equal(got, want, "p", "yaw")


def test_sharded_tracks_world1_equals_local(problems, mesh1):
    """test_tracks.py:143 at world 1: 3 GN x 32 CG == ``ba_solve_tracks``."""
    tp, meta, _ = tpar.tracks_from_problem(parallel_from_numpy(problems["tracks"]), span=6,
                                           block=32, n_shards=1)
    rig = from_numpy_tree(problems["tracks_rig"])
    step, shard = tpar.make_sharded_ba_tracks(mesh1, rig, meta, iters=3, cg_iters=32)
    got, cost = step(shard(tp))
    want, wcost = tpar.ba_solve_tracks(tp, rig, meta, iters=3, cg_iters=32)
    _equal(got, want, "pose_r", "pose_q", "lm")
    assert torch.equal(cost, wcost)


# ------------------------------------------------------------------- world 2
def test_sharded_ba_world2_matches_jax(problems, world2):
    """test_dist_ba.py:75 at 2 ranks: the JAX step at 2 devices within 1e-8,
    cost within rtol 1e-6."""
    prob = jpar.partition_problem(_jtree(problems["ba1"]), 2)
    step, sh = jpar.make_sharded_ba(_jmesh(), _jtree(problems["rig"]), K, L, prob.obs_uv.shape[0],
                                    iters=10)
    want, cost = step(jax.device_put(prob, sh))
    _close(world2, "ba", want, cost, ("pose_r", "pose_q", "lm"), 1e-8, 1e-6)


def test_sharded_bucketed_world2_matches_jax(problems, world2):
    """test_dist_ba.py:156 at 2 ranks."""
    bp = jpar.bucket_problem(_jtree(problems["ba4"]))
    step, sh = jpar.make_sharded_ba_bucketed(_jmesh(), _jtree(problems["rig"]), K, L, iters=10)
    want, cost = step(jax.device_put(bp, sh))
    _close(world2, "bucketed", want, cost, ("pose_r", "pose_q", "lm"), 1e-8, 1e-6)


def test_sharded_posegraph_world2_matches_jax(problems, world2):
    """test_dist_posegraph.py:15 at 2 ranks."""
    nodes, edges = _jtree(problems["nodes"]), jpar.pad_edges_for_mesh(_jtree(problems["edges"]), 2)
    step, (nsh, esh) = jpar.make_sharded_posegraph(_jmesh(), nodes.p.shape[0], edges.i.shape[0],
                                                   iters=10)
    want, cost = step(jax.device_put(nodes, nsh), jax.device_put(edges, esh), jnp.int32(1))
    _close(world2, "posegraph", want, cost, ("p", "yaw"), 1e-8, 1e-6)


@pytest.mark.parametrize("use_pose_perm", [False, True])
def test_sharded_pcg_world2_matches_jax(problems, world2, use_pose_perm):
    """test_pcg.py:102 and :143 at 2 ranks: the first GN step (40 CG)
    within 1e-9, 8 GN at PCG_CG within 1e-6."""
    bp = jpar.bucket_problem(_jtree(problems["ba4"]))
    perm = jpar.sharded_pose_major_index(bp, K, 2) if use_pose_perm else None
    name = "pcg_perm" if use_pose_perm else "pcg"
    for tag, it, cg, tol in (("first", 1, 40, 1e-9), ("whole", 8, PCG_CG, 1e-6)):
        step, sh = jpar.make_sharded_ba_pcg(_jmesh(), _jtree(problems["rig"]), K, L, iters=it,
                                            cg_iters=cg, use_pose_perm=use_pose_perm)
        if use_pose_perm:
            want, cost = step(jax.device_put(bp, sh[0]), jax.device_put(perm, sh[1]))
        else:
            want, cost = step(jax.device_put(bp, sh))
        _close(world2, f"{name}_{tag}", want, cost, ("pose_r", "pose_q", "lm"), tol,
               1e-6 if tag == "whole" else None)


def test_sharded_posegraph_pcg_world2_matches_jax(problems, world2):
    """test_pcg.py:216 at 2 ranks: the first GN step (20 CG) within 1e-9,
    10 GN at PG_CG within 1e-6."""
    nodes, edges = _jtree(problems["nodes"]), jpar.pad_edges_for_mesh(_jtree(problems["edges"]), 2)
    for tag, it, cg, tol in (("first", 1, 20, 1e-9), ("whole", 10, PG_CG, 1e-6)):
        step, (nsh, esh) = jpar.make_sharded_posegraph_pcg(
            _jmesh(), nodes.p.shape[0], edges.i.shape[0], iters=it, cg_iters=cg)
        want, cost = step(jax.device_put(nodes, nsh), jax.device_put(edges, esh), jnp.int32(1))
        _close(world2, f"posegraph_pcg_{tag}", want, cost, ("p", "yaw"), tol)
    n = problems["n_live"]
    assert np.linalg.norm(world2["posegraph_pcg_whole.p"][n - 1] - problems["t_gt"][n - 1]) < 0.15


def test_sharded_tracks_world2_matches_jax(problems, world2):
    """test_tracks.py:143 at 2 ranks (perturbed): the first GN step (32 CG)
    within 1e-9, 3 GN at TRACKS_CG within 1e-6, the cost fallen."""
    tp, meta, _ = jtracks.tracks_from_problem(_jtree(problems["tracks"]), span=6, block=32,
                                              n_shards=2)
    rig = _jtree(problems["tracks_rig"])
    for tag, it, cg, tol in (("first", 1, 32, 1e-9), ("whole", 3, TRACKS_CG, 1e-6)):
        step, sh = jtracks.make_sharded_ba_tracks(_jmesh(), rig, meta, iters=it, cg_iters=cg)
        want, cost = step(jax.device_put(tp, sh))
        _close(world2, f"tracks_{tag}", want, cost, ("pose_r", "pose_q", "lm"), tol,
               1e-6 if tag == "whole" else None)
    assert float(world2["tracks_whole.cost"]) < float(world2["tracks_first.cost"])


# -------------------------------------------------------------- the helpers
def test_sharded_pose_major_index_matches_jax(problems):
    """``sharded_pose_major_index`` equal to the JAX one's at 2 and 4
    shards."""
    jb = jpar.bucket_problem(_jtree(problems["ba4"]))
    tb = tpar.bucket_problem(parallel_from_numpy(problems["ba4"]))
    for n in (2, 4):
        np.testing.assert_array_equal(tpar.sharded_pose_major_index(tb, K, n).numpy(),
                                      np.asarray(jpar.sharded_pose_major_index(jb, K, n)))


def test_pad_edges_for_mesh_matches_jax(problems):
    """``pad_edges_for_mesh`` equal to the JAX one's; nothing added when
    the count divides."""
    te = posegraph_from_numpy(problems["edges"])
    te = te._replace(**{f: getattr(te, f)[:191] for f in te._fields})
    je = jax.tree_util.tree_map(lambda a: a[:191], _jtree(problems["edges"]))
    got, want = tpar.pad_edges_for_mesh(te, 8), jpar.pad_edges_for_mesh(je, 8)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert tpar.pad_edges_for_mesh(got, 4) is got


def test_shard_gather_roundtrip_and_divisibility(problems):
    """On a mesh of one process without a group, ``shard`` and ``gather``
    are the identity; rank 1 of two takes the second half of every sharded
    field; the factories refuse shapes that do not divide the mesh, as the
    JAX ones assert."""
    mesh = tpar.ProcessMesh(group=None, rank=0, size=1, device=torch.device("cpu"), axis="data")
    tp, meta, _ = tpar.tracks_from_problem(parallel_from_numpy(problems["tracks"]), span=6,
                                           block=32, n_shards=2)
    back = tpar.gather(mesh, tpar.shard(mesh, tp))
    for f in tp._fields:
        assert torch.equal(getattr(back, f), getattr(tp, f)), f
    two = mesh._replace(size=2, rank=1)
    half = tpar.shard(two, tp)
    assert half.obs_uv.shape[2] == tp.obs_uv.shape[2] // 2 and half.lo.shape[0] == meta.n_blocks
    assert torch.equal(half.obs_valid, tp.obs_valid[:, tp.lm.shape[0] // 2:])
    rig = from_numpy_tree(problems["rig"])
    with pytest.raises(ValueError, match="does not divide"):
        tpar.make_sharded_ba(two, rig, K, 63, 512)
    with pytest.raises(ValueError, match="does not divide"):
        tpar.make_sharded_posegraph_pcg(two, 64, 191)


def test_exports_every_jax_name():
    """The port's ``parallel`` exports every name of the JAX package's."""
    assert set(jpar.__all__) <= set(tpar.__all__)
    assert all(hasattr(tpar, n) for n in jpar.__all__)
