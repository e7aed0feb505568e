"""Worker processes for the port's multi-process CPU tests
(``test_torch_dist.py``, ``test_torch_runtime.py``): ``launch`` starts
``world`` copies of this script, each one gloo rank on the CPU (one torch
thread, a ``file://`` rendezvous in the test's directory), and returns what
rank 0 wrote. A worker imports only ``svin_tpu_torch`` (never JAX); its
inputs come through an ``.npz`` written by the test.

    python tests/torch_dist_worker.py <case> <rank> <world> <dir>

reads ``<dir>/in.npz`` and writes ``<dir>/out_<rank>.npz``. Cases:
``solvers`` (every sharded solver), ``exchange`` (a cross-process sum and
the payload exchanges), ``mapping`` (cooperative mapping, then
``dryrun_multichip``), all on the CPU; ``card`` (the sharded bucketed BA on
the CUDA card, every rank on device 0, gloo reducing through the host).
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the test side
def save_tree(out: dict, tag: str, tree) -> None:
    """A NamedTuple's numpy leaves into ``out`` under ``tag.field``
    (class name under ``tag.__class__``; None leaves left out)."""
    out[f"{tag}.__class__"] = np.asarray(type(tree).__name__)
    for f in tree._fields:
        v = getattr(tree, f)
        if v is not None:
            out[f"{tag}.{f}"] = np.asarray(v)


def launch(case: str, world: int, workdir, inputs: dict, timeout: float = 240.0) -> dict:
    """Run ``case`` on ``world`` gloo ranks and return rank 0's outputs;
    raises if a worker fails or outlives ``timeout`` seconds."""
    workdir = str(workdir)
    np.savez(os.path.join(workdir, "in.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r), str(world),
                               workdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{case}: a worker outlived {timeout} s")
    if any(p.returncode for p in procs):
        raise AssertionError(f"{case}: worker failed\n" + "\n".join(o[-3000:] for o in outs))
    with np.load(os.path.join(workdir, "out_0.npz")) as f:
        return {k: f[k] for k in f.files}


# ------------------------------------------------------------- the worker
def load_tree(data, tag: str, device="cpu"):
    """``save_tree``'s NamedTuple as the port's class, float64 tensors."""
    import torch

    from svin_tpu_torch import estimator, loopclosure, parallel

    name = str(data[f"{tag}.__class__"])
    cls = next(getattr(m, name) for m in (parallel, loopclosure, estimator) if hasattr(m, name))
    kw = {}
    for f in cls._fields:
        key = f"{tag}.{f}"
        if key not in data:
            continue
        a = data[key]
        if a.dtype.kind in "US":
            kw[f] = str(a)
        elif a.ndim == 0 and a.dtype.kind in "iu" and name == "RigParams":
            kw[f] = int(a)
        else:
            kw[f] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return cls(**kw)


def _solvers(data, mesh) -> dict:
    """Every sharded factory on the test's inputs (float64): the whole
    problem's poses, landmarks and cost (nodes for the pose graphs)."""
    from svin_tpu_torch import parallel as tpar

    out = {}
    rig = load_tree(data, "rig")

    def keep(name, res, cost, *fields):
        for f in fields:
            out[f"{name}.{f}"] = getattr(res, f).numpy()
        out[f"{name}.cost"] = np.asarray(float(cost))

    prob = load_tree(data, "ba1")
    K, L = prob.pose_r.shape[0], prob.lm.shape[0]
    ps = tpar.partition_problem(prob, mesh.size)
    step, shard = tpar.make_sharded_ba(mesh, rig, K, L, ps.obs_uv.shape[0], iters=10)
    local, cost = step(shard(ps))
    keep("ba", tpar.gather(mesh, local), cost, "pose_r", "pose_q", "lm")

    bp = tpar.bucket_problem(load_tree(data, "ba4"))
    step, shard = tpar.make_sharded_ba_bucketed(mesh, rig, K, L, iters=10)
    local, cost = step(shard(bp))
    keep("bucketed", tpar.gather(mesh, local), cost, "pose_r", "pose_q", "lm")

    for tag, it, cg in (("first", 1, 40), ("whole", 8, int(data["pcg_cg"]))):
        step, shard = tpar.make_sharded_ba_pcg(mesh, rig, K, L, iters=it, cg_iters=cg)
        local, cost = step(shard(bp))
        keep(f"pcg_{tag}", tpar.gather(mesh, local), cost, "pose_r", "pose_q", "lm")
        perm = tpar.sharded_pose_major_index(bp, K, mesh.size)
        step, (shard, shard_perm) = tpar.make_sharded_ba_pcg(mesh, rig, K, L, iters=it,
                                                             cg_iters=cg, use_pose_perm=True)
        local, cost = step(shard(bp), shard_perm(perm))
        keep(f"pcg_perm_{tag}", tpar.gather(mesh, local), cost, "pose_r", "pose_q", "lm")

    nodes, edges = load_tree(data, "nodes"), load_tree(data, "edges")
    edges_p = tpar.pad_edges_for_mesh(edges, mesh.size)
    N, E = nodes.p.shape[0], edges_p.i.shape[0]
    step, shard = tpar.make_sharded_posegraph(mesh, N, E, iters=10)
    nd, cost = step(nodes, shard(edges_p), 1)
    keep("posegraph", nd, cost, "p", "yaw")
    for tag, it, cg in (("first", 1, 20), ("whole", 10, int(data["pg_cg"]))):
        step, shard = tpar.make_sharded_posegraph_pcg(mesh, N, E, iters=it, cg_iters=cg)
        nd, cost = step(nodes, shard(edges_p), 1)
        keep(f"posegraph_pcg_{tag}", nd, cost, "p", "yaw")

    tprob, trig = load_tree(data, "tracks"), load_tree(data, "tracks_rig")
    tp, meta, _ = tpar.tracks_from_problem(tprob, span=6, block=32, n_shards=mesh.size)
    for tag, it, cg in (("first", 1, 32), ("whole", 3, int(data["tracks_cg"]))):
        step, shard = tpar.make_sharded_ba_tracks(mesh, trig, meta, iters=it, cg_iters=cg)
        local, cost = step(shard(tp))
        keep(f"tracks_{tag}", tpar.gather(mesh, local), cost, "pose_r", "pose_q", "lm")
    return out


def _exchange(mesh) -> dict:
    """A cross-process sum and every payload exchange, each checked."""
    import torch

    from svin_tpu_torch import parallel as tpar

    rank = mesh.rank
    total = mesh.psum(torch.arange(2.0) + 2.0 * rank)  # ranks hold [0,1] and [2,3]
    assert total.tolist() == [2.0, 4.0], total
    view = torch.arange(4.0).view(2, 2)
    row = mesh.psum(view[1])  # a view: summed in a copy, the base untouched
    assert row.tolist() == [4.0, 6.0] and view.tolist() == [[0.0, 1.0], [2.0, 3.0]], (row, view)
    ex = {"kf_index": 100 + rank, "timestamp": float(rank), "T_WC_r": np.zeros(3),
          "T_WC_q": np.array([0, 0, 0, 1.0]), "points_W": np.zeros((2, 3), np.float32),
          "descriptors": np.full((2, 8), rank, np.uint32)}
    got = tpar.exchange_keyframe_payloads([tpar.pack_keyframe(ex, cap=4)], cap=4, max_per_round=2)
    assert sorted(int(g["kf_index"]) for g in got) == [100, 101], got
    assert [int(g["descriptors"][0, 0]) for g in got] == [0, 1], got
    edges = np.array([[rank, rank + 1, 0, 0, 0, 0.1, 5.0]], np.float64)
    all_edges = tpar.exchange_loop_edges(edges, max_per_round=2)
    assert all_edges[:, 0].tolist() == [0.0, 1.0], all_edges
    pairs = tpar.exchange_shared_pairs(np.array([[0, rank, 1, rank]]), max_per_round=3)
    assert pairs.tolist() == [[0, 0, 1, 0], [0, 1, 1, 1]], pairs
    prob = tpar.GlobalMapProblem(
        pose_r=torch.full((2, 3), float(rank)), pose_q=torch.zeros(2, 4),
        pose_fixed=torch.zeros(2, dtype=torch.bool),
        lm=torch.zeros(3, 3), lm_valid=torch.ones(3, dtype=torch.bool), obs_uv=torch.zeros(4, 2),
        obs_pose=torch.zeros(4, dtype=torch.int64), obs_lm=torch.full((4,), rank),
        obs_cam=torch.zeros(4, dtype=torch.int64), obs_valid=torch.ones(4, dtype=torch.bool))
    sessions = tpar.exchange_session_problems(prob)
    assert [float(s.pose_r[0, 0]) for s in sessions] == [0.0, 1.0]
    assert [int(s.obs_lm[0]) for s in sessions] == [0, 1]
    return {"ok": np.asarray(True)}


def _mapping(mesh) -> dict:
    """The JAX test's cooperative mapping (K=8, L_window=32, 10 GN x 32 CG)
    with its assertions on every rank (rank 1: the drift removed), then
    ``dryrun_multichip`` over the same group."""
    from svin_tpu_torch.apps.run_distributed_mapping import run
    from svin_tpu_torch.entry import dryrun_multichip

    s = run(K=8, L_window=32, iters=10, cg_iters=32, device="cpu")
    assert s["merged_poses"] == 16 and s["shared_pairs"] >= 8, s
    if s["rank"] == 1:  # the joint solve removed the injected drift
        assert s["injected_drift_m"] > 0.05, s
        assert s["residual_drift_m"] < 0.3 * s["injected_drift_m"], s
    out = {f"mapping.{k}": np.asarray(v) for k, v in s.items()}
    out.update({f"dryrun.{k}": np.asarray(v)
                for k, v in dryrun_multichip(mesh.size, device="cpu").items()})
    return out


def _card(mesh) -> dict:
    """The sharded bucketed BA on the card at K=64 (D=384, the cluster
    kernel), float32, 10 GN steps from 5 cm perturbed poses: the cluster
    kernel's launches, and the poses' distance to the local solve's."""
    import torch

    from svin_tpu_torch import parallel as tpar
    from svin_tpu_torch import problems
    from svin_tpu_torch.ops import solve

    torch.backends.cuda.matmul.allow_tf32 = False
    K = 64
    prob, rig = problems.build_global_ba_problem(np.random.default_rng(3), K=K, device=mesh.device)
    dp = torch.as_tensor(np.random.default_rng(4).normal(0, 0.05, (K, 3)), dtype=torch.float32,
                         device=mesh.device)
    bp = tpar.bucket_problem(prob._replace(pose_r=prob.pose_r + dp * (~prob.pose_fixed)[:, None]))
    step, shard = tpar.make_sharded_ba_bucketed(mesh, rig, K, bp.lm.shape[0], iters=10)
    local = shard(bp)
    n0 = solve.spd_solve_cluster.launches
    got, _ = step(local)
    torch.cuda.synchronize()
    launches = solve.spd_solve_cluster.launches - n0
    want, _ = tpar.ba_solve_bucketed(bp, rig, iters=10)
    return {"launches": np.asarray(launches),
            "pose_diff": np.asarray(float((got.pose_r - want.pose_r).abs().max())),
            "truth_err": np.asarray(float((got.pose_r - prob.pose_r).abs().max()))}


def main(case: str, rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from svin_tpu_torch.parallel import initialize_distributed, make_process_mesh

    device = "cuda" if case == "card" else "cpu"
    initialize_distributed(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank,
                           backend="gloo", device=device)
    mesh = make_process_mesh(device=device)
    try:
        with np.load(os.path.join(workdir, "in.npz")) as f:
            data = {k: f[k] for k in f.files}
        out = {"solvers": lambda: _solvers(data, mesh), "exchange": lambda: _exchange(mesh),
               "mapping": lambda: _mapping(mesh), "card": lambda: _card(mesh)}[case]()
        np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "svin_tpu") for m in sys.modules)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
