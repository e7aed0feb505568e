"""Entry points of the port.

``entry()``: the flagship step, the sliding-window LM + Schur optimizer at
the engine's shipped window shapes (S = 8 states, 512 landmark slots of
which 256 are live, 4096 observation slots, 5 LM iterations), as
``VioEngine`` builds them (``pipeline/vio.py``).

    step, (window, factors) = entry()
    r, cost = step(window, factors)

``dryrun_multichip(n)``: inside a ``torch.distributed`` group of ``n``
processes, one step of every sharded solver on tiny shapes and the
cooperative-mapping chain, on each rank's device.

Counterparts of the JAX package's ``__graft_entry__.py``; problems come
from the port's builders seeded from numpy (the JAX builders draw from
``jax.random``).
"""
from __future__ import annotations

import numpy as np
import torch

from .estimator import WindowConfig, optimize
from .problems import IMU_PARAMS, build_window_problem


def entry(device=None):
    """(step, (window, factors)): ``step(window, factors)`` runs the LM loop
    and returns (window.r, cost). On ``cuda`` unless another device is named
    (raises without a card); float32 on the card, float64 elsewhere."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device; pass device='cpu'")
    cfg = WindowConfig(num_states=8, num_landmarks=512, num_obs=4096, max_iterations=5)
    window, factors, rig_p, _ = build_window_problem(
        np.random.default_rng(0), cfg, n_landmarks=256,
        dtype=torch.float32 if dev.type == "cuda" else torch.float64, device=dev)

    def step(window, factors):
        res = optimize(window, factors, rig_p, IMU_PARAMS, cfg)
        return res.window.r, res.cost

    return step, (window, factors)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of each sharded solver over the process mesh, in the JAX
    dry run's order: bucketed BA, the dense pose graph, PCG BA and the PCG
    pose graph, the track solver, the 6-DoF PCG pose graph (local), and the
    cooperative-mapping chain. Call it on every rank of an initialized
    group of ``n_devices`` processes (``parallel.initialize_distributed``);
    ``device`` as ``parallel.make_process_mesh`` takes it. Raises on a
    non-finite result; returns each section's cost."""
    import math

    from . import sim
    from .apps.run_distributed_mapping import run as coop_run
    from .cameras import project
    from .convert import tree_to
    from .estimator import rig_params
    from .kinematics import Transformation, compose, inverse, transform_point
    from .loopclosure import PoseGraph6Edges, PoseGraph6Nodes, PoseGraphEdges, PoseGraphNodes
    from .parallel import (GlobalMapProblem, bucket_problem, make_process_mesh,
                           make_sharded_ba_bucketed, make_sharded_ba_pcg, make_sharded_ba_tracks,
                           make_sharded_posegraph, make_sharded_posegraph_pcg, optimize_6dof_pcg,
                           pad_edges_for_mesh, tracks_from_problem)
    from .problems import build_global_ba_tracks, euroc_like_rig

    mesh = make_process_mesh(device=device)
    if mesh.size != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}): the process group has {mesh.size} ranks")
    dev = mesh.device
    costs = {}

    def finite(name, cost):
        if not bool(torch.isfinite(cost).all()):
            raise AssertionError(f"dryrun_multichip: {name} non-finite")
        costs[name] = float(cost)

    # tiny global BA: K poses, L landmarks (a multiple of the mesh), every
    # valid observation
    rig = euroc_like_rig(device=dev)
    rig_p = rig_params(rig, torch.float32, dev)
    K = 4
    L = -(-max(8, n_devices) * 2 // n_devices) * n_devices
    T = sim.pose(sim.default_trajectory(device=dev),
                 torch.arange(K, dtype=torch.float64, device=dev) * 0.4 + 0.2)
    lms = sim.landmark_grid(np.random.default_rng(0), L,
                            torch.tensor([0.5, 0.5, 5.0], dtype=torch.float64, device=dev),
                            torch.tensor([8.0, 8.0, 3.0], dtype=torch.float64, device=dev))
    obs = []
    for pi in range(K):
        for ci in range(rig.num_cameras):
            T_WC = compose(Transformation(r=T.r[pi], q=T.q[pi]), rig.T_SC[ci])
            uv, ok = project(tree_to(rig.cameras[ci], dev, torch.float32),
                             transform_point(inverse(T_WC), lms).to(torch.float32))
            li = torch.nonzero(ok)[:, 0]
            obs.append((torch.full_like(li, pi), li, torch.full_like(li, ci), uv[li]))
    pi, li, ci, uv = (torch.cat(x) for x in zip(*obs))
    f32 = torch.float32
    prob = GlobalMapProblem(
        pose_r=T.r.to(f32), pose_q=T.q.to(f32), pose_fixed=torch.arange(K, device=dev) < 2,
        lm=lms.to(f32), lm_valid=torch.ones(L, dtype=torch.bool, device=dev), obs_uv=uv,
        obs_pose=pi, obs_lm=li, obs_cam=ci, obs_valid=torch.ones_like(li, dtype=torch.bool))
    bprob = bucket_problem(prob)
    step, shard = make_sharded_ba_bucketed(mesh, rig_p, K, L, iters=2)
    finite("bucketed BA", step(shard(bprob))[1])

    # the dense edge-sharded 4-DoF pose graph: a circle of 16 nodes
    Np = 16
    th = torch.arange(Np, dtype=f32, device=dev) * (2 * math.pi / Np)
    zero = torch.zeros(Np, dtype=f32, device=dev)
    every = torch.ones(Np, dtype=torch.bool, device=dev)
    nodes = PoseGraphNodes(p=torch.stack([torch.cos(th), torch.sin(th), zero], 1), yaw=th,
                           pitch=zero, roll=zero, valid=every)
    ii = torch.arange(Np, device=dev)
    t_ij = torch.zeros(Np, 3, dtype=f32, device=dev)
    t_ij[:, 0] = 0.4
    edges = PoseGraphEdges(i=ii, j=(ii + 1) % Np, t_ij=t_ij,
                           yaw_ij=torch.full((Np,), 2 * math.pi / Np, dtype=f32, device=dev),
                           weight=torch.ones(Np, dtype=f32, device=dev),
                           is_loop=~every, valid=every)
    edges_p = pad_edges_for_mesh(edges, n_devices)
    pg_step, pg_shard = make_sharded_posegraph(mesh, Np, edges_p.i.shape[0], iters=2)
    finite("dense pose graph", pg_step(nodes, pg_shard(edges_p), 1)[1])

    # the matrix-free PCG variants: the same shardings, the reduced solve by
    # two-level preconditioned CG
    step, shard = make_sharded_ba_pcg(mesh, rig_p, K, L, iters=1, cg_iters=8)
    finite("PCG BA", step(shard(bprob))[1])
    pg_step, pg_shard = make_sharded_posegraph_pcg(mesh, Np, edges_p.i.shape[0], iters=1,
                                                   cg_iters=8, coarse_group=4)
    finite("PCG pose graph", pg_step(nodes, pg_shard(edges_p), 1)[1])

    # the track-structured solver: landmark blocks sharded by track base
    tr_prob, tr_rig = build_global_ba_tracks(np.random.default_rng(2), K=16, L=16 * n_devices,
                                             span=4, revisit_frac=0.1, device=dev)
    tp, meta, _ = tracks_from_problem(tr_prob, span=4, block=8, n_shards=n_devices)
    step, shard = make_sharded_ba_tracks(mesh, tr_rig, meta, iters=1, cg_iters=8)
    finite("track BA", step(shard(tp))[1])

    # the SE(3) matrix-free pose graph (the 6-DoF mode's scalable branch),
    # with the loop closer's square-root information diag(20,20,20,100,100,57.3)
    q_id = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=f32, device=dev)
    W6 = torch.diag(torch.tensor([20.0, 20.0, 20.0, 100.0, 100.0, 57.3], dtype=f32, device=dev))
    out6 = optimize_6dof_pcg(
        PoseGraph6Nodes(r=nodes.p, q=q_id.repeat(Np, 1), valid=nodes.valid),
        PoseGraph6Edges(i=edges.i, j=edges.j, t_ij=edges.t_ij, q_ij=q_id.repeat(Np, 1),
                        sqrt_info=W6.expand(Np, 6, 6), valid=edges.valid),
        1, iters=1, cg_iters=8, coarse_group=4)
    finite("6-DoF PCG pose graph (largest |r|)", out6.r.abs().max())

    # the cooperative-mapping chain over this mesh
    s = coop_run(K=6, L_window=32, iters=2, cg_iters=8, device=dev)
    if not (s["merged_poses"] >= 6 and math.isfinite(s["joint_cost"])):
        raise AssertionError(f"dryrun_multichip: cooperative mapping {s}")
    costs["cooperative mapping"] = s["joint_cost"]
    return costs
