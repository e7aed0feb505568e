"""Multi-process cooperative mapping: the composed distributed flow.

Counterpart of the JAX package's ``apps/run_distributed_mapping.py``. The
reference's two-process topology (okvis_node → ROS topics →
pose_graph_node) generalizes to N mapping processes: each runs its own
session intake, exchanges keyframe payloads, associates shared landmarks by
descriptor matching (``ops.hamming.match_descriptors``: the fused-matcher
kernel on the card), merges the sessions and solves the joint bundle
adjustment sharded over the process mesh (one (K,6) ``all_reduce`` per CG
iteration).

Chain: initialize_distributed → make_process_mesh → session intake →
pack_keyframe / exchange_keyframe_payloads → descriptor association →
exchange_shared_pairs → exchange_session_problems → merge_sessions →
bucket_problem → make_sharded_ba_pcg solve → per-session trajectories.

In one process every exchange returns the local payloads. Under
``torchrun`` (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), or
given ``--coordinator`` (``tcp://host:port`` or ``file:///path``),
``--num-processes`` and ``--process-id``, each process is one rank:

    torchrun --nproc-per-node 2 -m svin_tpu_torch.apps.run_distributed_mapping out/ \\
        --backend gloo
    python -m svin_tpu_torch.apps.run_distributed_mapping out/ --device cpu --backend gloo \\
        --coordinator file:///tmp/rdv --num-processes 2 --process-id 0   # and 1

Runs on ``cuda`` with NCCL (one card per rank) unless given ``--device``
and ``--backend``; two ranks sharing one card take ``--backend gloo``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch


def build_session(rank: int, K: int = 12, L_window: int = 64, world_L: int = 160, seed: int = 7,
                  drift_step: float = 0.25, device=None):
    """One synthetic mapping session over a shared world.

    Every rank draws the same landmark world (numpy-seeded by ``seed``; the
    JAX package draws it from ``jax.random.PRNGKey(seed)``) with one binary
    descriptor per landmark; session ``rank`` observes a window of it (half
    overlapping its neighbours') from a trajectory segment, the whole
    session offset by an inter-session drift (rank > 0) that the joint solve
    must remove. Returns (``GlobalMapProblem`` in local landmark indices,
    float32, on ``device``; rig params; (L_window, 8) int32 descriptor words;
    the world index of each local landmark; the drift)."""
    from .. import sim
    from ..cameras import project
    from ..convert import tree_to
    from ..estimator.rig import rig_params
    from ..kinematics import Transformation, compose, inverse, transform_point
    from ..parallel import GlobalMapProblem
    from ..problems import euroc_like_rig

    dev = torch.device(device if device is not None else "cuda")
    rig = euroc_like_rig(device=dev)
    rig_p = rig_params(rig, torch.float32, dev)
    world_lms = sim.landmark_grid(np.random.default_rng(seed), world_L,
                                  torch.tensor([0.5, 0.5, 5.0], dtype=torch.float64, device=dev),
                                  torch.tensor([10.0, 10.0, 4.0], dtype=torch.float64, device=dev))
    world_desc = np.random.RandomState(seed).randint(0, 2**32, size=(world_L, 8)).astype(np.uint32)

    lo = (rank * (L_window // 2)) % max(world_L - L_window, 1)
    sel = np.arange(lo, lo + L_window)
    drift = np.array([0.3, -0.2, 0.15]) * drift_step * rank
    shift = torch.as_tensor(drift, device=dev)

    times = torch.arange(K, dtype=torch.float64, device=dev) * 0.3 + 0.2 + 0.15 * rank
    T = sim.pose(sim.default_trajectory(device=dev), times)
    pose_r, pose_q = T.r + shift, T.q
    lms = world_lms[torch.as_tensor(sel, device=dev)] + shift

    obs_uv, obs_pose, obs_lm, obs_cam = [], [], [], []
    for pi in range(K):
        for ci in range(rig.num_cameras):
            T_WC = compose(Transformation(r=pose_r[pi], q=pose_q[pi]), rig.T_SC[ci])
            p_C = transform_point(inverse(T_WC), lms)
            uv, ok = project(tree_to(rig.cameras[ci], dev), p_C)
            li = torch.nonzero(ok & (p_C[:, 2] > 0.5))[:, 0]
            obs_uv.append(uv[li])
            obs_lm.append(li)
            obs_pose.append(torch.full_like(li, pi))
            obs_cam.append(torch.full_like(li, ci))
    O = sum(len(x) for x in obs_lm)
    f32 = torch.float32
    prob = GlobalMapProblem(
        pose_r=pose_r.to(f32), pose_q=pose_q.to(f32), pose_fixed=torch.arange(K, device=dev) < 2,
        lm=lms.to(f32), lm_valid=torch.ones(L_window, dtype=torch.bool, device=dev),
        obs_uv=torch.cat(obs_uv).to(f32), obs_pose=torch.cat(obs_pose), obs_lm=torch.cat(obs_lm),
        obs_cam=torch.cat(obs_cam), obs_valid=torch.ones(O, dtype=torch.bool, device=dev))
    return prob, rig_p, world_desc[sel].view(np.int32), sel, drift


def _pad_obs(prob, O_cap: int):
    """The session's observation axis padded to ``O_cap`` invalid slots
    (the exchange needs equal shapes across processes)."""
    pad = O_cap - prob.obs_uv.shape[0]
    if pad < 0:
        raise ValueError(f"_pad_obs: {prob.obs_uv.shape[0]} observations exceed the cap {O_cap}")

    def padf(x):
        return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=x.device)])

    return prob._replace(obs_uv=padf(prob.obs_uv), obs_pose=padf(prob.obs_pose),
                         obs_lm=padf(prob.obs_lm), obs_cam=padf(prob.obs_cam),
                         obs_valid=padf(prob.obs_valid))


def run(out_dir: Optional[str] = None, coordinator: Optional[str] = None,
        num_processes: Optional[int] = None, process_id: Optional[int] = None, K: int = 12,
        L_window: int = 64, iters: int = 12, cg_iters: int = 48, backend: Optional[str] = None,
        device=None) -> dict:
    """The cooperative-mapping chain on this rank: a summary dict (and,
    given ``out_dir``, this session's TUM trajectory and summary there)."""
    from ..ops import hamming
    from ..parallel import (bucket_problem, exchange_keyframe_payloads, exchange_session_problems,
                            exchange_shared_pairs, initialize_distributed, make_process_mesh,
                            make_sharded_ba_pcg, merge_sessions, pack_keyframe)

    rank, nproc = initialize_distributed(coordinator, num_processes, process_id, backend, device)
    mesh = make_process_mesh(device=device)
    dev = mesh.device

    # ---- session intake
    prob, rig_p, lm_desc, _, drift = build_session(rank, K=K, L_window=L_window, device=dev)

    # ---- keyframe payload exchange (the keyframe topic's replacement)
    exports = [{"kf_index": rank * K + pi, "timestamp": float(pi), "T_WC_r": prob.pose_r[pi],
                "T_WC_q": prob.pose_q[pi], "points_W": prob.lm, "descriptors": lm_desc,
                "landmark_ids": np.arange(L_window)} for pi in range(min(2, K))]
    payloads = exchange_keyframe_payloads([pack_keyframe(e, L_window) for e in exports],
                                          cap=L_window, max_per_round=2)

    # ---- cross-session landmark association by descriptor matching
    pairs = set()
    my_desc = torch.from_numpy(lm_desc).to(dev)
    my_valid = torch.ones(L_window, dtype=torch.bool, device=dev)
    for p in payloads:
        src = int(p["kf_index"]) // K
        if src == rank:
            continue
        res = hamming.match_descriptors(
            my_desc, torch.from_numpy(p["descriptors"].view(np.int32)).to(dev), my_valid,
            torch.from_numpy(p["point_valid"]).to(dev), max_distance=10, mutual=True)
        ok, idx_b = res.valid.cpu().numpy(), res.idx_b.cpu().numpy()
        for la in np.nonzero(ok)[0]:
            lb = int(p["landmark_ids"][idx_b[la]])
            if lb < 0:
                continue
            sa, sb = sorted((rank, src))
            pa, pb = (int(la), lb) if sa == rank else (lb, int(la))
            pairs.add((sa, pa, sb, pb))
    shared_rows = exchange_shared_pairs(np.asarray(sorted(pairs), np.int64).reshape(-1, 4),
                                        max_per_round=4 * L_window)
    shared = sorted({tuple(int(x) for x in row) for row in shared_rows})

    # ---- session-problem exchange and merge
    sessions = exchange_session_problems(_pad_obs(prob, 4 * K * L_window))
    merged, pose_maps, _ = merge_sessions(sessions, shared, anchor=0)

    # ---- the joint solve, sharded over the process mesh
    bprob = bucket_problem(merged)
    Km, Lm = merged.pose_r.shape[0], bprob.lm.shape[0]
    pad = (-Lm) % mesh.size
    if pad:  # invalid landmark slots are inert
        bprob = bprob._replace(**{
            f: torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=x.device)])
            for f, x in bprob._asdict().items() if x.dim() >= 1 and x.shape[0] == Lm})
        Lm += pad
    step, shard = make_sharded_ba_pcg(mesh, rig_p, Km, Lm, iters=iters, cg_iters=cg_iters)
    out, cost = step(shard(bprob))
    out_r = out.pose_r.cpu().numpy()

    # the drift removed: this session's poses land on the anchor's trajectory
    my_rows = pose_maps[rank]
    residual = float(np.median(np.linalg.norm(out_r[my_rows] - (prob.pose_r.cpu().numpy() - drift),
                                              axis=1)))
    summary = {
        "rank": rank,
        "num_processes": nproc,
        "devices": mesh.size,
        "merged_poses": int(Km),
        "merged_landmarks": int(Lm),
        "shared_pairs": len(shared),
        "joint_cost": float(cost),
        "residual_drift_m": residual,
        "injected_drift_m": float(np.linalg.norm(drift)),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"session_{rank}.txt"), "w") as f:
            for k, row in enumerate(my_rows):
                x, y, z = out_r[row]
                f.write(f"{k:.6f} {x:.6f} {y:.6f} {z:.6f} 0 0 0 1\n")
        with open(os.path.join(out_dir, f"summary_{rank}.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="nccl (the default on cuda) or gloo")
    args = ap.parse_args(argv)
    summary = run(out_dir=args.out_dir, coordinator=args.coordinator,
                  num_processes=args.num_processes, process_id=args.process_id,
                  backend=args.backend, device=args.device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
