"""The Cave-length full-system run through the port's CLI, on the card.

The counterpart of ``tools/cave_run.py``: the reference's Cave sequence is
1,519 poses, and this tool drives about as many keyframes through the real
``VioEngine -> LoopCloser`` chain of ``svin_tpu_torch.apps.run_synchronous``
in two sessions. Session A renders 680 s of the revisiting synthetic
sequence and saves a checkpoint; session B resumes it (``--resume``) for
340 s as a new sequence, so its loops are verified against the restored
map and the pose graph re-anchors through them. The rig is the JAX tool's
(the gauntlet's two 200x150 cameras, sonar and depth, loop closure on);
the closer passes its 512-node switch to the scalable solver in session A.

Held to the JAX tool's bounds: at least 1,400 keyframes over both sessions
at full length (A's keyframes plus B's new ones), and per session VIO
Sim(3)-ATE < 1.5 m and loop ATE < 1.0 m. The resumed session must restore
A's keyframes.

Writes one JSON record (``--out``, by default
``artifacts/CAVE_RUN_torch.json``): per session frames per second over the
session's wall time, ``add_frame`` ms and ``add_keyframe`` ms (median,
p90) below and past 512 nodes, loops and their edge error against the
simulator's truth, the closer's funnel and pose-graph solves, VIO and loop
ATE (the resumed session's new keyframes also alone), the loops that tie
session B to the restored map, and the launches of each kernel. Exits
non-zero past a bound, and without a card unless ``--device cpu``.

Usage:
  python3 tools/cave_run_torch.py [--duration-a S] [--duration-b S]
      [--device cuda|cpu] [--out PATH] [--work DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
for p in (REPO, TOOLS):
    if p not in sys.path:
        sys.path.insert(0, p)

import gauntlet_torch as g  # noqa: E402

# the JAX tool's rig: the gauntlet's without the health gate
CONFIG_YAML = ("%YAML:1.0\ncameras:\n" + g.CAM0 + g.CAM1 + g.COMMON + g.SONAR_DEPTH + g.LOOP)
FULL_A, FULL_B = 680.0, 340.0
MIN_KEYFRAMES = 1400  # at full length
# the first of 8 frames traced by torch.profiler on the card, as a share of
# the session's frames: session A's past its 512th keyframe (~0.6 keyframes
# per frame), session B's (all past 512) mid-way
PROFILE_A, PROFILE_B = 0.85, 0.5
CAMERA_RATE = 3  # Hz, the rig's
VIO_ATE_M, LOOP_ATE_M = 1.5, 1.0


def loop_edge_errors(stats: dict) -> dict:
    """Each accepted loop's relative translation against the simulator's
    truth, in the old keyframe's true camera frame (camera == body here)."""
    import torch

    from svin_tpu_torch import sim
    from svin_tpu_torch.kinematics import npq

    loops = stats.get("loops", [])
    if not loops:
        return {"n": 0}
    traj = sim.default_trajectory(scale=0.4, ramp_tau=0.8)
    traj = traj._replace(r_lin=traj.r_lin * 0.0)
    ti = sim.pose(traj, torch.as_tensor([lp["t_i"] for lp in loops], dtype=torch.float64))
    tj = sim.position(traj, torch.as_tensor([lp["t_j"] for lp in loops], dtype=torch.float64))
    err = []
    for k, lp in enumerate(loops):
        Ri = npq.to_rotation_matrix(ti.q[k].numpy())
        t_true = Ri.T @ (tj[k].numpy() - ti.r[k].numpy())
        err.append(float(np.linalg.norm(np.asarray(lp["rel_t"]) - t_true)))
    err = np.asarray(err)
    return {"n": int(len(err)), "median": float(np.median(err)),
            "p90": float(np.percentile(err, 90)), "max": float(err.max())}


def divergence(out_dir: str, name: str) -> dict:
    """How far ``<name>.txt`` strays: its SE(3)-aligned ATE (a Sim(3)
    alignment of a trajectory that ran away shrinks it to a point, and its
    ATE to the ground truth's own spread, ~0.38 m here), its largest
    position norm, and the first stamp past 10 m from the origin (the
    sequence stays within 1 m of it)."""
    import torch

    from svin_tpu_torch import sim
    from svin_tpu_torch.evaluation import ate_rmse

    rows = np.loadtxt(os.path.join(out_dir, f"{name}.txt"), ndmin=2)
    if len(rows) < 3:
        return {}
    traj = sim.default_trajectory(scale=0.4, ramp_tau=0.8)
    traj = traj._replace(r_lin=traj.r_lin * 0.0)
    gt = sim.position(traj, torch.as_tensor(rows[:, 0], dtype=torch.float64)).numpy()
    norm = np.linalg.norm(rows[:, 1:4], axis=1)
    far = np.nonzero(norm > 10.0)[0]
    return {"ate_se3_m": float(ate_rmse(rows[:, 1:4], gt, with_scale=False)[0]),
            "max_position_norm_m": float(norm.max()),
            "first_beyond_10m_s": float(rows[far[0], 0]) if len(far) else None}


def evaluate(out_dir: str) -> dict:
    """The session's closer record and trajectory errors."""
    from svin_tpu_torch.evaluation import ate_rmse

    stats = json.load(open(os.path.join(out_dir, "loop_stats.json")))
    n_restored = int(stats["n_restored"])
    out = {
        "closer_keyframes": int(stats["n_keyframes"]), "n_restored": n_restored,
        "loop_stats": stats["stats"], "n_loops": int(stats["n_loops"]),
        "pose_graph_solves": len(stats["pgo_log"]),
        "pose_graph_scalable_solves": sum(x["branch"] == "scalable" for x in stats["pgo_log"]),
        "pose_graph_last": stats["pgo_log"][-1] if stats["pgo_log"] else None,
        "loop_edge_error_m": loop_edge_errors(stats),
        # loops of this session that close against the restored map
        "loops_to_restored_map": sum(lp["i"] < n_restored <= lp["j"] for lp in stats["loops"]),
        "svin_vio": {**g.evaluate(out_dir, "svin_vio"), **divergence(out_dir, "svin_vio")},
        "svin_loop": {**g.evaluate(out_dir, "svin_loop"), **divergence(out_dir, "svin_loop")},
    }
    if 0 < n_restored < out["svin_loop"]["n_poses"]:
        rows = np.loadtxt(os.path.join(out_dir, "svin_loop.txt"), ndmin=2)[n_restored:]
        if len(rows) >= 3:
            import torch

            from svin_tpu_torch import sim

            traj = sim.default_trajectory(scale=0.4, ramp_tau=0.8)
            traj = traj._replace(r_lin=traj.r_lin * 0.0)
            gt = sim.position(traj, torch.as_tensor(rows[:, 0], dtype=torch.float64)).numpy()
            out["svin_loop"]["ate_new_session_m"] = float(ate_rmse(rows[:, 1:4], gt)[0])
        out["svin_loop"]["n_new_session"] = int(out["svin_loop"]["n_poses"] - n_restored)
    return out


def write(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {path}", flush=True)


def session(name, out_dir, duration, device, extra, profile) -> dict:
    env = {"SVIN_SYNTH_DURATION": str(duration), "SVIN_SYNTH_REVISIT": "1"}
    print(f"[cave] session {name}: {duration:.0f} s of sequence ...", flush=True)
    run = g.run_cli(CONFIG_YAML, env, out_dir, device, extra, profile=profile)
    if run["rc"] != 0:
        raise RuntimeError(f"cave session {name}: run_synchronous returned {run['rc']}")
    probe = run["probe"]
    m = evaluate(out_dir)
    frames = len(probe.steps)  # frames with a result
    m.update({"duration_s": duration, "frames": frames, "keyframe_exports": len(probe.kf_taken),
              "wall_s": run["wall_s"], "frames_per_s": frames / run["wall_s"],
              **probe.summary(), "launches": run["launches"], "stages": run["stages"]})
    print(f"[cave] session {name}: {frames} frames in {run['wall_s']:.1f} s "
          f"({m['frames_per_s']:.3f} frames/s); keyframes {m['closer_keyframes']} "
          f"(restored {m['n_restored']}); loops {m['n_loops']}, to the restored map "
          f"{m['loops_to_restored_map']}; ATE vio {m['svin_vio']['ate_m']:.4f} loop "
          f"{m['svin_loop']['ate_m']:.4f} m; add_keyframe ms below 512 "
          f"{m['add_keyframe_ms_below_512']}, past 512 {m['add_keyframe_ms_past_512']}; "
          f"launches {m['launches']}", flush=True)
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration-a", type=float, default=FULL_A)
    ap.add_argument("--duration-b", type=float, default=FULL_B)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts", "CAVE_RUN_torch.json"))
    ap.add_argument("--work", default=None,
                    help="keep the sessions' outputs here (default: a temporary directory)")
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the Cave run goes on the card (--device cpu "
                               "runs it on the CPU)")
        from svin_tpu_torch.ops import cuda_lib

        cuda_lib.load()  # build the kernels before the first timed frame
    full = args.duration_a >= FULL_A and args.duration_b >= FULL_B
    record = {
        "what": ("Cave-length full-system run through the port's run_synchronous: the real "
                 "VioEngine -> LoopCloser chain, two sessions with a checkpoint and a resume "
                 "between them, sonar and depth factors, loop closure and the global map on "
                 "(the counterpart of tools/cave_run.py)."),
        "tool": "tools/cave_run_torch.py",
        "device": args.device,
        "card": g.card() if args.device.startswith("cuda") else None,
        "dtype": "float32" if args.device.startswith("cuda") else "float64",
        "torch": torch.__version__,
        "full_length": full,
        "cut": None if full else {"duration_a_s": args.duration_a, "duration_b_s": args.duration_b,
                                  "full_a_s": FULL_A, "full_b_s": FULL_B},
    }
    with tempfile.TemporaryDirectory(prefix="cave_run_torch_") as scratch:
        work = args.work or scratch
        ckpt = os.path.join(scratch, "ckpt")
        a = session("A", os.path.join(work, "a"), args.duration_a, args.device,
                    ["--save-checkpoint", ckpt], (int(PROFILE_A * CAMERA_RATE * args.duration_a), 8))
        record["session_a"] = a
        write(args.out, record)  # session A's record stands if session B does not end
        b = session("B", os.path.join(work, "b"), args.duration_b, args.device, ["--resume", ckpt],
                    (int(PROFILE_B * CAMERA_RATE * args.duration_b), 8))
    new_b = b["svin_loop"].get("n_new_session", 0)
    record.update({
        "session_b_resumed": b,
        # distinct keyframes through the chain: A's and B's new ones
        "total_keyframes": a["closer_keyframes"] + new_b,
        # tools/cave_run.py's sum, which counts A's restored keyframes again in B
        "total_keyframes_jax_tool_sum": a["svin_loop"]["n_poses"] + b["svin_loop"]["n_poses"],
        "total_frames": a["frames"] + b["frames"],
    })
    total_kf = record["total_keyframes"]
    failed = []
    if b["n_restored"] != a["closer_keyframes"]:
        failed.append(f"resume restored {b['n_restored']} of {a['closer_keyframes']} keyframes")
    if full and total_kf < MIN_KEYFRAMES:
        failed.append(f"{total_kf} keyframes < {MIN_KEYFRAMES}")
    for name, m in (("A", a), ("B", b)):
        if not m["svin_vio"]["ate_m"] < VIO_ATE_M:
            failed.append(f"session {name}: VIO ATE {m['svin_vio']['ate_m']} m >= {VIO_ATE_M}")
        if not m["svin_loop"]["ate_m"] < LOOP_ATE_M:
            failed.append(f"session {name}: loop ATE {m['svin_loop']['ate_m']} m >= {LOOP_ATE_M}")
    record["bounds_failed"] = failed
    record["passed"] = not failed
    write(args.out, record)
    if failed:
        print("bounds not held:\n  " + "\n  ".join(failed))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
