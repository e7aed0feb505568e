"""Offline synchronous runner: engine, loop closer and outputs.

Usage:
  python -m svin_tpu_torch.apps.run_synchronous <config.yaml> <dataset_dir> [out_dir]
  python -m svin_tpu_torch.apps.run_synchronous <config.yaml> <rosbag2_dir> [out_dir]
  python -m svin_tpu_torch.apps.run_synchronous <config.yaml> --synthetic [out_dir]
      [--save-checkpoint <prefix>] [--resume <prefix>] [--device cuda|cpu]

Reads a rig config, streams a EuRoC-format folder, a rosbag2 directory or
``.db3`` file (topics from SVIN_CAM_TOPICS / SVIN_IMU_TOPIC /
SVIN_DEPTH_TOPIC / SVIN_SONAR_TOPIC), or the rendered synthetic sequence
(SVIN_SYNTH_DURATION and the other SVIN_SYNTH_* settings) through
``VioEngine.add_frame`` with a ``LoopCloser`` on its keyframes, and writes
``svin_vio.txt``, ``svin_loop.txt``, ``svin_robust.txt`` (TUM),
``state.csv``, ``landmarks.csv``, ``global_map.ply``, ``keyframes.ply``,
``switch_info.txt``, ``loop_stats.json`` and ``top_view.png``.

``--save-checkpoint <prefix>`` writes ``<prefix>.engine.npz`` and
``<prefix>.loop.npz`` after the run; ``--resume <prefix>`` loads them
before it (files of either package) and starts a new sequence, so the pose
graph re-anchors through a cross-sequence loop instead of chaining a VIO
relative across the gap. Runs on ``cuda`` (float32) unless given
``--device cpu`` (float64).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np


def parse_args(argv):
    """(positional args, options): ``--resume``, ``--save-checkpoint``,
    ``--device``."""
    opts = {"--resume": None, "--save-checkpoint": None, "--device": "cuda"}
    pos = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            pos.append(a)
    return pos, opts


def build(cfg, device):
    """(engine, loop closer) on ``device``, the closer in the engine's precision."""
    from ..loopclosure import LoopCloser
    from ..pipeline import VioEngine

    engine = VioEngine(cfg, device=device)
    return engine, LoopCloser(engine.rig.cameras[0], cfg, device=engine.device, dtype=engine.dtype)


def main(argv=None, on_start=None) -> int:
    """Run the CLI on ``argv``; ``on_start(engine, closer)``, when given, is
    called once both are built (and restored) and before the first event,
    so a caller can time or count the run (``tools/gauntlet_torch.py``)."""
    argv = sys.argv[1:] if argv is None else argv
    argv, opts = parse_args(argv)
    if len(argv) < 2:
        print(__doc__)
        return 2
    config_path, data = argv[0], argv[1]
    out_dir = argv[2] if len(argv) > 2 else None

    from ..kinematics import Transformation
    from ..loopclosure import GlobalMap
    from ..pipeline import events_from_source, load_config, run_events
    from ..pipeline.outputs import CsvStateWriter, TopDownViewer
    from ..utils import Timing

    cfg = load_config(config_path)
    out_dir = out_dir or cfg.output_dir or "svin_out"
    os.makedirs(out_dir, exist_ok=True)
    engine, closer = build(cfg, opts["--device"])
    resume = opts["--resume"]
    if resume:
        from ..pipeline.checkpoint import load_engine, load_loop_closer

        if os.path.exists(resume + ".engine.npz"):
            load_engine(engine, resume + ".engine.npz")
        if os.path.exists(resume + ".loop.npz"):
            load_loop_closer(closer, resume + ".loop.npz")
        engine.sequence = closer.sequence_cnt + 1
    n_restored_kf = len(closer.keyframes)
    gmap = GlobalMap(min_quality=cfg.global_map.min_landmark_quality)
    n_loops = [0]
    dbg = None
    if cfg.debug_mode:
        from ..pipeline.outputs import DebugOutputDirs

        dbg = DebugOutputDirs(os.path.join(out_dir, "debug_output"))
        closer.debug = dbg  # stage images are written inside the closer

    kf_key = {}  # closer keyframe index -> global-map keyframe key

    def on_kf(export):
        idx = len(closer.keyframes)
        loop = closer.add_keyframe(export)
        if len(closer.keyframes) > idx:
            kf_key[idx] = export["kf_index"]
        T = Transformation(r=np.asarray(export["T_WC_r"]), q=np.asarray(export["T_WC_q"]))
        gmap.add_observations(export["kf_index"], T, export["landmark_ids"], export["points_W"],
                              export["quality"])
        if loop is None:
            return
        n_loops[0] += 1
        if dbg is not None:
            dbg.log_loop(loop.query_index, loop.match_index, loop.num_inliers, loop.rel_t,
                         loop.rel_yaw)
            kq = closer.keyframes[loop.query_index]
            km = closer.keyframes[loop.match_index]
            if kq.debug_image is not None and km.debug_image is not None and loop.uv_query is not None:
                from ..pipeline.outputs import draw_matches

                M = len(loop.uv_query)
                img = draw_matches(kq.debug_image, loop.uv_query, km.debug_image, loop.uv_match,
                                   np.stack([np.arange(M), np.arange(M)], 1))
                dbg.save_image(
                    "loop_closure", f"loop_closure_{loop.query_index}_{loop.match_index}", img,
                    caption=(f"current frame: {loop.query_index}  previous frame: "
                             f"{loop.match_index}  inliers {loop.num_inliers}"))
        # re-project the global map through the loop-corrected poses
        corrected = {kf_key[k]: T_c for k, T_c in closer.corrected_keyframe_poses().items()
                     if k in kf_key}
        gmap.update_after_loop(corrected)

    engine.keyframe_callback = on_kf
    state_csv = CsvStateWriter(os.path.join(out_dir, "state.csv"))
    viewer = TopDownViewer()

    def on_state(r):
        state_csv.write(r)
        viewer.add_result(r)

    engine.state_callback = on_state
    events = events_from_source(data, cfg, engine.rig)

    def route_primitive(evs):
        """Primitive odometry to the switching estimator, the rest to the engine."""
        for ev in evs:
            if ev.kind == "primitive":
                closer.add_primitive_pose(ev.t, Transformation(r=np.asarray(ev.primitive[0]),
                                                               q=np.asarray(ev.primitive[1])))
                continue
            yield ev

    if on_start is not None:
        on_start(engine, closer)
    results = run_events(engine, route_primitive(events))
    closer.flush()  # any deferred (fast-relocalized) optimization
    write_outputs(out_dir, engine, closer, gmap, viewer, n_restored_kf, n_loops[0])
    state_csv.close()
    if dbg is not None:
        dbg.close()
    if opts["--save-checkpoint"]:
        from ..pipeline.checkpoint import save_engine, save_loop_closer

        save_engine(engine, opts["--save-checkpoint"] + ".engine.npz")
        save_loop_closer(closer, opts["--save-checkpoint"] + ".loop.npz")
    print(f"frames: {len(results)}  keyframes: {len(closer.keyframes)}  loops: {n_loops[0]}  "
          f"outputs in {out_dir}/")
    print(Timing.print_table())
    return 0


def write_outputs(out_dir, engine, closer, gmap, viewer, n_restored_kf, n_loops) -> None:
    """The run's trajectories, map, logs and view."""
    from ..loopclosure import save_frustums_ply
    from ..pipeline.outputs import CsvLandmarkWriter

    engine.save_trajectory_tum(os.path.join(out_dir, "svin_vio.txt"))
    closer.save_trajectory_tum(os.path.join(out_dir, "svin_loop.txt"))
    gmap.save_ply(os.path.join(out_dir, "global_map.ply"))
    closer.save_switch_info(os.path.join(out_dir, "switch_info.txt"))
    with open(os.path.join(out_dir, "svin_robust.txt"), "w") as f:  # the switching estimator's
        for t, r, q in closer.robust_trajectory:
            f.write(f"{t:.6f} {r[0]:.6f} {r[1]:.6f} {r[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    lm_csv = CsvLandmarkWriter(os.path.join(out_dir, "landmarks.csv"))
    lv = np.asarray(engine.window.lm_valid)
    lm_csv.write_map(np.asarray(engine.window.lm_id)[lv], np.asarray(engine.window.hp_W[:, :3])[lv],
                     np.asarray(engine.window.lm_quality)[lv])
    lm_csv.close()
    viewer.save(os.path.join(out_dir, "top_view.png"))
    save_frustums_ply(os.path.join(out_dir, "keyframes.ply"), closer.corrected_keyframe_poses(),
                      [(lp.query_index, lp.match_index) for lp in closer.loops])
    # the funnel counters, the per-solve log and one record per accepted loop
    with open(os.path.join(out_dir, "loop_stats.json"), "w") as f:
        json.dump({
            "stats": closer.stats, "pgo_log": closer.pgo_log, "n_keyframes": len(closer.keyframes),
            "n_restored": n_restored_kf, "n_loops": n_loops,
            "earliest_loop_index": int(closer.earliest_loop_index),
            "loops": [{"i": lp.match_index, "j": lp.query_index,
                       "t_i": closer.keyframes[lp.match_index].timestamp,
                       "t_j": closer.keyframes[lp.query_index].timestamp,
                       "rel_t": [round(float(x), 5) for x in lp.rel_t],
                       "rel_yaw": round(float(lp.rel_yaw), 5), "inliers": int(lp.num_inliers)}
                      for lp in closer.loops],
        }, f, indent=1)


if __name__ == "__main__":
    raise SystemExit(main())
