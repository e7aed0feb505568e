"""Live-mode runner: a dataset replayed at wall-clock rate (or a multiple)
through the threaded pipeline, sensor events → ``AsyncVioEngine``
(synchronizer, bounded drop-oldest queues, IMU gate) → keyframe exports →
``AsyncLoopCloser``. Frames the pipeline cannot keep up with are dropped;
the printout reports the drops.

Usage:
  python -m svin_tpu_torch.apps.run_live <config.yaml> <euroc_dir>|<rosbag2>|--synthetic \\
      [out_dir] [--speed X] [--device cuda|cpu]   # X=1 real time, 2 = 2x, 0 = no pacing

Writes ``svin_vio.txt`` and ``svin_loop.txt``. Runs on ``cuda`` unless given
``--device cpu``.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    config_path, data = argv[0], argv[1]
    speed, device = 1.0, "cuda"
    rest = []
    i = 2
    while i < len(argv):
        a = argv[i]
        if a in ("--speed", "--device"):
            if a == "--speed":
                speed = float(argv[i + 1])
            else:
                device = argv[i + 1]
            i += 2
        elif a.startswith("--speed="):
            speed = float(a.split("=", 1)[1])
            i += 1
        else:
            rest.append(a)
            i += 1
    out_dir = rest[0] if rest else "svin_live_out"
    os.makedirs(out_dir, exist_ok=True)

    from ..pipeline import events_from_source, load_config
    from ..pipeline.async_vio import AsyncLoopCloser, AsyncVioEngine
    from ..utils import Timing
    from .run_synchronous import build

    cfg = load_config(config_path)
    engine, closer = build(cfg, device)
    # bounded loop-closure intake depth
    acl = AsyncLoopCloser(closer, queue_size=max(1, cfg.loop_closure.keyframe_queue), blocking=False)
    live = AsyncVioEngine(engine, blocking=False)
    live.keyframe_callback = acl.add_keyframe
    n_results = [0]
    live.state_callback = lambda r: n_results.__setitem__(0, n_results[0] + 1)

    events = events_from_source(data, cfg, engine.rig)
    if data == "--synthetic":
        events = list(events)  # render before the clock starts

    t_first = None
    t0_wall = time.perf_counter()
    n_frames = 0
    for ev in events:
        if t_first is None:
            t_first = ev.t
        if speed > 0:
            lag = (ev.t - t_first) / speed - (time.perf_counter() - t0_wall)
            if lag > 0:
                time.sleep(lag)
        if ev.kind == "imu":
            live.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "frame":
            n_frames += 1
            for ci, img in enumerate(ev.images):
                live.add_image(ev.t, ci, np.asarray(img))
        elif ev.kind == "depth":
            live.add_depth_measurement(ev.t, ev.depth)
        elif ev.kind == "sonar":
            live.add_sonar_measurement(ev.t, *ev.sonar)

    live.finish()
    acl.finish()
    wall = time.perf_counter() - t0_wall
    engine.save_trajectory_tum(os.path.join(out_dir, "svin_vio.txt"))
    closer.save_trajectory_tum(os.path.join(out_dir, "svin_loop.txt"))
    print(f"live replay: {n_frames} frames in {wall:.1f}s wall ({n_results[0]} processed, "
          f"{live.dropped_frames} frames dropped, {acl.dropped_keyframes} keyframes dropped, "
          f"{len(closer.loops)} loops)  outputs in {out_dir}/")
    print(Timing.print_table())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
