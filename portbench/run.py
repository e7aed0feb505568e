"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

  python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell is a configuration (``configs/``, found
by the file ``BENCHMARK.json`` names) under a traffic mix
(``traffic/<name>.json``, read by the one generator, ``gen.py``), judged by
its limits (``limits/<cell>.json``); each per-layer metric is a reader of its
own (``metrics/<name>.py``, ``read(run)``). A later cell, mix or metric is
files and entries, not an edit.

One run: render the cell's sensor stream from ``--seed`` on the card, build
the engine and the loop closer with ``svin_tpu_torch.apps.run_synchronous.
build`` (float32 on the card), hand a prior map (``laps``, ``resume``) to
the closer, feed the warm-up frames, then feed frames through
``svin_tpu_torch.pipeline.run_events`` for ``--seconds`` of wall time, the
keyframe callback doing what ``run_synchronous.main`` does (the closer, the
global map, its refresh after each loop), with no output files; taps
(``record.py``) keep a sample of the window solve's, the matchers' and the
pose graphs' calls (dense and scalable). Then the reference
(``reference.py``) judges what the window returned. ``--trace 1`` profiles
a stretch of the window's frames and reports the per-layer metrics instead
of the end-to-end ones.

Exits 2, printing no result, without enough CUDA cards; 3 if JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# one host thread for the numerical libraries: steadier frame times
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import numpy as np  # noqa: E402

from . import gen, record, reference, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "svin_tpu")  # top-level module names
TRACE_FROM = 4  # window frames before the profiled stretch
TRACE_FRAMES = 10  # frames profiled in a --trace 1 run


class Run:
    """What a per-layer reader gets: the cell, its configuration, the
    window's frames, spans and program counters, and the trace summary."""

    def __init__(self, cell, cfg):
        self.cell, self.cfg = cell, cfg
        self.frames = 0
        self.window_s = 0.0
        self.keyframes = 0
        self.spans = tracing.Spans()
        self.counters = {}
        self.trace = None


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _load(root, rel):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def _reader(root, name):
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _solve_counters():
    from svin_tpu_torch.ops import solve

    return {"spd_solve_chol": solve.spd_solve_chol.launches,
            "spd_solve_cluster": solve.spd_solve_cluster.launches,
            "solve_spd_library": solve.solve_spd_library.launches}


def sensor_events(seq: gen.Sequence, SensorEvent):
    """Per frame: the events that precede it (IMU up to its stamp, then depth,
    sonar and primitive odometry at it) and the frame event, images as host
    uint8 arrays."""
    pre, frames = [], []
    ii = 0
    depth = dict(seq.depth)
    sonar = {t: (r, h) for t, r, h in seq.sonar}
    prim = dict(seq.primitive)
    n_imu = len(seq.imu_t)
    for k, t in enumerate(seq.frame_t):
        evs = []
        while ii < n_imu and seq.imu_t[ii] <= t + 1e-9:
            evs.append(SensorEvent(t=float(seq.imu_t[ii]), kind="imu",
                                   imu=(seq.imu_gyro[ii], seq.imu_acc[ii])))
            ii += 1
        t = float(t)
        if t in depth:
            evs.append(SensorEvent(t=t, kind="depth", depth=depth[t]))
        if t in sonar:
            evs.append(SensorEvent(t=t, kind="sonar", sonar=sonar[t]))
        if t in prim:
            evs.append(SensorEvent(t=t, kind="primitive", primitive=prim[t]))
        img = seq.images[seq.frame_img[k]]
        pre.append(evs)
        frames.append(SensorEvent(t=t, kind="frame", images=[img[c] for c in range(img.shape[0])]))
    return pre, frames


def main(argv=None, root=".", device=None, patch=None) -> int:
    """One run; ``device`` and ``patch(engine, closer)`` are for the tests
    (a CPU run, a planted fault or a control), which skip the look for a
    card."""
    args = parse(sys.argv[1:] if argv is None else argv)
    bench = _load(root, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg_path = os.path.join(root, cfg_entry["file"])
    cfg_json = _load(root, cfg_entry["file"])
    traffic = _load(root, os.path.join("portbench", "traffic", cell["traffic"] + ".json"))
    limits = _load(root, os.path.join("portbench", "limits", cell["name"] + ".json"))

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    torch.set_num_threads(1)
    cuda = torch.device(device).type == "cuda"
    power = _power_limit() if cuda else "n/a"

    from svin_tpu_torch.apps.run_synchronous import build
    from svin_tpu_torch.kinematics import Transformation
    from svin_tpu_torch.loopclosure import GlobalMap
    from svin_tpu_torch.pipeline import SensorEvent, load_config, run_events

    # ---------------------------------------------------------- set-up
    phases = {"imports": time.perf_counter() - T_START}
    rig = gen.load_rig(cfg_json)
    seq = gen.make_sequence(rig, traffic, args.seed, device=device)
    pre, frame_ev = sensor_events(seq, SensorEvent)
    phases["render"] = time.perf_counter() - T_START
    cfg = load_config(cfg_path)
    engine, closer = build(cfg, device)
    if patch is not None:
        patch(engine, closer)
    taps = record.Taps(engine, closer, args.seed)  # a tap on the pose graph's module too
    gmap = GlobalMap(min_quality=cfg.global_map.min_landmark_quality)
    run = Run(cell, cfg_json)
    spans = run.spans
    in_window = [False]
    kf_key = {}
    loops = []
    first_loop = []  # the session's first loop's query keyframe, warm-up included

    def on_kf(export):
        idx = len(closer.keyframes)
        with spans.span("closer.add_keyframe"):
            loop = closer.add_keyframe(export)
        entered = len(closer.keyframes) > idx
        if entered:
            kf_key[idx] = export["kf_index"]
        T = Transformation(r=np.asarray(export["T_WC_r"]), q=np.asarray(export["T_WC_q"]))
        with spans.span("globalmap.add_observations"):
            gmap.add_observations(export["kf_index"], T, export["landmark_ids"],
                                  export["points_W"], export["quality"])
        if in_window[0]:
            run.keyframes += entered
        if loop is None:
            return
        if not first_loop:
            first_loop.append(loop.query_index)
        if in_window[0]:
            loops.append((loop.query_index, loop.match_index, np.asarray(loop.rel_t),
                          float(loop.rel_yaw)))
        corrected = {kf_key[k]: T_c for k, T_c in closer.corrected_keyframe_poses().items()
                     if k in kf_key}
        with spans.span("globalmap.update_after_loop"):
            gmap.update_after_loop(corrected)

    engine.keyframe_callback = on_kf
    # a mix with "prior_query": false hands its prior over as a saved
    # session's map loads: keyframes, database rows and pose graph, with no
    # query and no verification, so the load closes no loop
    lc_cfg = closer.cfg.loop_closure
    lc_enable = lc_cfg.enable
    if not traffic.get("prior_query", True):
        lc_cfg.enable = False
    for ex in seq.prior:
        closer.add_keyframe(ex)
    lc_cfg.enable = lc_enable
    n_prior = len(closer.keyframes)
    phases["prior"] = time.perf_counter() - T_START
    if seq.prior:
        engine.sequence = closer.sequence_cnt + 1  # a new session, as --resume starts one

    n_frames = len(frame_ev)
    frame_s = []
    trace = {"prof": None}

    def feed(k0, k1, deadline=None):
        """The events of frames k0..k1-1; in the window, each frame's time
        from its first sensor event to ``add_frame``'s return, and the stop
        at ``deadline`` seconds."""
        t_prev = t_now = time.perf_counter()
        for k in range(k0, k1):
            if deadline is not None:
                j = k - k0
                if args.trace and j == TRACE_FROM:
                    trace["prof"] = _profiler(torch, cuda)
                    trace["prof"].start()
                    spans.annotate = True
            with spans.span("feed"):
                for ev in pre[k]:
                    if ev.kind == "primitive":
                        closer.add_primitive_pose(ev.t, Transformation(
                            r=np.asarray(ev.primitive[0]), q=np.asarray(ev.primitive[1])))
                        continue
                    yield ev
            with spans.span("engine.add_frame"):
                yield frame_ev[k]
            t_now = time.perf_counter()
            if deadline is None:
                continue
            frame_s.append(t_now - t_prev)
            t_prev = t_now
            if trace["prof"] is not None and spans.annotate and j == TRACE_FROM + TRACE_FRAMES - 1:
                if cuda:
                    torch.cuda.synchronize()
                trace["prof"].stop()
                spans.annotate = False
            if t_now - t_w0 >= deadline:
                return
        if deadline is not None:
            print(f"portbench: the sequence's {n_frames} frames ran out {t_now - t_w0:.3f} s "
                  f"into the window", file=sys.stderr)

    n_warm = int(traffic["warmup_frames"])
    run_events(engine, feed(0, n_warm))
    if cuda:
        torch.cuda.synchronize()
    for v in spans.by_name.values():
        v.clear()
    before = _solve_counters()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kf_before, log_before = len(closer.keyframes), len(closer.pgo_log)
    stats_before = dict(closer.stats)
    gc.collect()
    gc.freeze()  # the set-up's objects out of the collector's scans in the window

    # ---------------------------------------------------------- window
    in_window[0] = taps.on = True
    t_w0 = time.perf_counter()
    setup_s = t_w0 - T_START
    results = run_events(engine, feed(n_warm, n_frames, deadline=args.seconds))
    if cuda:
        torch.cuda.synchronize()
    t_w1 = time.perf_counter()
    in_window[0] = taps.on = False
    gc.unfreeze()
    if spans.annotate:  # the window ended inside the profiled stretch
        trace["prof"].stop()
        spans.annotate = False
    attempted = len(frame_s)
    run.frames, run.window_s = len(results), t_w1 - t_w0
    after = _solve_counters()
    run.counters = {k: after[k] - before[k] for k in after}
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    if trace["prof"] is not None:
        run.trace = tracing.summarize(trace["prof"], len(spans.profiled["engine.add_frame"]))

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        taps.remove()
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3

    # ------------------------------------------------------- reference
    t_ref = time.perf_counter()
    numbers = {}
    if results:
        t = np.array([r.timestamp for r in results])
        p = np.stack([np.asarray(r.T_WS.r, float) for r in results])
        q = np.stack([np.asarray(r.T_WS.q, float) for r in results])
        numbers.update(reference.engine_numbers(seq, t, p, q))
    kept = taps.collect()
    taps.remove()
    numbers.update(reference.solve_numbers(kept["solves"]))
    numbers.update(reference.match_numbers(kept["matches"] + kept["verify_matches"]))
    if not kept["matches"]:
        numbers["match_diff"] = float("inf")
    if seq.prior:
        corrected = {k: (np.asarray(T.r), np.asarray(T.q))
                     for k, T in closer.corrected_keyframe_poses().items() if k >= n_prior}
        kf_times = {k: closer.keyframes[k].timestamp for k in range(len(closer.keyframes))}
        numbers.update(reference.loop_numbers(seq, loops, kf_times, corrected, n_prior,
                                              run.keyframes, first_loop))
        numbers.update(reference.pose_graph_numbers(kept["pose_graphs"]) if kept["pose_graphs"]
                       else {"pg_dp_m": float("inf")})
        if kept["pose_graphs_pcg"]:  # none kept: a limit on these numbers reads nan and fails
            numbers.update(reference.pcg_numbers(kept["pose_graphs_pcg"]))
    else:
        numbers["loops"] = float(len(loops))
    correct, checks = reference.judge(numbers, limits)
    t_ref = time.perf_counter() - t_ref

    # ---------------------------------------------------------- result
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            v = _reader(root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {
            "frames_per_s": len(results) / run.window_s,
            "frame_ms_p95": float(np.percentile(np.asarray(frame_s) * 1e3, 95)),
            "setup_s": setup_s,
        }
        for m in bench["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak, "power_limit": power}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": attempted - len(results), "metrics": metrics, "device": dev}
    if run.trace:
        dev.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    print(f"portbench: {args.workload} seed {args.seed}: {len(results)} frames in "
          f"{run.window_s:.3f} s, {run.keyframes} keyframes, {len(loops)} loops, "
          f"set-up {setup_s:.3f} s (cumulative: {phases}), {n_prior} prior keyframes, "
          f"{kf_before} keyframes before the window, "
          f"{sum(e['branch'] == 'scalable' for e in closer.pgo_log[log_before:])} scalable "
          f"pose-graph updates in it, reference {t_ref:.3f} s, counters {run.counters}, "
          f"closer {({k: v - stats_before.get(k, 0) for k, v in dict(closer.stats).items()})}",
          file=sys.stderr)
    for name in sorted(set(numbers) - set(checks)):
        print(f"reading {name} {numbers[name]!r} (not compared)", file=sys.stderr)
    for name, (v, op, lim) in checks.items():
        print(f"check {name} {v!r} {op} {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


def _profiler(torch, cuda):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


if __name__ == "__main__":
    raise SystemExit(main())
