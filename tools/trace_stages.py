"""The engine's and the closer's frame, stage by stage, in one traced run of
a benchmark cell.

    python3 tools/trace_stages.py --workload euroc.transect --seed 1 \
        [--seconds 51] [--out STAGES_transect.json]

from the root of a checkout, on a card. Runs ``portbench.run`` with
``--trace 1`` in this process and prints its result line, then one row per
program span (``svin_tpu_torch.utils.timing``): host ms a frame over the
window's unprofiled frames (``portbench.programspans.window``), and over the
profiled frames the device ms of the operations launched inside it and
directly in it, the card's idle seconds under it, and the synchronizing
runtime calls whose innermost span it is (``programspans.stages``). Also the
share of the card's idle seconds under a program span, and the fetches and
the synchronizing runtime calls per frame.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out", default=None)
    p.add_argument("--root", default=".", help="the benchmark's checkout")
    p.add_argument("--device", default=None, help="e.g. cpu (default: a card)")
    args = p.parse_args(argv)

    from portbench import programspans, run

    kept = {}
    make_profiler, make_run = run._profiler, run.Run

    def profiler(*a):
        kept["prof"] = make_profiler(*a)
        return kept["prof"]

    class KeptRun(make_run):
        def __init__(self, *a):
            super().__init__(*a)
            kept["run"] = self

    run._profiler, run.Run = profiler, KeptRun
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"],
                      root=args.root, device=args.device)
    line = out.getvalue().strip().splitlines()[-1] if out.getvalue().strip() else "{}"
    print(line)
    if rc != 0 or "prof" not in kept:
        return rc or 1
    r = kept["run"]
    st = programspans.stages(kept["prof"].profiler.kineto_results.events())
    w = programspans.window(r)
    frames = r.trace["frames"]
    names = sorted(set(st["host_s"]) | set(w.by_name if w else ()))
    rows = []
    for n in names:
        host = 1e3 * sum(w.seconds(n)) / w.n if w and w.by_name.get(n) else 0.0
        rows.append({"span": n, "host_ms_per_frame": host,
                     "calls_per_frame": len(w.by_name.get(n, ())) / w.n if w else 0.0,
                     "device_ms_per_frame": 1e3 * st["device_s"].get(n, 0.0) / frames,
                     "device_self_ms_per_frame": 1e3 * st["device_self_s"].get(n, 0.0) / frames,
                     "ops_per_frame": st["ops"].get(n, 0) / frames,
                     "idle_s": st["idle_s"].get(n, 0.0),
                     "syncs_per_frame": st["syncs"].get(n, 0) / frames})
    idle_total = sum(st["idle_s"].values())
    summary = {
        "workload": args.workload, "seed": args.seed, "traced_frames": frames,
        "window_frames": w.n if w else 0,
        "idle_s": idle_total, "idle_under_program_s": st["program_idle_s"],
        "idle_by_label": st["idle_s"], "idle_by_benchmark_label": dict(r.trace["idle_gaps"]),
        "syncs_per_frame": sum(st["syncs"].values()) / frames,
        "sync_sites_per_frame": {k: v / frames for k, v in sorted(
            st["sync_sites"].items(), key=lambda kv: -kv[1])},
        "fetches_per_frame": (w.counted("fetch") / w.n) if w else None,
        "engine_fetches_per_frame": (w.counted("fetch", outside="3.3 kf_callback") / w.n
                                     if w else None),
        "unattributed_device_s": st["unattributed_s"],
        "root_self_ms_per_frame": (1e3 * sum(w.self_seconds("2.0 frame_total")) / w.n
                                   if w else None),
        "stages": rows, "result": json.loads(line),
    }
    print(f"{'span':<28}{'host ms':>10}{'calls':>7}{'dev ms':>9}{'dev self':>9}{'ops':>8}"
          f"{'idle s':>9}{'syncs':>7}")
    for x in rows:
        print(f"{x['span'][:28]:<28}{x['host_ms_per_frame']:>10.3f}{x['calls_per_frame']:>7.2f}"
              f"{x['device_ms_per_frame']:>9.3f}{x['device_self_ms_per_frame']:>9.3f}"
              f"{x['ops_per_frame']:>8.0f}{x['idle_s']:>9.4f}{x['syncs_per_frame']:>7.2f}")
    print(json.dumps({k: v for k, v in summary.items() if k not in ("stages", "result")}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
