#!/usr/bin/env python3
"""Where the time of the port's serial ``add_frame`` goes, on the card.

    python3 tools/profile_engine.py

Feeds ``chip_smoke.py``'s engine input (underwater configuration, two
800x600 cameras, 29 frames at 10 Hz, float32) to the port's ``VioEngine``
on CUDA with the kernels, then:

1. program times: each device program the engine calls (IMU propagation,
   preprocess + detect + describe, map matching + RANSAC, stereo,
   temporal, the optimize program, a standalone marginalization), timed
   on the host clock from a synchronize before the call to a synchronize
   after it, summed per frame, median over frames 4-29 (frames 1-3 fill
   the window);
2. a ``torch.profiler`` trace (CPU + CUDA) of frames 21-25: device-busy
   share (summed kernel time over wall time), device operations per frame,
   and the top operators by host and by device time.

Needs one CUDA card; exits nonzero without one.
"""
import collections
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from svin_tpu_torch.pipeline import VioEngine, programs, run_events, vio  # noqa: E402

PROGRAMS = ("preint_prop", "frontend_batch", "match_stage", "stereo_match_tri",
            "temporal_match_tri", "opt_program")


def instrument(totals):
    """Wrap each device program so every call adds its synchronized wall
    time to ``totals[name]``."""
    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    for name in PROGRAMS:
        fn = getattr(programs, name)
        if name == "opt_program":
            setattr(programs, name, lambda *a, _f=fn, **k: timed("opt_program", _f(*a, **k)))
        else:
            setattr(programs, name, timed(name, fn))
    vio.marginalize_slot = timed("marginalize_slot", vio.marginalize_slot)


def split_at_frame(events, n):
    """(events up to and including frame n, the rest)."""
    seen = 0
    for i, ev in enumerate(events):
        seen += ev.kind == "frame"
        if seen == n:
            return events[:i + 1], events[i + 1:]
    return events, []


def dev_time(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg, events, _ = chip_smoke.engine_input(dev)

    # 1. program times per frame
    totals = collections.defaultdict(float)
    instrument(totals)
    rows = []
    engine = chip_smoke.TimedEngine(VioEngine(cfg, device=dev))
    timed_add_frame = engine.add_frame

    def add_frame(t, images):  # closes a row of program times per frame
        r = timed_add_frame(t, images)
        rows.append(dict(totals))
        totals.clear()
        return r

    engine.add_frame = add_frame
    run_events(engine, events)
    walls, n = engine.frame_ms, len(rows)
    keep = rows[3:]
    print(f"add_frame, frames 4-{n}: median {statistics.median(walls[3:]):.2f} ms (synchronized "
          "around every program)")
    for name in PROGRAMS + ("marginalize_slot",):
        vals = [r.get(name, 0.0) for r in keep]
        print(f"  {name:<20} median {statistics.median(vals):8.2f} ms/frame, "
              f"called on {sum(v > 0 for v in vals)} of {len(vals)} frames")
    other = [w - sum(r.values()) for w, r in zip(walls[3:], keep)]
    print(f"  {'host bookkeeping':<20} median {statistics.median(other):8.2f} ms/frame (the rest)")

    # 2. profiler trace of frames 21-25 on a fresh engine (uninstrumented
    # programs would differ only by the synchronizes)
    engine = VioEngine(cfg, device=dev)
    warm, rest = split_at_frame(events, 20)
    run_events(engine, warm)
    window, _ = split_at_frame(rest, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_events(engine, window)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    ev = prof.key_averages()
    on_device = [e for e in ev if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = sum(dev_time(e) for e in on_device)
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    print(f"profiled frames 21-25: wall {wall_us / 1e3:.1f} ms, device busy {dev_us / 1e3:.1f} ms "
          f"({100 * dev_us / wall_us:.1f}%), device ops per frame "
          f"{sum(e.count for e in on_device) / 5:.0f}, cudaLaunchKernel per frame {launches / 5:.0f}")
    print(ev.table(sort_by="self_cpu_time_total", row_limit=25, max_name_column_width=50))
    print(ev.table(sort_by="self_device_time_total", row_limit=20, max_name_column_width=50))
    return 0


if __name__ == "__main__":
    sys.exit(main())
