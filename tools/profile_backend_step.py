#!/usr/bin/env python3
"""Where the time of the port's per-frame backend step goes, on the card.

    python3 tools/profile_backend_step.py

Builds one frame's problem at the shipped engine shapes (as chip_smoke.py
does), then:

1. times each stage of ``BackendStep`` (gate_match_all, optimize,
   marginalize_slot, the prune error) with the host clock around a
   synchronised call, median of 10;
2. traces 3 steps with ``torch.profiler`` (CPU + CUDA) and prints the
   device-busy share (summed kernel time over wall time), the kernel
   launches per step, and the top operators by host and by device time;
   the same for the step with the kernels' plain versions.

Needs one CUDA card; exits nonzero without one.
"""
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from svin_tpu_torch import problems  # noqa: E402
from svin_tpu_torch.estimator import marginalize_slot, optimize  # noqa: E402
from svin_tpu_torch.ops import hamming, solve  # noqa: E402
from svin_tpu_torch.pipeline import BackendStep, gate_match_all, reproj_px_err  # noqa: E402


def timed(fn, n=10):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def dev_time(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def trace(name, run, n_steps=3):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    on_device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = sum(dev_time(e) for e in on_device)
    kernels = sum(e.count for e in on_device)
    print(f"{name}: profiled {n_steps} steps: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms ({100 * dev_us / wall_us:.1f}%), device ops per step "
          f"{kernels / n_steps:.0f}")
    print(events.table(sort_by="self_cpu_time_total", row_limit=25, max_name_column_width=50))
    print(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=50))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_backend_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = chip_smoke.CFG
    c = chip_smoke.make_case(0, dev)
    w, f, rig, fr, victim = c["w"], c["f"], c["rig"], c["frame"], c["victim"]
    imu = problems.IMU_PARAMS
    step = BackendStep(rig, imu, cfg).to(dev)
    plain = BackendStep(rig, imu, cfg, solve=solve.solve_spd_plain,
                        matcher=hamming.match_descriptors_plain).to(dev)
    run = lambda: step(w, f, fr, cfg.max_iterations, victim)  # noqa: E731
    run_plain = lambda: plain(w, f, fr, cfg.max_iterations, victim)  # noqa: E731
    run()
    run_plain()
    res = optimize(w, f, rig, imu, cfg, n_iters=cfg.max_iterations)
    w2, f2 = marginalize_slot(res.window, f, victim, rig, imu, cfg)
    stages = {
        "step": run,
        "step (plain versions)": run_plain,
        "gate_match_all": lambda: gate_match_all(
            rig, fr.uv, fr.desc, fr.valid, w.hp_W, w.lm_valid, fr.lm_desc, fr.lm_cov,
            fr.T_WS_r, fr.T_WS_q, w.ext_r, w.ext_q, fr.sigma, fr.pos_var),
        "optimize": lambda: optimize(w, f, rig, imu, cfg, n_iters=cfg.max_iterations),
        "marginalize_slot": lambda: marginalize_slot(res.window, f, victim, rig, imu, cfg),
        "reproj_px_err": lambda: reproj_px_err(w2, f2, rig, cfg),
    }
    for name, fn in stages.items():
        print(f"stage {name}: {timed(fn):.2f} ms (median of 10)")

    trace("step", run)
    trace("step (plain versions)", run_plain)
    return 0


if __name__ == "__main__":
    sys.exit(main())
