"""The one-block SPD solve's share (%) of its roofline: the least time of a
D x D float32 solve (``roofline.spd_solve_bound``, D = 15 x the window's
states, from the configuration) over the kernel's traced device time per
launch. Nothing when the window took another route of ``solve_spd`` (the
cluster kernel or the library, by the program's launch counters) or the
trace holds no launch."""
from portbench import roofline

KERNEL = "spd_solve_chol"


def read(run):
    if run.counters.get("spd_solve_cluster") or run.counters.get("solve_spd_library"):
        return None
    t = run.trace
    if not t:
        return None
    names = [n for n in t["op_seconds"] if KERNEL in n]
    launches = sum(t["op_counts"][n] for n in names)
    if not launches:
        return None
    D = 15 * (int(run.cfg.get("numKeyframes", 5)) + int(run.cfg.get("numImuFrames", 3)))
    least_ms, _ = roofline.spd_solve_bound(D)
    per_launch_ms = 1e3 * sum(t["op_seconds"][n] for n in names) / launches
    return 100.0 * least_ms / per_launch_ms
