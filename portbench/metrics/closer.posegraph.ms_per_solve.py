"""The closer's pose-graph solve (the program's ``lc.5 pose_graph`` spans),
mean per solve over the window's frames (those outside a profiled stretch),
in ms."""
from portbench import programspans


def read(run):
    w = programspans.window(run)
    if w is None or not w.by_name.get("lc.5 pose_graph"):
        return None
    s = w.seconds("lc.5 pose_graph")
    return 1e3 * sum(s) / len(s)
