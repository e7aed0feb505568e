"""The engine's time under no stage span: each ``2.0 frame_total`` span
less the union of its direct children, mean over the window's frames (those
outside a profiled stretch), in ms."""
from portbench import programspans


def read(run):
    w = programspans.window(run)
    if w is None or not w.by_name.get("2.0 frame_total"):
        return None
    return 1e3 * sum(w.self_seconds("2.0 frame_total")) / w.n
