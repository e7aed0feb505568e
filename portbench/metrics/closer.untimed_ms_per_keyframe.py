"""The closer's time under no stage span: each ``lc.0 add_keyframe`` span
less the union of its direct children (``lc.1``-``lc.6``), mean over the
window's keyframes (those outside a profiled stretch), in ms."""
from portbench import programspans


def read(run):
    w = programspans.window(run)
    if w is None or not w.by_name.get("lc.0 add_keyframe"):
        return None
    s = w.self_seconds("lc.0 add_keyframe")
    return 1e3 * sum(s) / len(s)
