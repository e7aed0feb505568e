"""The closer's describe and detect stage (the program's ``lc.1
describe_detect`` spans) per keyframe handed to it (``lc.0 add_keyframe``),
over the window's frames (those outside a profiled stretch), in ms."""
from portbench import programspans


def read(run):
    w = programspans.window(run)
    if w is None or not w.by_name.get("lc.0 add_keyframe"):
        return None
    return 1e3 * sum(w.seconds("lc.1 describe_detect")) / len(w.by_name["lc.0 add_keyframe"])
