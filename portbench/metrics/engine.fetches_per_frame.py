"""The engine's fetches (the program's ``fetch`` counter, one per
``convert.to_numpy_tree`` call: a host wait on the card) per frame, less
those of the keyframe callback, over the window's frames (those outside a
profiled stretch)."""
from portbench import programspans


def read(run):
    w = programspans.window(run)
    if w is None or not w.by_name.get("2.0 frame_total"):
        return None
    return w.counted("fetch", outside="3.3 kf_callback") / w.n
