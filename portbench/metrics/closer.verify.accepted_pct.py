"""The share (%) of the closer's verified candidates that it accepted as
loops (its ``accepted`` over its ``candidates`` counter), over the window's
frames (those outside a profiled stretch)."""
from portbench import programspans


def read(run):
    w = programspans.window(run)
    if w is None:
        return None
    n = w.counted("lc.candidates")
    return 100.0 * w.counted("lc.accepted") / n if n else None
