"""The closer's verification (the program's ``lc.4 verify`` spans) per
candidate verified (the closer's ``candidates`` counter), over the window's
frames (those outside a profiled stretch), in ms."""
from portbench import programspans


def read(run):
    w = programspans.window(run)
    if w is None:
        return None
    n = w.counted("lc.candidates")
    return 1e3 * sum(w.seconds("lc.4 verify")) / n if n else None
