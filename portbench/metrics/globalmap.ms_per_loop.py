"""``GlobalMap.update_after_loop`` per loop: the benchmark's span around the
refresh after each accepted loop, mean over the window's loops (those
outside a profiled stretch), in ms."""


def read(run):
    s = run.spans.by_name.get("globalmap.update_after_loop", [])
    return 1e3 * sum(b - a for a, b in s) / len(s) if s else None
