"""``LoopCloser.add_keyframe`` per keyframe: the benchmark's span around the
call inside the keyframe callback, mean over the window's keyframes (those
outside a profiled stretch), in ms."""


def read(run):
    s = run.spans.by_name.get("closer.add_keyframe", [])
    return 1e3 * sum(b - a for a, b in s) / len(s) if s else None
