"""The engine's own time per frame: the benchmark's ``add_frame`` spans less
the keyframe callback's spans inside them (the closer and the global map),
mean over the window's frames (those outside a profiled stretch), in ms."""


def read(run):
    frames = len(run.spans.by_name.get("engine.add_frame", ()))
    if not frames:
        return None
    cb = sum(run.spans.total(n) for n in (
        "closer.add_keyframe", "globalmap.add_observations", "globalmap.update_after_loop"))
    return 1e3 * (run.spans.total("engine.add_frame") - cb) / frames
