"""Device operations (kernels, copies, sets) in the trace per traced frame."""


def read(run):
    t = run.trace
    if not t or not t["ops"]:
        return None
    return t["ops"] / t["frames"]
