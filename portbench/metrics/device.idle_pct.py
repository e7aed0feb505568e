"""The share (%) of the traced frames' wall time with no kernel, copy or set
on the card, from the ``torch.profiler`` trace."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or not t["ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
