"""Device time of the operations launched inside the engine's ``3.1
optimization`` spans (upload, the LM program, its fetch, the write-back),
per traced frame, from the ``torch.profiler`` trace, in ms."""
from portbench import programspans


def read(run):
    if not run.trace or not run.trace["ops"]:
        return None
    d = programspans.device(run)
    if not d or "3.1 optimization" not in d["host_s"]:
        return None
    return 1e3 * d["device_s"].get("3.1 optimization", 0.0) / run.trace["frames"]
