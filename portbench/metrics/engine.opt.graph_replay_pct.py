"""The share of the engine's LM program calls (the program's ``3.1.1
opt_dispatch`` spans) that replayed CUDA graphs (the program's
``opt.graph_replay`` counter), over the window's frames (those outside a
profiled stretch), in %. Nothing where the program never captured a graph
(``opt.graph_capture``: a program without them, or a run on the CPU)."""
from portbench import programspans


def read(run):
    w = programspans.window(run)
    calls = w.by_name.get("3.1.1 opt_dispatch") if w is not None else None
    if not calls:
        return None
    from svin_tpu_torch.utils import timing

    if "opt.graph_capture" not in timing.counters():
        return None
    return 100.0 * w.counted("opt.graph_replay") / len(calls)
