"""The benchmark's spans and its reading of a ``torch.profiler`` trace.

Spans are taken by the benchmark around its calls into each layer (the
event feed, ``add_frame``, the keyframe callback's closer and global-map
calls) on the host clock, for every frame of the window. In a traced run the
same spans are also ``record_function`` annotations over the profiled
frames, so that the device's idle gaps can be labelled by the span the host
was in.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np

# innermost first: an idle gap is labelled by the innermost span open over it
SPAN_ORDER = ("globalmap.update_after_loop", "globalmap.add_observations",
              "closer.add_keyframe", "engine.add_frame", "feed")
PREFIX = "portbench."


class Spans:
    """Host-clock spans by name, kept in memory; ``annotate`` also marks
    them for the profiler while a trace is being taken, and keeps them out
    of ``by_name``, which the span readers read."""

    def __init__(self):
        self.by_name = defaultdict(list)  # name -> [(start, end)]
        # the spans of profiled frames, apart: the profiler slows them
        self.profiled = defaultdict(list)
        self.annotate = False

    @contextmanager
    def span(self, name: str):
        if self.annotate:
            import torch

            with torch.profiler.record_function(PREFIX + name):
                t0 = time.perf_counter()
                yield
                self.profiled[name].append((t0, time.perf_counter()))
        else:
            t0 = time.perf_counter()
            yield
            self.by_name[name].append((t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(b - a for a, b in self.by_name.get(name, ()))


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, frames: int) -> dict:
    """What a trace of ``frames`` frames says: the traced window (from the
    first annotated span's start to the last one's end), the device's busy
    seconds in it (union of kernels, copies and sets), its operations, the
    time of each operation by name, and the idle gaps' seconds by the
    innermost benchmark span open over each."""
    import torch

    events = prof.profiler.kineto_results.events()
    dev, spans = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.name().startswith(PREFIX):  # on the device timeline too, as annotations
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((a, b, e.name()[len(PREFIX):]))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((a, b, e.name()))
    if not spans:
        return {}
    w0, w1 = min(s[0] for s in spans), max(s[1] for s in spans)
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in dev if b > w0 and a < w1])
    busy_ns = sum(b - a for a, b in busy)
    by_op = defaultdict(float)
    for a, b, n in dev:
        by_op[n] += (b - a) * 1e-9
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    # each gap's label: the innermost span open at its midpoint
    names = list(SPAN_ORDER) + sorted({n for *_, n in spans} - set(SPAN_ORDER)) + ["between frames"]
    g = np.asarray(gaps, dtype=np.float64).reshape(-1, 2)
    mid = g.mean(1)
    label = np.full(len(g), len(names) - 1)
    for s0, s1, n in spans:
        inside = (mid >= s0) & (mid < s1)
        label[inside] = np.minimum(label[inside], names.index(n))
    per = np.zeros(len(names))
    np.add.at(per, label, (g[:, 1] - g[:, 0]) * 1e-9)
    idle = {names[i]: float(sec) for i, sec in enumerate(per) if sec > 0}
    top = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {
        "frames": frames, "window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
        "ops": len(dev), "op_seconds": dict(by_op), "op_counts": _counts(dev),
        "device_ops": [[n, s] for n, s in top[:10]],
        "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def _counts(dev) -> dict:
    c = defaultdict(int)
    for _, _, n in dev:
        c[n] += 1
    return dict(c)
