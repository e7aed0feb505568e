"""The program's own spans and counters (``svin_tpu_torch.utils.timing``),
read for the per-layer metrics.

The benchmark's spans sit around its calls into the program (``tracing.py``);
the program keeps spans of its own stages, with parent and frame ids, and
stamped counters, in a store of its own. Two readings:

- ``window(run)``: the program's spans and counter increments that lie inside
  the window's unprofiled ``engine.add_frame`` spans (``Run.spans.by_name``;
  both on the ``time.perf_counter`` clock), per frame on the host clock;
- ``device(run)``: the profiled stretch's ``torch.profiler`` trace, in which
  each program span is a range named ``svin.<name>``. Each device operation
  goes under the innermost program range whose host interval holds the
  runtime call that launched it (kineto's correlation id, the runtime call's
  and its operation's alike; the launching operator's, by
  ``linked_correlation_id``, where the runtime call is missing), and each
  idle gap of the card under the innermost range, the program's or the
  benchmark's, open at its midpoint on the benchmark's thread.

The trace's events are the run's profiler's: ``Run`` carries the trace's
summary, not its events, so ``device`` takes them from the one finished
``torch.profiler.profile`` the process holds.

A program without the store (one older than its spans) reads ``None``, and
so does a window or trace with nothing of the program in it: the readers
then report nothing.
"""
from __future__ import annotations

import gc
from collections import defaultdict

import numpy as np

from . import tracing

PROGRAM = "svin."  # the program's profiler ranges
# runtime calls after which the host waits on the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D")
OUTSIDE = "between frames"  # an idle gap under no range


class Window:
    """The program's spans and counts inside the window's unprofiled frames
    (``frames``: the benchmark's ``engine.add_frame`` intervals, s)."""

    def __init__(self, frames, spans, counts):
        fr = np.asarray(sorted(frames), dtype=np.float64).reshape(-1, 2)
        self.n = len(fr)
        a = np.round(fr[:, 0] * 1e9).astype(np.int64)
        b = np.round(fr[:, 1] * 1e9).astype(np.int64)
        self._a, self._b = a, b
        self.spans = [s for s in spans if self._inside(s.start_ns, s.end_ns)]
        self.counts = [c for c in counts if self._inside(c.t_ns, c.t_ns)]
        self.by_name = defaultdict(list)
        for s in self.spans:
            self.by_name[s.name].append(s)

    def _inside(self, t0, t1) -> bool:
        k = int(np.searchsorted(self._a, t0, side="right")) - 1
        return k >= 0 and t1 <= self._b[k]

    def seconds(self, name: str) -> list:
        return [(s.end_ns - s.start_ns) * 1e-9 for s in self.by_name.get(name, ())]

    def self_seconds(self, name: str) -> list:
        """Each span of ``name``: its seconds less the union of its direct
        children's."""
        kids = defaultdict(list)
        for s in self.spans:
            kids[s.parent].append((s.start_ns, s.end_ns))
        out = []
        for s in self.by_name.get(name, ()):
            covered = sum(b - a for a, b in tracing._union(
                (max(a, s.start_ns), min(b, s.end_ns)) for a, b in kids.get(s.id, ())))
            out.append((s.end_ns - s.start_ns - covered) * 1e-9)
        return out

    def counted(self, name: str, outside: str = None) -> int:
        """The counter ``name``'s increments, less those inside spans named
        ``outside``."""
        skip = sorted((s.start_ns, s.end_ns) for s in self.by_name.get(outside, ()))
        n = 0
        for c in self.counts:
            if c.name == name and not any(a <= c.t_ns <= b for a, b in skip):
                n += c.n
        return n


def window(run):
    """The program's store over the window's unprofiled frames, or None."""
    try:
        from svin_tpu_torch.utils import timing
    except ImportError:
        return None
    frames = run.spans.by_name.get("engine.add_frame", [])
    if not frames or not hasattr(timing, "records"):
        return None
    w = Window(frames, timing.records(), timing.count_records())
    return w if w.spans else None


def ms_per_frame(run, name: str):
    """Mean ms a window frame in spans named ``name``; None without any."""
    w = window(run)
    if w is None or not w.by_name.get(name):
        return None
    return 1e3 * sum(w.seconds(name)) / w.n


# ------------------------------------------------------------- the trace
def _profiles():
    """The process's finished ``torch.profiler.profile`` objects."""
    import torch.profiler

    return [o for o in gc.get_objects() if issubclass(type(o), torch.profiler.profile)
            and getattr(getattr(o, "profiler", None), "kineto_results", None) is not None]


def device(run):
    """``stages`` of the run's trace (the finished profiler whose trace holds
    the benchmark's ranges), or None without one."""
    if not run.trace:
        return None
    for prof in _profiles():
        st = stages(prof.profiler.kineto_results.events())
        if st is not None:
            return st
    return None


def _thread(e) -> int:
    f = getattr(e, "start_thread_id", None)
    return int(f()) if f is not None else 0


def _tree(ranges):
    """Properly nested ranges of one thread, (start, end, ...): each one's
    parent index (-1 for a root) and the innermost range over time, as
    segment starts ``xs`` and their range index ``labs`` (-1: none)."""
    order = sorted(range(len(ranges)), key=lambda i: (ranges[i][0], -ranges[i][1]))
    parent = [-1] * len(ranges)
    xs, labs, stack = [], [], []
    for i in order:
        a = ranges[i][0]
        while stack and ranges[stack[-1]][1] <= a:
            j = stack.pop()
            xs.append(ranges[j][1])
            labs.append(stack[-1] if stack else -1)
        parent[i] = stack[-1] if stack else -1
        xs.append(a)
        labs.append(i)
        stack.append(i)
    while stack:
        j = stack.pop()
        xs.append(ranges[j][1])
        labs.append(stack[-1] if stack else -1)
    xs = np.maximum.accumulate(np.asarray(xs, dtype=np.int64)) if xs else np.zeros(0, np.int64)
    return parent, xs, np.asarray(labs, dtype=np.int64)


def _innermost(tree, ts):
    _, xs, labs = tree
    if not len(xs):
        return np.full(len(ts), -1, np.int64)
    k = np.searchsorted(xs, np.asarray(ts, dtype=np.int64), side="right") - 1
    return np.where(k >= 0, labs[np.maximum(k, 0)], -1)


def stages(events) -> dict:
    """Per span name, over a trace's events: ``host_s`` (the program's
    ranges' seconds) and ``calls``; ``device_s`` and ``ops`` (the device
    operations launched inside the range or a range under it, the
    benchmark's ranges around the program's included; ``device_self_s``
    those launched directly in a program range); ``syncs`` (synchronizing
    runtime calls by the innermost range; ``sync_sites`` by the range and
    the operator that made them); ``idle_s`` (the card's idle gaps,
    as ``tracing.summarize`` finds them, by the innermost range, the
    program's or the benchmark's, open at each one's midpoint) and
    ``program_idle_s``, their seconds under a program range;
    ``unattributed_s``, device seconds launched under no program range.
    None without the benchmark's ranges."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ranges = defaultdict(list)  # thread -> [(start, end, name, program?)]
    launch, op_start, op_name, dev, syncs = {}, {}, {}, [], []
    for e in events:
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if not name.startswith((PROGRAM, tracing.PREFIX)):  # as summarize's
                dev.append((a, b, e.correlation_id(), e.linked_correlation_id()))
            continue
        th = _thread(e)
        if name.startswith(PROGRAM):
            ranges[th].append((a, b, name[len(PROGRAM):], True))
        elif name.startswith(tracing.PREFIX):
            ranges[th].append((a, b, name[len(tracing.PREFIX):], False))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = (a, th)
            if name in SYNC_CALLS:
                syncs.append((a, th, e.linked_correlation_id()))
        else:
            op_start[e.correlation_id()] = (a, th)
            op_name[e.correlation_id()] = name
    bench = [(th, r) for th, rs in ranges.items() for r in rs if not r[3]]
    if not bench:
        return None
    trees = {th: _tree(rs) for th, rs in ranges.items()}
    # each range's names, itself and up, once each
    names = {}
    for th, rs in ranges.items():
        parent = trees[th][0]
        order = sorted(range(len(rs)), key=lambda i: (rs[i][0], -rs[i][1]))
        anc = [()] * len(rs)
        for i in order:
            up = anc[parent[i]] if parent[i] >= 0 else ()
            anc[i] = up if rs[i][2] in up else (rs[i][2],) + up
        names[th] = anc

    def by_thread(points):
        """(time, thread) points → {thread: (indices, times)}."""
        out = defaultdict(lambda: ([], []))
        for k, (t, th) in enumerate(points):
            out[th][0].append(k)
            out[th][1].append(t)
        return out

    # device operations under the range that launched them
    host = [launch.get(c) or op_start.get(lk) or (None, None) for _, _, c, lk in dev]
    dur = np.asarray([b - a for a, b, _, _ in dev], dtype=np.int64) * 1e-9
    device_s, device_self_s, ops = defaultdict(float), defaultdict(float), defaultdict(int)
    unattributed = 0.0
    pts = by_thread([(t, th) for t, th in host if t is not None])
    idx = [k for k, (t, _) in enumerate(host) if t is not None]
    unattributed += float(dur.sum() - dur[idx].sum()) if idx else float(dur.sum())
    for th, (ks, ts) in pts.items():
        if th not in trees:
            unattributed += float(dur[[idx[k] for k in ks]].sum())
            continue
        lab = _innermost(trees[th], ts)
        for k, i in zip(ks, lab):
            d = dur[idx[k]]
            if i < 0 or not ranges[th][i][3]:
                unattributed += d
                continue
            device_self_s[ranges[th][i][2]] += d
            for n in names[th][i]:
                device_s[n] += d
                ops[n] += 1
    # synchronizing runtime calls by the innermost range, and by the range
    # and the operator that made them
    sync_by, sync_sites = defaultdict(int), defaultdict(int)
    for th, (ks, ts) in by_thread([(t, th) for t, th, _ in syncs]).items():
        lab = _innermost(trees[th], ts) if th in trees else [-1] * len(ts)
        for k, i in zip(ks, lab):
            where = ranges[th][i][2] if i >= 0 else OUTSIDE
            sync_by[where] += 1
            sync_sites[f"{where} / {op_name.get(syncs[k][2], '-')}"] += 1
    # the idle gaps, as summarize finds them, by the innermost range
    th0 = bench[0][0]
    w0 = min(r[0] for _, r in bench)
    w1 = max(r[1] for _, r in bench)
    busy = tracing._union([(max(a, w0), min(b, w1)) for a, b, _, _ in dev if b > w0 and a < w1])
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle_s = defaultdict(float)
    if gaps:
        g = np.asarray(gaps, dtype=np.int64)
        lab = _innermost(trees[th0], (g[:, 0] + g[:, 1]) // 2)
        for (a, b), i in zip(gaps, lab):
            idle_s[ranges[th0][i][2] if i >= 0 else OUTSIDE] += (b - a) * 1e-9
    host_s, calls = defaultdict(float), defaultdict(int)
    for rs in ranges.values():
        for a, b, n, prog in rs:
            if prog:
                host_s[n] += (b - a) * 1e-9
                calls[n] += 1
    return {"host_s": dict(host_s), "calls": dict(calls), "device_s": dict(device_s),
            "device_self_s": dict(device_self_s), "ops": dict(ops), "syncs": dict(sync_by),
            "sync_sites": dict(sync_sites),
            "idle_s": dict(idle_s), "unattributed_s": unattributed,
            "program_idle_s": sum(s for n, s in idle_s.items() if n in host_s)}
