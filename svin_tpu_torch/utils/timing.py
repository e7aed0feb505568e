"""The program's spans and counters, and its per-name timing tables.

Replaces ``okvis::timing::Timer/Timing`` (reference:
``okvis_timing/include/okvis/timing/Timer.hpp:69-171``) and pose_graph's
``utils::Statistics``; the stage names ("2.1 detect_describe", "2.4
matching", "3.1 optimization", "lc.4 verify", ...) are listed in PERF.md.

A span (``Timer``, a context manager or start/stop) is a named interval of
the host clock (``time.perf_counter_ns``) with

- its own id;
- its parent: the span open on the same thread when it started (a
  thread-local stack, so that a second thread's spans nest on their own);
- its frame: one id shared by every span of one engine call (``frame()``,
  opened by ``add_frame``, ``frontend_stage``, ``backend_step`` and
  ``backend_flush``; 0 outside any).

Closed spans go to one bounded store (``records()``, the newest
``MAX_RECORDS``) and to their name's aggregate (count, mean, min, max, std
and a rolling 50), which ``Timing`` reads for the apps' tables: ``Timing``
is a view of the store, not a registry of its own. A counter (``count``)
keeps a running total per name (``counters()``) and, like a span, a stamped
record of each increment (``count_records()``), so that a stretch of frames
can be counted after the fact; ``Counters`` is a dict whose increments are
such counts (``LoopCloser.stats``). The one counter of host waits on the
card is ``fetch`` (``convert.to_numpy_tree``).

One switch: ``enable(on)``. It starts on unless ``SVIN_DEACTIVATE_TIMERS=1``;
off, a span or a count costs one flag check and records nothing.

While a ``torch.profiler`` is recording, each span is also a profiler range
named ``svin.<name>``, on the trace's own clock, so that the device work
launched inside a span can be put under it by the launch's correlation id
(no clock offset to estimate), and ``device_trace``'s TensorBoard trace
carries the spans. The range is an operator-scope one (``_RecordFunctionFast``,
what an operator's dispatch opens): it adds no annotation to the device's
timeline, as a ``record_function`` range would (its GPU-side copy reads as
one more device operation to a reader of the trace).

A span reads the host clock: around device work it measures enqueue time
unless the block ends in a fetch or a synchronisation.
"""
from __future__ import annotations

import itertools
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch

PREFIX = "svin."  # profiler ranges of the spans
MAX_RECORDS = 1 << 16  # spans kept, and counter increments kept

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # pragma: no cover - a torch without it: no ranges
    _RecordFunctionFast = None


class Span(NamedTuple):
    id: int
    parent: int  # 0: a root on its thread
    frame: int  # 0: outside any engine call
    name: str
    start_ns: int
    end_ns: int
    thread: int


class Count(NamedTuple):
    name: str
    n: int
    t_ns: int
    parent: int  # the span open on the thread, 0 for none
    frame: int


@dataclass
class _Stats:
    count: int = 0
    total: float = 0.0
    total_sq: float = 0.0
    vmin: float = math.inf
    vmax: float = -math.inf
    window: deque = field(default_factory=lambda: deque(maxlen=50))

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.total_sq += v * v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self.window.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        m = self.mean
        return math.sqrt(max(0.0, self.total_sq / self.count - m * m))

    @property
    def rolling_mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0


# ------------------------------------------------------------------ store
_on = os.environ.get("SVIN_DEACTIVATE_TIMERS", "0") != "1"
_ids = itertools.count(1)  # span and frame ids (next() is atomic)
_lock = threading.Lock()
_spans: deque = deque(maxlen=MAX_RECORDS)
_counts: deque = deque(maxlen=MAX_RECORDS)
_stats: Dict[str, _Stats] = {}
_totals: Dict[str, int] = {}
_tls = threading.local()


def _thread():
    """This thread's open-span stack and frame id."""
    try:
        return _tls.stack, _tls
    except AttributeError:
        _tls.stack, _tls.frame = [], 0
        return _tls.stack, _tls


def enable(on: bool = True) -> None:
    """The one switch of spans and counters (default: on unless
    ``SVIN_DEACTIVATE_TIMERS=1``)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def records() -> List[Span]:
    """The kept spans, in the order they closed."""
    return list(_spans)


def count_records() -> List[Count]:
    """The kept counter increments, in order."""
    return list(_counts)


def counters() -> Dict[str, int]:
    """Every counter's running total."""
    with _lock:
        return dict(_totals)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, stamped with the time, the open
    span and the frame."""
    if not _on:
        return
    stack, tls = _thread()
    with _lock:
        _totals[name] = _totals.get(name, 0) + n
    _counts.append(Count(name, n, time.perf_counter_ns(), stack[-1] if stack else 0, tls.frame))


class Counters(dict):
    """A dict of counts whose every change is also a ``count`` of the
    difference under ``prefix + key``: ``d["x"] += 1`` counts ``prefix + "x"``."""

    def __init__(self, prefix: str, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.prefix = prefix

    def __setitem__(self, key, value) -> None:
        old = self.get(key, 0)
        super().__setitem__(key, value)
        if value != old:
            count(self.prefix + key, value - old)


class frame:
    """The scope of one engine call: spans opened inside it on this thread
    share one frame id. Nested scopes join the open one."""

    __slots__ = ("_own",)

    def __enter__(self) -> "frame":
        _, tls = _thread()
        self._own = _on and not tls.frame
        if self._own:
            tls.frame = next(_ids)
        return self

    def __exit__(self, *exc) -> None:
        if self._own:
            _tls.frame = 0


class Timing:
    """The per-name aggregates of the span store (thread-safe)."""

    @classmethod
    def add(cls, name: str, seconds: float) -> None:
        with _lock:
            st = _stats.get(name)
            if st is None:
                st = _stats[name] = _Stats()
            st.add(seconds)

    @classmethod
    def get(cls, name: str) -> Optional[_Stats]:
        return _stats.get(name)

    @classmethod
    def mean(cls, name: str) -> float:
        s = _stats.get(name)
        return s.mean if s else 0.0

    @classmethod
    def reset(cls) -> None:
        """Clear the store: aggregates, spans and counters."""
        with _lock:
            _stats.clear()
            _spans.clear()
            _counts.clear()
            _totals.clear()

    @classmethod
    def summary(cls) -> Dict[str, dict]:
        """Every timer's count, mean ms and total s."""
        with _lock:
            return {name: {"n": s.count, "mean_ms": s.mean * 1e3, "total_s": s.total}
                    for name, s in sorted(_stats.items())}

    @classmethod
    def print_table(cls) -> str:
        lines = ["SVIn Timing", f"{'name':<42}{'n':>7}{'mean[ms]':>10}{'roll[ms]':>10}{'min[ms]':>10}{'max[ms]':>10}{'std[ms]':>10}"]
        with _lock:
            items = sorted(_stats.items())
        for name, s in items:
            lines.append(
                f"{name:<42}{s.count:>7}{s.mean*1e3:>10.3f}{s.rolling_mean*1e3:>10.3f}"
                f"{s.vmin*1e3:>10.3f}{s.vmax*1e3:>10.3f}{s.std*1e3:>10.3f}"
            )
        return "\n".join(lines)


class Timer:
    """A span: a context manager, or ``start()`` / ``stop()`` on one thread."""

    __slots__ = ("name", "_t0", "_id", "_parent", "_frame", "_range")

    def __init__(self, name: str, start: bool = False):
        self.name = name
        self._t0 = None
        if start:
            self.start()

    def start(self) -> "Timer":
        if not _on:
            self._t0 = None
            return self
        stack, tls = _thread()
        self._parent = stack[-1] if stack else 0
        self._frame = tls.frame
        self._id = next(_ids)
        stack.append(self._id)
        self._range = None
        if _RecordFunctionFast is not None and torch.autograd._profiler_enabled():
            self._range = _RecordFunctionFast(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def stop(self) -> float:
        """Close the span; returns its seconds (0.0 when none was open)."""
        if self._t0 is None:
            return 0.0
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        stack, _ = _thread()
        if stack and stack[-1] == self._id:
            stack.pop()
        elif self._id in stack:
            stack.remove(self._id)
        t0, self._t0 = self._t0, None
        _spans.append(Span(self._id, self._parent, self._frame, self.name, t0, t1,
                           threading.get_ident()))
        dt = (t1 - t0) * 1e-9
        Timing.add(self.name, dt)
        return dt

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class device_trace:
    """Context manager wrapping ``torch.profiler`` for device-side kernel
    timing (the per-kernel complement of the host-side ``Timer``; the spans
    inside it are ranges of the trace, ``svin.<name>``):

        with device_trace("/tmp/svin_trace"):
            engine.add_frame(...)

    Writes a TensorBoard-loadable trace (``tensorboard_trace_handler``) of
    the host operations and, with a card, every kernel. A no-op, with a
    warning once, where the profiler cannot start."""

    _warned = False

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.log_dir))
            prof.start()
            self._prof = prof
        except Exception as e:  # pragma: no cover - backend-specific
            if not device_trace._warned:
                import logging

                logging.getLogger(__name__).warning(
                    "device profiler unavailable (%s); trace is a no-op", e)
                device_trace._warned = True
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            try:
                self._prof.stop()
            except Exception:  # pragma: no cover
                pass
            self._prof = None
        return False


def device_profile_summary(prof, wall: float, top: int = 0) -> dict:
    """A finished ``torch.profiler`` window of ``wall`` seconds: the
    device-busy share (the union of the device operations' intervals over
    the wall time, which the profiler's own host cost lengthens), the summed
    device ms, the number of device operations, and the ``top`` operation
    names by device ms as (name, ms, count)."""
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in on_card):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: Dict[str, list] = {}
    for e in on_card:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"busy": busy * 1e-6 / wall, "wall": wall,
            "ms": sum(e.time_range.elapsed_us() for e in on_card) / 1e3, "ops": len(on_card),
            "top": [(name[:60], round(ms, 3), n) for name, (ms, n) in ranked]}
