"""Hierarchical named wall-clock profiler.

Replaces ``okvis::timing::Timer/Timing`` (reference:
``okvis_timing/include/okvis/timing/Timer.hpp:69-171``) and pose_graph's
``utils::Statistics``: named timers with mean/min/max/stddev and a rolling
window, a full-table printout, and a context-manager API. Device work should
additionally be profiled with a device profiler; this covers host-side stage
taxonomy ("2.1 detect_describe", "2.4 matching", "3.1 optimization", ...).

A copy of the JAX package's ``utils/timing.py`` without its ``jax.profiler``
wrapper: device work is profiled with ``torch.profiler``. A timer reads the
host clock; around device work it measures enqueue time unless the timed
block ends in a fetch or a synchronisation.

Set ``SVIN_DEACTIVATE_TIMERS=1`` to compile timers out (DummyTimer analog).
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional


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
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
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


class Timing:
    """Global registry of named timers (thread-safe)."""

    _lock = threading.Lock()
    _stats: Dict[str, _Stats] = {}

    @classmethod
    def add(cls, name: str, seconds: float) -> None:
        with cls._lock:
            cls._stats.setdefault(name, _Stats()).add(seconds)

    @classmethod
    def get(cls, name: str) -> Optional[_Stats]:
        return cls._stats.get(name)

    @classmethod
    def mean(cls, name: str) -> float:
        s = cls._stats.get(name)
        return s.mean if s else 0.0

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._stats.clear()

    @classmethod
    def summary(cls) -> Dict[str, dict]:
        """Every timer's count, mean ms and total s."""
        with cls._lock:
            return {name: {"n": s.count, "mean_ms": s.mean * 1e3, "total_s": s.total}
                    for name, s in sorted(cls._stats.items())}

    @classmethod
    def print_table(cls) -> str:
        lines = ["SVIn Timing", f"{'name':<42}{'n':>7}{'mean[ms]':>10}{'roll[ms]':>10}{'min[ms]':>10}{'max[ms]':>10}{'std[ms]':>10}"]
        for name in sorted(cls._stats):
            s = cls._stats[name]
            lines.append(
                f"{name:<42}{s.count:>7}{s.mean*1e3:>10.3f}{s.rolling_mean*1e3:>10.3f}"
                f"{s.vmin*1e3:>10.3f}{s.vmax*1e3:>10.3f}{s.std*1e3:>10.3f}"
            )
        return "\n".join(lines)


_DEACTIVATED = os.environ.get("SVIN_DEACTIVATE_TIMERS", "0") == "1"


class Timer:
    """Context-manager / start-stop timer feeding the global Timing registry."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str, start: bool = False):
        self.name = name
        self._t0 = time.perf_counter() if start else None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is None or _DEACTIVATED:
            self._t0 = None
            return 0.0
        dt = time.perf_counter() - self._t0
        self._t0 = None
        Timing.add(self.name, dt)
        return dt

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def device_profile_summary(prof, wall: float, top: int = 0) -> dict:
    """A finished ``torch.profiler`` window of ``wall`` seconds: the
    device-busy share (the union of the device operations' intervals over
    the wall time, which the profiler's own host cost lengthens), the summed
    device ms, the number of device operations, and the ``top`` operation
    names by device ms as (name, ms, count)."""
    import torch

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
