"""Timestamps as int64 nanoseconds.

A copy of the JAX package's ``utils/timebase.py`` (which imports no JAX,
but any import of that package runs its ``__init__``, which does). The
nanosecond stamps of the frame synchronizer and the rosbag reader: plain
int64 ns, ordinary integer arithmetic.
"""
from __future__ import annotations

import time as _time

NS_PER_S = 1_000_000_000


def from_sec(t: float) -> int:
    return int(round(t * NS_PER_S))


def to_sec(t_ns: int) -> float:
    return t_ns / NS_PER_S


def from_sec_nsec(sec: int, nsec: int) -> int:
    return int(sec) * NS_PER_S + int(nsec)


def now() -> int:
    return _time.time_ns()
