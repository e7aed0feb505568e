"""The host-runtime primitives of the asynchronous engine, in Python.

Counterparts of the JAX package's ``native.py`` (ctypes bindings over
``_native/core.cpp``) with the same names, signatures and semantics:
a bounded MPMC queue with blocking and drop-oldest backpressure, a
condition-variable gate on sensor timestamps, a time-indexed buffer with
windowed eviction and nearest queries, and a multi-camera frame
synchronizer that evicts stale partial groups. Here they are
``threading.Condition`` + ``collections.deque``: none of them sits on a
device path, and ``Condition.wait`` releases the GIL as the call into the
native library does, so a second native build beside the CUDA one buys
nothing.
"""
from __future__ import annotations

import bisect
import collections
import threading
from typing import Any, List, Optional, Tuple


class ThreadSafeQueue:
    """Bounded MPMC queue with blocking / drop-oldest backpressure."""

    def __init__(self, capacity: int = 16):
        self._capacity = capacity
        self._items: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._shutdown = False
        self._dropped = 0

    def push_blocking(self, obj: Any) -> bool:
        """Waits for space; False if the queue is shut down."""
        with self._cv:
            self._cv.wait_for(lambda: len(self._items) < self._capacity or self._shutdown)
            if self._shutdown:
                return False
            self._items.append(obj)
            self._cv.notify_all()
            return True

    def push_dropping(self, obj: Any) -> Optional[Any]:
        """Never waits: when full, drops the oldest item and returns it, else
        None (also None, with ``obj`` not queued, after shutdown)."""
        with self._cv:
            if self._shutdown:
                return None
            dropped = None
            if len(self._items) >= self._capacity and self._items:
                dropped = self._items.popleft()
                self._dropped += 1
            self._items.append(obj)
            self._cv.notify_all()
            return dropped

    def pop_blocking(self) -> Optional[Any]:
        """The oldest item; None once the queue is shut down and drained."""
        with self._cv:
            self._cv.wait_for(lambda: self._items or self._shutdown)
            if not self._items:
                return None
            obj = self._items.popleft()
            self._cv.notify_all()
            return obj

    def pop_timeout(self, timeout_s: float) -> Optional[Any]:
        """As ``pop_blocking``, or None after ``timeout_s`` seconds."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._items or self._shutdown,
                                     timeout=int(timeout_s * 1e6) * 1e-6):
                return None
            if not self._items:
                return None
            obj = self._items.popleft()
            self._cv.notify_all()
            return obj

    def shutdown(self) -> None:
        """Wake every waiter: pushes fail from now on, pops drain what is
        queued and then return None."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def size(self) -> int:
        with self._cv:
            return len(self._items)

    @property
    def dropped_count(self) -> int:
        with self._cv:
            return self._dropped


class ImuGate:
    """Condition-variable gate: wait until sensor data with a timestamp at
    or past ``t_ns`` has been announced."""

    def __init__(self):
        self._latest = -(2**63)
        self._shutdown = False
        self._cv = threading.Condition()

    def announce(self, t_ns: int) -> None:
        with self._cv:
            if t_ns > self._latest:
                self._latest = t_ns
            self._cv.notify_all()

    def wait_for(self, t_ns: int, timeout_s: float = 5.0) -> bool:
        """True once data at ``t_ns`` has arrived; False on a timeout or after
        shutdown."""
        with self._cv:
            got = self._cv.wait_for(lambda: self._latest >= t_ns or self._shutdown,
                                    timeout=int(timeout_s * 1e6) * 1e-6)
            return got and not self._shutdown

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()


class TemporalBuffer:
    """Time-indexed buffer (int64 ns keys) with windowed eviction from the
    newest entry and nearest-within-tolerance queries."""

    def __init__(self, window_s: float = -1.0):
        self._window_ns = int(window_s * 1e9)  # <= 0: unbounded
        self._keys: List[int] = []
        self._items = {}
        self._lock = threading.Lock()

    def add(self, t_s: float, obj: Any) -> int:
        """Insert (an equal stamp replaces the entry); returns the number of
        entries evicted."""
        t_ns = int(t_s * 1e9)
        with self._lock:
            if t_ns not in self._items:
                bisect.insort(self._keys, t_ns)
            self._items[t_ns] = obj
            n = 0
            if self._window_ns > 0:
                newest = self._keys[-1]
                while self._keys and newest - self._keys[0] > self._window_ns:
                    del self._items[self._keys.pop(0)]
                    n += 1
            return n

    def nearest(self, t_s: float, tol_s: float) -> Optional[Tuple[float, Any]]:
        """(stamp in s, item) of the entry nearest ``t_s`` (the later one on a
        tie), or None if none lies within ``tol_s``. The entry stays."""
        t_ns, tol_ns = int(t_s * 1e9), int(tol_s * 1e9)
        with self._lock:
            if not self._keys:
                return None
            i = bisect.bisect_left(self._keys, t_ns)
            best_dt, best = 2**63 - 1, None
            if i < len(self._keys):
                best_dt, best = self._keys[i] - t_ns, self._keys[i]
            if i > 0 and t_ns - self._keys[i - 1] < best_dt:
                best_dt, best = t_ns - self._keys[i - 1], self._keys[i - 1]
            if best_dt > tol_ns:
                return None
            return best * 1e-9, self._items[best]

    def size(self) -> int:
        with self._lock:
            return len(self._keys)


_MISSING = object()


class FrameSynchronizer:
    """Groups per-camera frames into synchronized multi-frames by timestamp
    tolerance over a ring of at most 3 pending groups. Completing a group
    makes every older pending group obsolete; a fourth pending group evicts
    the oldest. ``obsolete_count`` counts the frames those groups held."""

    _RING = 3

    def __init__(self, num_cameras: int, tolerance_s: float = 0.005):
        self._n = num_cameras
        self._tol_ns = int(tolerance_s * 1e9)
        self._ring: collections.deque = collections.deque()  # [t_ns, frames, count]
        self._obsolete = 0
        self._lock = threading.Lock()

    def add_frame(self, cam: int, t_s: float, obj: Any) -> Optional[Tuple[float, List[Any]]]:
        """Add one camera's frame; (group stamp in s, one item per camera)
        when this completes a group, else None."""
        t_ns = int(t_s * 1e9)
        with self._lock:
            if not 0 <= cam < self._n:
                return None
            for i, g in enumerate(self._ring):
                if abs(g[0] - t_ns) <= self._tol_ns and g[1][cam] is _MISSING:
                    g[1][cam] = obj
                    g[2] += 1
                    if g[2] < self._n:
                        return None
                    for _ in range(i):  # older pending groups are obsolete
                        self._obsolete += self._ring.popleft()[2]
                    self._ring.popleft()
                    return g[0] * 1e-9, list(g[1])
            frames = [_MISSING] * self._n
            frames[cam] = obj
            self._ring.append([t_ns, frames, 1])
            while len(self._ring) > self._RING:
                self._obsolete += self._ring.popleft()[2]
            return None

    @property
    def obsolete_count(self) -> int:
        with self._lock:
            return self._obsolete
