"""The port's host-runtime primitives (``svin_tpu_torch/native.py``).

Mirrors the JAX package's ``tests/test_native.py`` (queue blocking and
drop-oldest semantics under threads, shutdown, timeouts, the condition
gate, the temporal buffer's eviction and nearest queries, frame grouping
with tolerance and stale eviction), then runs one scripted operation
sequence through the JAX package's native library and the port's copy and
compares every output step by step (skipped where the native library is
unavailable, as the JAX package's tests skip).
"""
import threading
import time

import pytest

from svin_tpu_torch.native import FrameSynchronizer, ImuGate, TemporalBuffer, ThreadSafeQueue


def test_queue_fifo_and_size():
    q = ThreadSafeQueue(capacity=8)
    for i in range(5):
        assert q.push_blocking(("item", i))
    assert q.size() == 5
    for i in range(5):
        assert q.pop_blocking() == ("item", i)
    assert q.size() == 0


def test_queue_drop_oldest_when_full():
    q = ThreadSafeQueue(capacity=3)
    dropped = []
    for i in range(6):
        d = q.push_dropping(i)
        if d is not None:
            dropped.append(d)
    assert dropped == [0, 1, 2]
    assert q.dropped_count == 3
    assert [q.pop_blocking() for _ in range(3)] == [3, 4, 5]


def test_queue_blocking_backpressure_threads():
    q = ThreadSafeQueue(capacity=2)
    consumed = []

    def producer():
        for i in range(20):
            q.push_blocking(i)

    def consumer():
        while len(consumed) < 20:
            consumed.append(q.pop_blocking())

    tp, tc = threading.Thread(target=producer), threading.Thread(target=consumer)
    tp.start()
    tc.start()
    tp.join(timeout=5)
    tc.join(timeout=5)
    assert consumed == list(range(20))


def test_queue_shutdown_unblocks():
    q = ThreadSafeQueue(capacity=2)
    result = {}

    def popper():
        result["out"] = q.pop_blocking()

    t = threading.Thread(target=popper)
    t.start()
    time.sleep(0.05)
    q.shutdown()
    t.join(timeout=2)
    assert result["out"] is None
    assert not q.push_blocking(1)  # pushes fail after shutdown


def test_queue_shutdown_drains_first():
    q = ThreadSafeQueue(capacity=4)
    q.push_blocking("a")
    q.push_blocking("b")
    q.shutdown()
    assert [q.pop_blocking(), q.pop_blocking(), q.pop_blocking()] == ["a", "b", None]


def test_queue_pop_timeout():
    q = ThreadSafeQueue(capacity=2)
    t0 = time.time()
    assert q.pop_timeout(0.05) is None
    assert time.time() - t0 >= 0.04
    q.push_blocking(7)
    assert q.pop_timeout(0.05) == 7


def test_imu_gate():
    g = ImuGate()
    result = {}

    def waiter():
        result["ok"] = g.wait_for(int(1.0e9), timeout_s=2.0)

    t = threading.Thread(target=waiter)
    t.start()
    g.announce(int(0.5e9))
    time.sleep(0.02)
    assert "ok" not in result  # still waiting
    g.announce(int(1.5e9))
    t.join(timeout=2)
    assert result["ok"]
    assert not g.wait_for(int(9e9), timeout_s=0.05)  # timeout
    g.shutdown()
    assert not g.wait_for(int(1.0e9), timeout_s=0.05)  # shut down


def test_temporal_buffer_nearest_and_eviction():
    b = TemporalBuffer(window_s=1.0)
    for k in range(5):
        b.add(k * 0.5, f"v{k}")
    # window 1.0 s from the newest (2.0): 1.0, 1.5, 2.0 remain
    assert b.size() == 3
    t, v = b.nearest(1.6, tol_s=0.2)
    assert v == "v3" and abs(t - 1.5) < 1e-9
    assert b.nearest(0.2, tol_s=0.1) is None


def test_frame_synchronizer_groups_by_tolerance():
    s = FrameSynchronizer(num_cameras=2, tolerance_s=0.005)
    assert s.add_frame(0, 1.000, "L1") is None
    t, frames = s.add_frame(1, 1.003, "R1")
    assert frames == ["L1", "R1"] and abs(t - 1.0) < 1e-9
    # an out-of-tolerance right frame starts a new group
    assert s.add_frame(0, 2.000, "L2") is None
    assert s.add_frame(1, 2.050, "R2-late") is None
    # completing the newer group makes the older partial one obsolete
    t, frames = s.add_frame(0, 2.051, "L3")
    assert frames == ["L3", "R2-late"] and abs(t - 2.05) < 1e-9
    assert s.obsolete_count == 1


def test_frame_synchronizer_stale_eviction():
    s = FrameSynchronizer(num_cameras=2, tolerance_s=0.001)
    # 4 partial groups: the ring of 3 evicts the oldest
    for k in range(4):
        s.add_frame(0, float(k), f"L{k}")
    assert s.obsolete_count == 1


def script(mod):
    """One operation sequence over a module's four primitives; every output
    in order (objects reduced to comparable values)."""
    out = []
    q = mod.ThreadSafeQueue(3)
    for i in range(5):
        out.append(("push_dropping", q.push_dropping(i)))
    out.append(("dropped", q.dropped_count, q.size()))
    out.append(("pop", q.pop_blocking(), q.pop_timeout(0.01)))
    out.append(("push_blocking", q.push_blocking("x"), q.size()))
    q.shutdown()
    out.append(("after shutdown", q.push_blocking("y"), q.push_dropping("z"),
                q.pop_blocking(), q.pop_blocking(), q.pop_timeout(0.01)))
    g = mod.ImuGate()
    g.announce(5)
    g.announce(3)
    out.append(("gate", g.wait_for(5, 0.01), g.wait_for(6, 0.01)))
    g.shutdown()
    out.append(("gate shut", g.wait_for(1, 0.01)))
    b = mod.TemporalBuffer(window_s=0.25)
    for t in (0.0, 0.1, 0.2, 0.2, 0.3, 0.45, 0.5):
        out.append(("tbuf add", t, b.add(t, f"at {t}"), b.size()))
    for t, tol in ((0.35, 0.1), (0.375, 0.1), (0.4, 0.01), (0.1, 0.5), (0.475, 0.025)):
        out.append(("nearest", t, tol, b.nearest(t, tol)))
    s = mod.FrameSynchronizer(3, tolerance_s=0.004)
    for cam, t in ((0, 1.0), (1, 1.003), (0, 1.1), (2, 1.002), (1, 1.2), (0, 1.201),
                   (2, 1.3), (1, 1.4), (2, 1.199), (0, 1.5), (0, 1.501), (1, 1.502),
                   (2, 1.498), (5, 1.6)):
        out.append(("fsync", cam, t, s.add_frame(cam, t, f"c{cam}@{t}"), s.obsolete_count))
    return out


def test_scripted_sequence_matches_the_jax_package_native_library():
    jn = pytest.importorskip("svin_tpu.native")
    if not jn.native_available():
        pytest.skip("native library unavailable")
    from svin_tpu_torch import native as tn

    want, got = script(jn), script(tn)
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {step}: port {g} != native {w}"


def test_timebase_matches_the_jax_package():
    """The port's copy of the nanosecond timebase against the JAX package's."""
    from svin_tpu.utils import timebase as jt
    from svin_tpu_torch.utils import timebase as tt

    for t in (0.0, 1e-9, 0.1234567891, 1.5, -2.25, 1_700_000_000.123456789):
        assert tt.from_sec(t) == jt.from_sec(t)
        assert tt.to_sec(jt.from_sec(t)) == jt.to_sec(jt.from_sec(t))
    assert tt.from_sec_nsec(12, 345) == jt.from_sec_nsec(12, 345) == 12_000_000_345
    assert abs(tt.now() - jt.now()) < 10**9
