"""The per-layer readers on a run record: what each reads, and nothing where
there is nothing to read (never a 0 share of a roofline)."""
from __future__ import annotations

import importlib.util
import os

import pytest

import portbench_tiny as tiny
from portbench import roofline, tracing


def _reader(name):
    path = os.path.join(tiny.PORTBENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    def __init__(self, trace=None, counters=None):
        self.cfg = {"numKeyframes": 5, "numImuFrames": 3}
        self.frames = 4
        self.spans = tracing.Spans()
        self.counters = counters or {"spd_solve_chol": 20, "spd_solve_cluster": 0,
                                     "solve_spd_library": 0}
        self.trace = trace


TRACE = {"frames": 2, "window_s": 1.0, "busy_s": 0.05, "ops": 30000,
         "op_seconds": {"spd_solve_chol_kernel(float const*)": 40 * 40e-6, "gemv": 0.01},
         "op_counts": {"spd_solve_chol_kernel(float const*)": 40, "gemv": 100}}


def test_the_spd_solve_roofline_share():
    least_ms, by = roofline.spd_solve_bound(120)
    assert by == "operations"
    assert _reader("kernel.spd_solve.roofline_pct")(_Run(TRACE)) == pytest.approx(
        100 * least_ms / 0.040)
    # another route of solve_spd in the window, or no launch traced: nothing
    assert _reader("kernel.spd_solve.roofline_pct")(_Run(TRACE, {"spd_solve_cluster": 3})) is None
    assert _reader("kernel.spd_solve.roofline_pct")(_Run(dict(TRACE, op_counts={"gemv": 1},
                                                              op_seconds={"gemv": 1.0}))) is None
    assert _reader("kernel.spd_solve.roofline_pct")(_Run(None)) is None


def test_device_readers():
    assert _reader("device.idle_pct")(_Run(TRACE)) == pytest.approx(95.0)
    assert _reader("device.ops_per_frame")(_Run(TRACE)) == 15000
    assert _reader("device.idle_pct")(_Run(dict(TRACE, ops=0))) is None


def test_span_readers():
    r = _Run()
    r.spans.by_name["engine.add_frame"] = [(0.0, 0.3), (1.0, 1.2), (2.0, 2.2), (3.0, 3.3)]
    r.spans.by_name["closer.add_keyframe"] = [(0.1, 0.2), (2.05, 2.15)]
    r.spans.by_name["globalmap.add_observations"] = [(0.2, 0.21), (2.15, 2.16)]
    assert _reader("engine.self_ms_per_frame")(r) == pytest.approx(1e3 * (1.0 - 0.22) / 4)
    assert _reader("closer.ms_per_keyframe")(r) == pytest.approx(100.0)
    assert _reader("globalmap.ms_per_loop")(r) is None
