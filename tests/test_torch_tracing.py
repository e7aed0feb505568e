"""The port's spans and counters (``svin_tpu_torch/utils/timing.py``) and the
benchmark's readers of them (``portbench/programspans.py``, its
``metrics/``), on the CPU.

The synchronous engine's spans form a tree (each child inside its parent, on
its thread, in its frame), the closer's spans nest under the engine's
``3.3 kf_callback``, the pipelined engine's frontend thread keeps its own
parents, ``enable(False)`` records nothing, and under a CPU
``torch.profiler`` the spans are ranges of the trace in the same nesting.
The fetch counter counts ``to_numpy_tree``'s fetches. The readers give the
right value on a synthetic run, and a trace's program ranges change nothing
of what ``portbench.tracing.summarize`` reads while ``programspans.stages``
puts the idle gaps under them.
"""
import importlib.util
import os
import threading
from collections import defaultdict

import numpy as np
import pytest
import torch

from portbench import programspans, tracing
from svin_tpu_torch import sim
from svin_tpu_torch.convert import to_numpy_tree
from svin_tpu_torch.loopclosure import LoopCloser
from svin_tpu_torch.pipeline import VioConfig, VioEngine, run_events, synthetic_sequence
from svin_tpu_torch.pipeline.async_vio import AsyncVioEngine
from svin_tpu_torch.utils import Timer, Timing, timing
from torch_parity import port_rig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_STAGES = {"2.1 detect_describe", "2.3 preint", "2.4 matching", "2.7 create_state",
                 "2.8 kf_decision", "3.1 optimization"}


def _config() -> VioConfig:
    cfg = VioConfig()
    cfg.num_keyframes = 4
    cfg.num_imu_frames = 2
    cfg.max_keypoints = 150
    cfg.max_iterations = 3
    cfg.time_limit = 0.0  # every frame runs the full 3 LM iterations
    return cfg


def _events(duration):
    events, _ = synthetic_sequence(
        port_rig(), duration=duration, cam_rate=5.0, imu_rate=100.0,
        imu_params=_config().imu, seed=3, n_points=250,
        traj=sim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0, depth_offset=3.0,
        t_first_frame=0.12)
    return list(events)


@pytest.fixture
def store():
    """A clean store, tracing on; the switch restored after."""
    was = timing.enabled()
    timing.enable(True)
    Timing.reset()
    yield
    timing.enable(was)
    Timing.reset()


@pytest.fixture(scope="module")
def engine_run():
    """The engine over 2.6 s with the closer as its keyframe callback: its
    spans and counter increments."""
    was = timing.enabled()
    timing.enable(True)
    Timing.reset()
    eng = VioEngine(_config(), rig=port_rig(), device="cpu")
    closer = LoopCloser(eng.rig.cameras[0], _config(), device="cpu")
    eng.keyframe_callback = closer.add_keyframe
    results = run_events(eng, _events(2.6))
    out = (results, timing.records(), timing.count_records(), Timing.summary())
    timing.enable(was)
    Timing.reset()
    return out


def _check_tree(spans):
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s.name, p.name)
            assert p.thread == s.thread and p.frame == s.frame, (s.name, p.name)
    return by_id


def test_engine_spans_form_a_tree(engine_run):
    results, spans, _, _ = engine_run
    assert len(results) >= 6
    by_id = _check_tree(spans)
    roots = [s for s in spans if s.name == "2.0 frame_total"]
    assert len(roots) == len(results) - 1  # the first frame initializes
    frames = defaultdict(list)
    for s in spans:
        frames[s.frame].append(s)
    for r in roots:
        assert r.parent == 0 and r.frame > 0
        kids = [s for s in spans if s.parent == r.id]
        assert ENGINE_STAGES <= {k.name for k in kids}
        # every span of the frame lies under its root, and the direct
        # children and the root's own time add up to the root
        for s in frames[r.frame]:
            top = s
            while top.parent:
                top = by_id[top.parent]
            assert top.id == r.id, s.name
        covered = sum(b - a for a, b in tracing._union((k.start_ns, k.end_ns) for k in kids))
        assert 0 <= r.end_ns - r.start_ns - covered < r.end_ns - r.start_ns
    opt = [s for s in spans if s.name == "3.1 optimization"]
    assert {by_id[s.parent].name for s in spans if s.name.startswith("3.1.") and
            s.name.count(".") == 2} == {"3.1 optimization"}
    lm = [s for s in spans if s.name == "3.1.1.1 lm_iteration"]
    assert len(lm) == 3 * len(opt) and all(by_id[s.parent].name == "3.1.1 opt_dispatch"
                                           for s in lm)


def test_closer_spans_nest_under_the_keyframe_callback(engine_run):
    results, spans, counts, summary = engine_run
    by_id = {s.id: s for s in spans}
    lc0 = [s for s in spans if s.name == "lc.0 add_keyframe"]
    assert len(lc0) == sum(r.keyframe_export is not None for r in results) >= 2
    for s in lc0:
        cb = by_id[s.parent]
        assert cb.name == "3.3 kf_callback" and by_id[cb.parent].name == "2.0 frame_total"
    kids = {s.name for s in spans if s.parent in {x.id for x in lc0}}
    assert {"lc.1 describe_detect", "lc.6 db_add"} <= kids
    # the aggregates the apps print are the store's
    assert summary["lc.0 add_keyframe"]["n"] == len(lc0)
    assert summary["2.0 frame_total"]["n"] == len(results) - 1
    # the fetches: some in each frame, each stamped with its frame
    per_frame = defaultdict(int)
    for c in counts:
        if c.name == "fetch":
            per_frame[c.frame] += c.n
    roots = {s.frame for s in spans if s.name == "2.0 frame_total"}
    assert roots <= set(per_frame) and all(per_frame[f] >= 3 for f in roots)


def test_parents_hold_on_the_frontend_thread(store):
    ae = AsyncVioEngine(VioEngine(_config(), rig=port_rig(), device="cpu"), blocking=True)
    n = 0
    for ev in _events(1.2):
        if ev.kind == "imu":
            ae.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "frame":
            for ci, img in enumerate(ev.images):
                ae.add_image(ev.t, ci, img)
            n += 1
    ae.finish()
    spans = timing.records()
    by_id = _check_tree(spans)
    fe = [s for s in spans if s.name == "1.1 frontend_stage"]
    be = [s for s in spans if s.name == "2.0 frame_total" and s.parent == 0]
    # frames that reach the frontend before the backend has initialized go
    # to the backend whole
    assert 2 <= len(fe) < n and be
    assert {s.thread for s in fe}.isdisjoint({s.thread for s in be})
    fetches = [s for s in spans if s.name == "2.1.2 detect_fetch" and s.parent]
    fe_ids = {s.id for s in fe}
    assert sum(s.parent in fe_ids for s in fetches) == len(fe)
    for s in fe:
        assert s.frame > 0 and s.parent == 0
    # the backend's stages sit on the backend's own thread
    for s in spans:
        if s.name == "2.4.2 match_fetch":
            assert by_id[s.parent].thread == s.thread != fe[0].thread


def test_spans_of_many_threads_keep_their_own_parents(store):
    """More threads than cores opening nested spans and counts under a short
    switch interval: ids stay unique, every parent is its thread's, and the
    aggregates count every span."""
    import sys

    n_threads, n_iter = min(2 * (os.cpu_count() or 2) + 2, 40), 300

    def work():
        for _ in range(n_iter):
            with timing.frame(), Timer("a"):
                with Timer("b"):
                    timing.count("c")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    spans = timing.records()
    assert len(spans) == len({s.id for s in spans}) == 2 * n_threads * n_iter
    _check_tree(spans)
    assert all(s.parent for s in spans if s.name == "b")
    assert Timing.get("a").count == Timing.get("b").count == n_threads * n_iter
    assert timing.counters() == {"c": n_threads * n_iter}
    assert len({s.frame for s in spans}) == n_threads * n_iter


def test_disabled_records_nothing(store):
    timing.enable(False)
    with Timer("x"):
        timing.count("c")
        with timing.frame():
            with Timer("y"):
                pass
    assert Timer("z").stop() == 0.0
    assert timing.records() == [] and timing.count_records() == [] and timing.counters() == {}
    assert Timing.summary() == {} and Timing.get("x") is None
    assert Timing.print_table().startswith("SVIn Timing")
    timing.enable(True)
    with Timer("x"):
        pass
    assert Timing.summary()["x"]["n"] == 1 and Timing.mean("x") > 0


def test_spans_are_profiler_ranges_in_the_same_nesting(store):
    eng = VioEngine(_config(), rig=port_rig(), device="cpu")
    events = _events(1.0)
    last = max(i for i, ev in enumerate(events) if ev.kind == "frame")
    run_events(eng, events[:last])
    Timing.reset()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        run_events(eng, events[last:])
    spans = timing.records()
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(timing.PREFIX):])
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(timing.PREFIX)]
    assert sorted(r[2] for r in ranges) == sorted(s.name for s in spans)
    by_id = {s.id: s for s in spans}

    def holds(outer, inner):
        return any(a0 <= a1 and b1 <= b0 for a0, b0, n0 in ranges if n0 == outer
                   for a1, b1, n1 in ranges if n1 == inner)

    for s in spans:
        if s.parent:
            assert holds(by_id[s.parent].name, s.name), s.name


def test_the_fetch_counter(store):
    with timing.frame(), Timer("outer") as t:
        host = to_numpy_tree((torch.ones(3), [torch.zeros(2, dtype=torch.int32)]))
        to_numpy_tree((np.ones(2), None))  # no tensor: no fetch
    assert isinstance(host[0], np.ndarray) and host[1][0].dtype == np.int32
    (c,) = timing.count_records()
    assert c.name == "fetch" and c.n == 1 and c.parent == t._id
    assert c.frame > 0 and timing.counters() == {"fetch": 1}


def test_counters_dict_stamps_each_change(store):
    d = timing.Counters("lc.", {"candidates": 0, "accepted": 0})
    d["candidates"] += 2
    d["accepted"] += 1
    d["pruned"] = d.get("pruned", 0) + 3
    assert dict(d) == {"candidates": 2, "accepted": 1, "pruned": 3}
    assert [(c.name, c.n) for c in timing.count_records()] == [
        ("lc.candidates", 2), ("lc.accepted", 1), ("lc.pruned", 3)]


# ------------------------------------------------------------- the readers
def _reader(name):
    path = os.path.join(REPO, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MS = 1_000_000  # ns


def _span(i, parent, name, a, b, frame=1):
    return timing.Span(i, parent, frame, name, a * MS, b * MS, 1)


class _Run:
    def __init__(self, frames, trace=None):
        self.spans = tracing.Spans()
        self.spans.by_name["engine.add_frame"] = [(a * 1e-3, b * 1e-3) for a, b in frames]
        self.trace = trace


# two window frames, 0-100 ms and 200-300 ms (the second with a keyframe,
# its closer verifying two candidates and accepting one); a span at 500 ms
# lies outside every window frame (a profiled frame, say)
SPANS = [
    _span(2, 1, "2.3 preint", 1, 5), _span(3, 1, "2.1 detect_describe", 5, 20),
    _span(4, 1, "2.4 matching", 20, 50), _span(5, 1, "3.1 optimization", 55, 95),
    _span(1, 0, "2.0 frame_total", 0, 100),
    _span(12, 11, "2.3 preint", 201, 203), _span(13, 11, "2.1 detect_describe", 203, 215),
    _span(14, 11, "2.4 matching", 215, 240), _span(15, 11, "3.1 optimization", 240, 270),
    _span(22, 21, "lc.1 describe_detect", 272, 276), _span(23, 21, "lc.4 verify", 277, 287),
    _span(24, 21, "lc.5 pose_graph", 288, 293),
    _span(21, 16, "lc.0 add_keyframe", 271, 295), _span(16, 11, "3.3 kf_callback", 270, 296),
    _span(11, 0, "2.0 frame_total", 200, 299),
    _span(31, 0, "2.0 frame_total", 500, 600, frame=3),
]
COUNTS = [timing.Count("fetch", 1, t * MS, 0, 1) for t in (10, 60, 212, 250, 278, 550)] + [
    timing.Count("lc.candidates", 2, 280 * MS, 23, 1),
    timing.Count("lc.accepted", 1, 286 * MS, 23, 1)]


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(timing, "records", lambda: list(SPANS))
    monkeypatch.setattr(timing, "count_records", lambda: list(COUNTS))
    return _Run([(0, 100), (200, 300)])


@pytest.mark.parametrize("name, value", [
    ("engine.preint.ms_per_frame", (4 + 2) / 2),
    ("engine.frontend.ms_per_frame", (15 + 12) / 2),
    ("engine.match.ms_per_frame", (30 + 25) / 2),
    ("engine.opt.ms_per_frame", (40 + 30) / 2),
    # root less its children: (100 - 89) and (99 - 95)
    ("engine.untimed_ms_per_frame", (11 + 4) / 2),
    # the fetch at 278 ms is the callback's, the one at 550 ms outside
    ("engine.fetches_per_frame", 4 / 2),
    ("closer.describe.ms_per_keyframe", 4.0),
    ("closer.untimed_ms_per_keyframe", 24 - 19),
    ("closer.verify.ms_per_candidate", 10 / 2),
    ("closer.posegraph.ms_per_solve", 5.0),
    ("closer.verify.accepted_pct", 50.0),
])
def test_readers_on_a_synthetic_run(synthetic, name, value):
    assert _reader(name)(synthetic) == pytest.approx(value)


def test_readers_read_nothing_without_the_program(monkeypatch):
    """A program without the store (the parent's), or a window with none of
    its spans, reads None."""
    run = _Run([(0, 100)])
    monkeypatch.delattr(timing, "records")
    for n in ("engine.preint.ms_per_frame", "engine.untimed_ms_per_frame",
              "engine.fetches_per_frame", "closer.verify.accepted_pct"):
        assert _reader(n)(run) is None
    monkeypatch.setattr(timing, "records", lambda: [], raising=False)
    monkeypatch.setattr(timing, "count_records", lambda: [], raising=False)
    assert _reader("closer.untimed_ms_per_keyframe")(run) is None
    assert _reader("engine.opt.device_ms_per_frame")(_Run([(0, 100)])) is None


# ------------------------------------------------------------- the trace
class _Event:
    def __init__(self, name, a, b, cuda=False, corr=0, linked=0, thread=1):
        self._n, self._a, self._d = name, a, b - a
        self._cuda, self._c, self._l, self._t = cuda, corr, linked, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t


class _Prof:
    def __init__(self, events):
        class K:
            def events(self):
                return events

        self.profiler = type("P", (), {"kineto_results": K()})()


def _trace(with_program):
    """One traced frame: the benchmark's feed and add_frame spans (and the
    GPU-side copy of its annotation), two launches and an operator's sync; with the
    program's ranges (host side only: no GPU-side copy) around them."""
    ev = [_Event("portbench.feed", 0, 10), _Event("portbench.engine.add_frame", 10, 1000),
          _Event("portbench.engine.add_frame", 120, 620, cuda=True),
          _Event("cudaLaunchKernel", 100, 110, corr=7, linked=70),
          _Event("gemm", 120, 320, cuda=True, corr=7, linked=70),
          _Event("cudaLaunchKernel", 600, 610, corr=8, linked=80),
          _Event("add", 610, 620, cuda=True, corr=8, linked=80),
          _Event("aten::nonzero", 690, 810, corr=90),
          _Event("cudaStreamSynchronize", 700, 800, corr=9, linked=90)]
    if with_program:
        ev += [_Event("svin.2.0 frame_total", 20, 990), _Event("svin.3.1 optimization", 50, 900),
               _Event("svin.3.1.1 opt_dispatch", 60, 650), _Event("svin.2.4 matching", 910, 980)]
    return ev


def test_summarize_is_the_same_with_program_ranges():
    keys = ("window_s", "busy_s", "ops", "op_seconds", "op_counts", "device_ops")
    plain = tracing.summarize(_Prof(_trace(False)), 1)
    ranged = tracing.summarize(_Prof(_trace(True)), 1)
    assert {k: plain[k] for k in keys} == {k: ranged[k] for k in keys}
    assert plain["ops"] == 2 and plain["busy_s"] == pytest.approx(210e-9)


def test_stages_put_device_work_and_idle_gaps_under_program_spans():
    st = programspans.stages(_trace(True))
    ns = 1e-9
    assert st["device_s"]["3.1 optimization"] == pytest.approx(210 * ns)
    assert st["device_self_s"] == pytest.approx({"3.1.1 opt_dispatch": 210 * ns})
    assert st["ops"]["2.0 frame_total"] == 2
    assert st["syncs"] == {"3.1 optimization": 1}
    assert st["sync_sites"] == {"3.1 optimization / aten::nonzero": 1}
    # gaps: 0-120 (midpoint 60: opt_dispatch), 320-610 (465: opt_dispatch),
    # 620-1000 (810: optimization)
    assert st["idle_s"] == pytest.approx({"3.1.1 opt_dispatch": (120 + 290) * ns,
                                          "3.1 optimization": 380 * ns})
    assert st["program_idle_s"] == pytest.approx(790 * ns)
    assert st["host_s"]["2.4 matching"] == pytest.approx(70 * ns)
    # without the program's ranges the gaps keep the benchmark's labels
    plain = programspans.stages(_trace(False))
    assert plain["idle_s"] == pytest.approx({"engine.add_frame": 790 * ns})
    assert dict(tracing.summarize(_Prof(_trace(False)), 1)["idle_gaps"]) == pytest.approx(
        plain["idle_s"])


def test_the_device_reader_finds_the_runs_profiler(store):
    """The reader of ``engine.opt.device_ms_per_frame`` takes the events of
    the one finished profiler the process holds (a CPU trace here: no device
    operation, so the share reads 0 ms)."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with torch.profiler.record_function("portbench.engine.add_frame"):
            with Timer("3.1 optimization"):
                torch.ones(4).sum()
    run = _Run([(0, 1)], trace={"frames": 1, "ops": 3})
    assert programspans.device(run)["host_s"]["3.1 optimization"] > 0
    assert _reader("engine.opt.device_ms_per_frame")(run) == 0.0
    del prof
