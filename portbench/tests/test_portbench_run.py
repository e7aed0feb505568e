"""The harness end to end on the CPU at the tiny size, its refusals, and the
faults planted under it that the correctness check has to catch."""
from __future__ import annotations

import contextlib
import io
import os
import shutil
import subprocess
import sys

import pytest

import portbench_tiny as tiny
from portbench import control, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# a window longer than the tiny mixes: every run feeds all their frames, so
# what it judges does not hang on the speed of the machine
FOREVER = 3600


def _recency(engine, closer):
    """Loop candidates after 5 keyframes: the tiny prior map has 30, not 50."""
    from svin_tpu_torch.loopclosure import loop_closure

    loop_closure.RECENCY_EXCLUSION = 5


@pytest.fixture
def recency():
    from svin_tpu_torch.loopclosure import loop_closure

    saved = loop_closure.RECENCY_EXCLUSION
    yield _recency
    loop_closure.RECENCY_EXCLUSION = saved


def _main(root, workload, seed, seconds, trace, patch=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, device="cpu", patch=patch)
    return rc, tiny.last_json(out.getvalue())


def test_tiny_transect_last_line_has_the_contract_keys(tmp_path):
    root = tiny.make_root(tmp_path)
    rc, res = _main(root, "tiny.transect", 2**31 + 12345, FOREVER, 0)
    assert rc == 0
    assert list(res) == KEYS + ["checks"]  # the checks come last
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["attempted"] == 60 - 12 and res["failed"] == 0
    assert set(res["checks"]) == {"ate_m", "rpe_m", "solve_berr", "solve_bad", "match_diff",
                                  "loops"}


def test_tiny_laps_traced_reports_the_per_layer_metrics(tmp_path, recency):
    root = tiny.make_root(tmp_path, cell="tiny.laps", traffic="laps")
    rc, res = _main(root, "tiny.laps", 5, FOREVER, 1, patch=recency)
    assert rc == 0
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"] is True, res["checks"]
    # no card: the device metrics find nothing to read and are left out; the
    # host's and the program's own are there, later ones beside them
    assert set(res["metrics"]) >= {"engine.self_ms_per_frame", "closer.ms_per_keyframe",
                                   "globalmap.ms_per_loop"}
    assert not {m for m in res["metrics"] if m.startswith(("device.", "kernel."))}
    assert res["checks"]["loop_share"][0] > 0
    assert 0 <= res["checks"]["pg_dp_m"][0] <= 1e-6  # the pose graph solved in the window
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]


def test_refuses_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "euroc.laps",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tiny.REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: no result."""
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "euroc.laps",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")


@pytest.mark.parametrize("variant,traffic,fails", [
    ("tf32", "transect", "solve_berr"),  # the control: TF32 below the stated float32
    ("tf32", "laps", "pg_dp_m"),  # the control, where the pose graph solves
    ("frozen", "transect", "solve_berr"),  # a step that returns its state unchanged
    ("match_shift", "transect", "match_diff"),  # an answer altered where it is produced: the matcher
    ("pg_shift", "laps", "pg_dp_m"),  # an answer altered where it is produced: the pose graph
])
def test_the_control_and_planted_faults_are_not_correct(tmp_path, recency, variant, traffic,
                                                         fails):
    root = tiny.make_root(tmp_path, cell="tiny." + traffic, traffic=traffic)

    def both(engine, closer):
        recency(engine, closer)
        control.VARIANTS[variant](engine, closer)

    rc, res = _main(root, "tiny." + traffic, 7, FOREVER, 0, patch=both)
    assert rc == 0
    assert res["correct"] is False, res["checks"]
    v, _, lim = res["checks"][fails]
    assert v is None or v > lim, res["checks"]

