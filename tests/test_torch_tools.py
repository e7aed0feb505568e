"""The port's chip tools on the CPU at tiny durations.

``tools/gauntlet_torch.py`` and ``tools/cave_run_torch.py`` run their
configurations through the port's CLI on the card; here each runs with
``--device cpu`` (float64) on sequences cut to a few seconds and writes
its record into the test's directory: both Cave sessions run, the resume
restores the first session's keyframes, and the records parse. The tools'
configs are the JAX tests' and the JAX tool's, string for string, and the
gauntlet's bound checks fail a run past any bound.
"""
import importlib.util
import json
import os

import pytest
import torch

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gauntlet():
    return load_tool("gauntlet_torch")


def test_tool_configs_are_the_jax_tests(gauntlet):
    from test_gauntlet import CONFIG_YAML
    from test_gauntlet_variants import _CAM0, _CAM1, _COMMON

    loop = "\nloop_closure_params:\n    enable: 1\n    min_correspondences: 12\n"
    assert gauntlet.STEREO_YAML == CONFIG_YAML
    assert gauntlet.SIXDOF_YAML == ("%YAML:1.0\ncameras:\n" + _CAM0 + _CAM1 + _COMMON + loop
                                    + '    pgo_mode: "6dof"\n')
    assert gauntlet.MONO_YAML == "%YAML:1.0\ncameras:\n" + _CAM0 + _COMMON + loop
    assert load_tool("cave_run_torch").CONFIG_YAML == load_tool("cave_run").CONFIG_YAML


def _metrics(**over):
    traj = dict(n_poses=189, ate_m=0.1, rpe_trans_m=0.05, rpe_rot_deg=1.0)
    m = {"svin_vio": dict(traj), "svin_loop": dict(traj, ate_m=0.04, rpe_rot_deg=0.5),
         "svin_robust": dict(traj), "switch": {"to_primitive_s": 31.4, "to_vio_s": 32.4},
         "outputs": sorted(["svin_vio.txt", "svin_loop.txt", "svin_robust.txt", "global_map.ply",
                            "state.csv", "landmarks.csv", "switch_info.txt"]),
         "map_vertices": 4000}
    for k, v in over.items():
        m[k] = dict(m[k], **v) if isinstance(v, dict) else v
    return m


@pytest.mark.parametrize("name,over,failing", [
    ("stereo", {}, []),
    ("stereo", {"svin_vio": {"ate_m": 0.4}}, ["VIO ATE m <"]),
    ("stereo", {"svin_loop": {"ate_m": 0.12}}, ["loop ATE m <", "loop ATE m < 0.75 x VIO"]),
    ("stereo", {"svin_loop": {"ate_m": 0.08}}, ["loop ATE m < 0.75 x VIO"]),
    ("stereo", {"switch": {"to_primitive_s": 29.0}}, ["VIO->PRIMITIVE s in"]),
    ("stereo", {"switch": {"to_vio_s": None}}, ["PRIMITIVE->VIO s after the switch"]),
    ("stereo", {"map_vertices": 50}, ["global map vertices >"]),
    ("6dof", {}, []),
    ("6dof", {"svin_loop": {"rpe_rot_deg": 1.5}}, ["loop RPE deg < VIO"]),
    ("mono", {}, []),
    ("mono", {"svin_vio": {"ate_m": 0.9}}, ["VIO ATE m <"]),
])
def test_gauntlet_bounds_fail_past_each_bound(gauntlet, name, over, failing):
    cal, tol = gauntlet.calibration()
    held = gauntlet.check_bounds(name, _metrics(**over), cal, tol)
    assert held and [b["what"] for b in held if not b["held"]] == failing


def test_gauntlet_tool_on_the_cpu(gauntlet, tmp_path):
    out = tmp_path / "gauntlet.json"
    assert gauntlet.main(["--device", "cpu", "--duration", "1.5", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert set(rec["configs"]) == {"stereo", "6dof", "mono"} and rec["passed"]
    for name, m in rec["configs"].items():
        assert not m["full_length"] and m["bounds"] == []
        assert m["frames"] >= 4 and m["add_frame_ms"]["n"] == m["frames"]
        assert sum(m["lm_budget_per_frame"].values()) == m["frames"]
        assert set(m["launches"]) >= {"spd_solve_chol", "hamming_match", "hamming_nearest"}
        assert not any(m["launches"].values())  # the CPU runs the plain versions


def test_cave_tool_on_the_cpu(tmp_path):
    cave = load_tool("cave_run_torch")
    out = tmp_path / "cave.json"
    assert cave.main(["--device", "cpu", "--duration-a", "5", "--duration-b", "3",
                      "--out", str(out), "--work", str(tmp_path / "work")]) == 0
    rec = json.loads(out.read_text())
    a, b = rec["session_a"], rec["session_b_resumed"]
    assert not rec["full_length"] and rec["cut"]["duration_a_s"] == 5.0 and rec["passed"]
    assert a["frames"] >= 12 and b["frames"] >= 6
    assert a["closer_keyframes"] >= 1 and b["n_restored"] == a["closer_keyframes"]
    assert b["closer_keyframes"] == b["n_restored"] + b["svin_loop"]["n_new_session"]
    assert rec["total_keyframes"] == a["closer_keyframes"] + b["svin_loop"]["n_new_session"]
    assert a["add_keyframe_ms"]["n"] == a["keyframe_exports"] and b["frames_per_s"] > 0
    assert a["svin_vio"]["ate_se3_m"] < 1.0 and a["svin_vio"]["first_beyond_10m_s"] is None
    assert {"svin_vio.txt", "loop_stats.json"} <= set(os.listdir(tmp_path / "work" / "b"))


def test_device_profile_summary_takes_the_union_of_device_intervals():
    """The busy share counts overlapping device operations once and skips
    host events; operations rank by their summed device ms."""
    from types import SimpleNamespace

    from svin_tpu_torch.utils.timing import device_profile_summary

    def ev(name, a, b, dev=torch.autograd.DeviceType.CUDA):
        rng = SimpleNamespace(start=a, end=b, elapsed_us=lambda: b - a)
        return SimpleNamespace(name=name, device_type=dev, time_range=rng)

    events = [ev("gemm", 0, 400), ev("add", 300, 500), ev("add", 900, 1000),
              ev("host", 0, 1000, torch.autograd.DeviceType.CPU)]
    prof = SimpleNamespace(events=lambda: events)
    got = device_profile_summary(prof, wall=1e-3, top=1)
    assert got["busy"] == pytest.approx(0.6) and got["ops"] == 3
    assert got["ms"] == pytest.approx(0.7) and got["top"] == [("gemm", 0.4, 1)]
