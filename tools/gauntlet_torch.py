"""The accuracy gauntlet through the port's CLI, on the card in float32.

Runs the JAX package's three gauntlet configurations through
``svin_tpu_torch.apps.run_synchronous.main`` on the port's own rendered
``--synthetic`` sequences, with the config's real-time LM budget (35 ms):

- ``stereo`` (``tests/test_gauntlet.py``): 63 s, revisits, a featureless
  stretch at 30-32 s, primitive odometry, the health gate, sonar + depth;
- ``6dof`` (``tests/test_gauntlet_variants.py``): 45 s, the 6-DoF pose
  graph, 5x gyro noise in the simulator only;
- ``mono`` (the same file): one camera, 40 s.

Each run is held to the JAX tests' bounds: Sim(3)-ATE and RPE within
``tolerance_factor`` x ``calibrated_cpu_f64`` of
``artifacts/ACCURACY_TREND.json``, at least 180 poses, the loop
trajectory below 0.75x the VIO ATE, the switch to the primitive estimator
within [30, 34] s and back, complete outputs with more than 50 map
vertices; the 6-DoF graph's rotation drift below VIO's with the position
ATE within 1.05x; the mono bounds. The artifact's ``tpu_f32`` row is a
TPU figure and sets no bound. A run whose sequence is cut (``--duration``)
is recorded without its bounds.

Writes one JSON record (``--out``, by default
``artifacts/GAUNTLET_torch.json``): per configuration ATE, RPE and the
switch stamps, keyframes, loops, frames per second, ``add_frame`` and
``add_keyframe`` ms (median, p90; host time, synchronized), the LM budget
and the accepted LM steps per frame, and the launches of each kernel.
Exits non-zero past a bound, and without a card unless ``--device cpu``.

Usage:
  python3 tools/gauntlet_torch.py [--device cuda|cpu] [--out PATH] [--duration S]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

IMG_W, IMG_H, MAXKP = 200, 150, 150
CAM0 = f"""  - T_SC: [1.0, 0.0, 0.0, 0.0,  0.0, 1.0, 0.0, 0.0,  0.0, 0.0, 1.0, 0.0,  0.0, 0.0, 0.0, 1.0]
    image_dimension: [{IMG_W}, {IMG_H}]
    focal_length: [160.0, 160.0]
    principal_point: [100.0, 75.0]
    distortion_coefficients: []
    distortion_type: none
"""
CAM1 = CAM0.replace("1.0, 0.0, 0.0, 0.0,  0.0, 1.0", "1.0, 0.0, 0.0, 0.2,  0.0, 1.0")
COMMON = f"""
camera_params:
    camera_rate: 3

imu_params:
    imu_rate: 100

numKeyframes: 4
numImuFrames: 2

ceres_options:
    maxIterations: 5

detection_options:
    threshold: 40.0
    octaves: 0
    maxNoKeypoints: {MAXKP}
"""
SONAR_DEPTH = """
isSonarUsed: 1
isDepthUsed: 1
sonar_params:
    T_SSo: [1.0, 0.0, 0.0, 0.0,  0.0, 1.0, 0.0, 0.0,  0.0, 0.0, 1.0, 0.0,  0.0, 0.0, 0.0, 1.0]
"""
LOOP = """
loop_closure_params:
    enable: 1
    min_correspondences: 12
"""
HEALTH = """
health:
    enable: 1
    min_keypoints: 12
    consecutive_keyframes: 2
    kps_per_quadrant: 1
    keyframe_wait_time: 20.0
"""
STEREO_YAML = "%YAML:1.0\ncameras:\n" + CAM0 + CAM1 + COMMON + SONAR_DEPTH + LOOP + HEALTH
SIXDOF_YAML = ("%YAML:1.0\ncameras:\n" + CAM0 + CAM1 + COMMON + LOOP
               + '    pgo_mode: "6dof"\n')
MONO_YAML = "%YAML:1.0\ncameras:\n" + CAM0 + COMMON + LOOP

# name -> (config, SVIN_SYNTH_* settings); the durations are the JAX tests'
CONFIGS = {
    "stereo": (STEREO_YAML, {"SVIN_SYNTH_DURATION": "63", "SVIN_SYNTH_REVISIT": "1",
                             "SVIN_SYNTH_DEGRADE": "30:32", "SVIN_SYNTH_PRIMITIVE": "1"}),
    "6dof": (SIXDOF_YAML, {"SVIN_SYNTH_DURATION": "45", "SVIN_SYNTH_REVISIT": "1",
                           "SVIN_SYNTH_GYRO_NOISE_SCALE": "5"}),
    "mono": (MONO_YAML, {"SVIN_SYNTH_DURATION": "40", "SVIN_SYNTH_REVISIT": "1"}),
}
OUTPUTS = {"svin_vio.txt", "svin_loop.txt", "svin_robust.txt", "global_map.ply", "state.csv",
           "landmarks.csv", "switch_info.txt"}
# the loop closer's switch from the dense pose-graph solve to the scalable one
DENSE_NODES = 512
# (first frame, frames) traced by torch.profiler on the card, past the start-up
PROFILE_FRAMES = (60, 6)


def calibration():
    """(calibrated_cpu_f64, tolerance_factor) of ``artifacts/ACCURACY_TREND.json``."""
    with open(os.path.join(REPO, "artifacts", "ACCURACY_TREND.json")) as f:
        trend = json.load(f)
    return trend["calibrated_cpu_f64"], float(trend["tolerance_factor"])


@contextlib.contextmanager
def synth_env(env):
    """The ``SVIN_SYNTH_*`` settings for one run, restored after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def evaluate(out_dir: str, name: str, delta_s: float = 5.0) -> dict:
    """Sim(3)-ATE and RPE of ``<name>.txt`` against the revisiting
    trajectory's ground truth (the port's ``sim``)."""
    import torch

    from svin_tpu_torch import sim
    from svin_tpu_torch.evaluation import ate_rmse, rpe

    rows = np.loadtxt(os.path.join(out_dir, f"{name}.txt"), ndmin=2)
    t, p, q = rows[:, 0], rows[:, 1:4], rows[:, 4:8]
    traj = sim.default_trajectory(scale=0.4, ramp_tau=0.8)
    traj = traj._replace(r_lin=traj.r_lin * 0.0)
    T = sim.pose(traj, torch.as_tensor(t, dtype=torch.float64))
    gt_p, gt_q = T.r.numpy(), T.q.numpy()
    if len(p) < 3:
        return {"n_poses": int(len(p)), "ate_m": float("nan"), "rpe_trans_m": float("nan"),
                "rpe_rot_deg": float("nan")}
    rmse, _ = ate_rmse(p, gt_p, with_scale=True)
    r = rpe(t, p, q, gt_p, gt_q, delta_s=delta_s)
    return {"n_poses": int(len(p)), "ate_m": float(rmse), "rpe_trans_m": float(r["rpe_trans_rmse"]),
            "rpe_rot_deg": float(r["rpe_rot_rmse_deg"])}


def switch_stamps(out_dir: str) -> dict:
    """The first VIO->PRIMITIVE and PRIMITIVE->VIO stamps of ``switch_info.txt``."""
    lines = [x for x in open(os.path.join(out_dir, "switch_info.txt")).read().splitlines()
             if x.strip()]
    first = lambda tag: next((float(x.split()[0]) for x in lines if tag in x), None)  # noqa: E731
    return {"to_primitive_s": first("VIO->PRIMITIVE"), "to_vio_s": first("PRIMITIVE->VIO"),
            "n_switches": len(lines)}


def ply_vertices(path: str) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                return int(line.split()[-1])
    return 0


def quantiles(xs) -> dict:
    if not len(xs):
        return {"n": 0, "median": None, "p90": None}
    return {"n": int(len(xs)), "median": float(np.median(xs)),
            "p90": float(np.percentile(xs, 90))}


class Probe:
    """``run_synchronous.main``'s ``on_start``: times every ``add_frame``
    and ``add_keyframe`` (host ms, synchronized on the card), records the
    LM iteration budget the engine grants each frame and the steps it
    takes, and the kernel launches inside ``add_keyframe``. With
    ``profile=(first, n)`` on the card, frames first .. first + n - 1 (and
    the keyframes they export) run under ``torch.profiler`` and are left
    out of the timings."""

    def __init__(self, device: str, counters=None, profile=None):
        self.sync = device.startswith("cuda")
        self.counters = counters or {}
        self.profile_window = profile if self.sync else None
        self.profile = None
        self._prof = self._prof_t0 = None
        self.n_frames = 0
        self.frame_ms, self.budget, self.steps = [], [], []
        self.kf_ms, self.kf_nodes, self.kf_taken = [], [], []
        self.closer_launches = collections.Counter()  # launches inside add_keyframe

    def _synchronize(self):
        if self.sync:
            import torch

            torch.cuda.synchronize()

    def __call__(self, engine, closer):
        add_frame, add_keyframe = engine.add_frame, closer.add_keyframe

        def timed_frame(t, images):
            budget = engine._iteration_budget()  # what the frame's optimize is granted
            window = self.profile_window
            if window is not None and self.n_frames == window[0]:
                import torch

                self._synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.__enter__()
                self._prof_t0 = time.perf_counter()
            self._synchronize()
            t0 = time.perf_counter()
            r = add_frame(t, images)
            self._synchronize()
            if r is not None:
                if not self._prof is not None:
                    self.frame_ms.append(1e3 * (time.perf_counter() - t0))
                self.budget.append(int(budget))
                self.steps.append(int(r.lm_iterations))
            self.n_frames += 1
            if self._prof is not None and self.n_frames == window[0] + window[1]:
                wall = time.perf_counter() - self._prof_t0
                self._prof.__exit__(None, None, None)
                from svin_tpu_torch.utils.timing import device_profile_summary

                d = device_profile_summary(self._prof, wall, top=8)
                self.profile = {"frames": list(window), "busy_share": d["busy"],
                                "wall_s": d["wall"], "device_ms": d["ms"],
                                "device_ops": d["ops"], "top": d["top"]}
                self._prof = None
            return r

        def timed_keyframe(export):
            n = len(closer.keyframes)
            before = {k: fn.launches for k, fn in self.counters.items()}
            self._synchronize()
            t0 = time.perf_counter()
            out = add_keyframe(export)
            self._synchronize()
            if not self._prof is not None:
                self.kf_ms.append(1e3 * (time.perf_counter() - t0))
                self.kf_nodes.append(n)
            self.kf_taken.append(len(closer.keyframes) > n)
            self.closer_launches.update({k: fn.launches - before[k]
                                         for k, fn in self.counters.items()})
            return out

        engine.add_frame, closer.add_keyframe = timed_frame, timed_keyframe

    def summary(self) -> dict:
        ms = np.asarray(self.kf_ms)
        nodes = np.asarray(self.kf_nodes, dtype=np.int64)
        return {
            "add_frame_ms": quantiles(self.frame_ms),
            "add_keyframe_ms": quantiles(ms),
            "add_keyframe_ms_below_512": quantiles(ms[nodes < DENSE_NODES]),
            "add_keyframe_ms_past_512": quantiles(ms[nodes >= DENSE_NODES]),
            "lm_budget_per_frame": dict(sorted(collections.Counter(self.budget).items())),
            "lm_steps_per_frame": dict(sorted(collections.Counter(self.steps).items())),
            "lm_budget_mean": float(np.mean(self.budget)) if self.budget else None,
            "closer_launches": dict(self.closer_launches),
            "profile": self.profile,
        }


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter (and the solve's library route)."""
    from svin_tpu_torch.ops import hamming, solve

    return {"spd_solve_chol": solve.spd_solve_chol, "spd_solve_cluster": solve.spd_solve_cluster,
            "hamming_match": hamming.match_descriptors_cuda,
            "hamming_matrix": hamming.hamming_matrix_cuda,
            "hamming_nearest": hamming.nearest_codeword_cuda,
            "solve_spd_library": solve.solve_spd_library}


def run_cli(yaml_text: str, env: dict, out_dir: str, device: str, extra=(),
            profile=None) -> dict:
    """One ``run_synchronous`` run: rc, wall s, the probe, the launches of
    each kernel and the stage timers."""
    from svin_tpu_torch.apps import run_synchronous
    from svin_tpu_torch.utils import Timing

    os.makedirs(out_dir, exist_ok=True)
    cfg_path = os.path.join(out_dir, "rig.yaml")
    with open(cfg_path, "w") as f:
        f.write(yaml_text)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    probe = Probe(device, counters, profile)
    Timing.reset()
    with synth_env(env), contextlib.redirect_stdout(io.StringIO()):  # the CLI's own table
        t0 = time.perf_counter()
        rc = run_synchronous.main([cfg_path, "--synthetic", out_dir, "--device", device,
                                   *extra], on_start=probe)
        wall = time.perf_counter() - t0
    return {"rc": rc, "wall_s": wall, "probe": probe,
            "launches": {k: fn.launches for k, fn in counters.items()},
            "stages": Timing.summary()}


def check_bounds(name: str, m: dict, cal: dict, tol: float) -> list:
    """The JAX tests' assertions on configuration ``name``'s metrics ``m``:
    a list of (what, value, bound, held)."""
    vio, loop, robust = m["svin_vio"], m["svin_loop"], m.get("svin_robust")
    out = []

    def hold(what, value, bound, ok):
        out.append({"what": what, "value": value, "bound": bound, "held": bool(ok)})

    if name == "stereo":
        hold("VIO poses >=", vio["n_poses"], 180, vio["n_poses"] >= 180)
        b = tol * cal["svin_vio_ate_m"]
        hold("VIO ATE m <", vio["ate_m"], b, vio["ate_m"] < b)
        b = tol * cal["svin_vio_rpe_trans_m"]
        hold("VIO RPE m <", vio["rpe_trans_m"], b, vio["rpe_trans_m"] < b)
        hold("loop poses >=", loop["n_poses"], 50, loop["n_poses"] >= 50)
        b = tol * cal["svin_loop_ate_m"]
        hold("loop ATE m <", loop["ate_m"], b, loop["ate_m"] < b)
        b = 0.75 * vio["ate_m"]
        hold("loop ATE m < 0.75 x VIO", loop["ate_m"], b, loop["ate_m"] < b)
        hold("robust poses >=", robust["n_poses"], 50, robust["n_poses"] >= 50)
        b = tol * cal["svin_robust_ate_m"]
        hold("robust ATE m <", robust["ate_m"], b, robust["ate_m"] < b)
        sw = m["switch"]
        t_p, t_v = sw["to_primitive_s"], sw["to_vio_s"]
        hold("VIO->PRIMITIVE s in", t_p, [30.0, 34.0], t_p is not None and 30.0 <= t_p <= 34.0)
        hold("PRIMITIVE->VIO s after the switch", t_v, t_p,
             t_p is not None and t_v is not None and t_v > t_p)
        hold("outputs missing", sorted(OUTPUTS - set(m["outputs"])), [], OUTPUTS <= set(m["outputs"]))
        hold("global map vertices >", m["map_vertices"], 50, m["map_vertices"] > 50)
    elif name == "6dof":
        hold("VIO poses >=", vio["n_poses"], 120, vio["n_poses"] >= 120)
        hold("loop poses >=", loop["n_poses"], 40, loop["n_poses"] >= 40)
        b = 1.05 * vio["ate_m"]
        hold("loop ATE m < 1.05 x VIO", loop["ate_m"], b, loop["ate_m"] < b)
        hold("loop RPE deg < VIO", loop["rpe_rot_deg"], vio["rpe_rot_deg"],
             loop["rpe_rot_deg"] < vio["rpe_rot_deg"])
    elif name == "mono":
        hold("VIO poses >=", vio["n_poses"], 100, vio["n_poses"] >= 100)
        hold("VIO ATE m <", vio["ate_m"], 0.8, vio["ate_m"] < 0.8)
        hold("loop poses >=", loop["n_poses"], 30, loop["n_poses"] >= 30)
        b = 1.05 * vio["ate_m"]
        hold("loop ATE m <= 1.05 x VIO", loop["ate_m"], b, loop["ate_m"] <= b)
        need = {"svin_vio.txt", "svin_loop.txt", "state.csv"}
        hold("outputs missing", sorted(need - set(m["outputs"])), [], need <= set(m["outputs"]))
    return out


def card() -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        line = "not measured"
    return {"nvidia_smi": line}


def run_config(name: str, device: str, tmp: str, duration=None) -> dict:
    yaml_text, env = CONFIGS[name]
    env = dict(env)
    full = duration is None
    if not full:
        env["SVIN_SYNTH_DURATION"] = str(duration)
    out_dir = os.path.join(tmp, name)
    run = run_cli(yaml_text, env, out_dir, device, profile=PROFILE_FRAMES)
    if run["rc"] != 0:
        raise RuntimeError(f"gauntlet [{name}]: run_synchronous returned {run['rc']}")
    probe = run["probe"]
    stats = json.load(open(os.path.join(out_dir, "loop_stats.json")))
    n_frames = len(probe.steps)  # frames with a result
    m = {
        "settings": env, "full_length": full,
        "svin_vio": evaluate(out_dir, "svin_vio"), "svin_loop": evaluate(out_dir, "svin_loop"),
        "svin_robust": evaluate(out_dir, "svin_robust"),
        "switch": switch_stamps(out_dir),
        "outputs": sorted(os.listdir(out_dir)),
        "map_vertices": ply_vertices(os.path.join(out_dir, "global_map.ply")),
        "frames": n_frames,
        "keyframe_exports": len(probe.kf_taken),
        "closer_keyframes": int(stats["n_keyframes"]),
        "loops": int(stats["n_loops"]), "pose_graph_solves": len(stats["pgo_log"]),
        "wall_s": run["wall_s"], "frames_per_s": n_frames / run["wall_s"],
        **probe.summary(),
        "launches": run["launches"], "stages": run["stages"],
    }
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts", "GAUNTLET_torch.json"))
    ap.add_argument("--duration", type=float, default=None,
                    help="cut every sequence to this many seconds (bounds not held)")
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the gauntlet runs on the card (--device cpu "
                               "runs it on the CPU)")
        from svin_tpu_torch.ops import cuda_lib

        cuda_lib.load()  # build the kernels before the first timed frame
    cal, tol = calibration()
    record = {
        "what": ("The JAX package's accuracy gauntlet (tests/test_gauntlet.py, "
                 "tests/test_gauntlet_variants.py) through the port's run_synchronous on the "
                 "port's own --synthetic sequences, at the config's 35 ms LM budget."),
        "tool": "tools/gauntlet_torch.py",
        "device": args.device, "card": card() if args.device.startswith("cuda") else None,
        "dtype": "float32" if args.device.startswith("cuda") else "float64",
        "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "torch": torch.__version__,
        "calibration": {"calibrated_cpu_f64": cal, "tolerance_factor": tol,
                        "note": "the artifact's tpu_f32 row is a TPU figure and sets no bound"},
        "configs": {},
    }
    failed = []
    with tempfile.TemporaryDirectory(prefix="gauntlet_torch_") as tmp:
        for name in CONFIGS:
            print(f"[gauntlet] {name} ...", flush=True)
            m = run_config(name, args.device, tmp, args.duration)
            m["bounds"] = check_bounds(name, m, cal, tol) if m["full_length"] else []
            failed += [f"{name}: {b}" for b in m["bounds"] if not b["held"]]
            record["configs"][name] = m
            print(f"[gauntlet] {name}: {m['frames']} frames in {m['wall_s']:.1f} s "
                  f"({m['frames_per_s']:.3f} frames/s), ATE vio {m['svin_vio']['ate_m']:.4f} "
                  f"loop {m['svin_loop']['ate_m']:.4f} robust {m['svin_robust']['ate_m']:.4f} m, "
                  f"keyframes {m['closer_keyframes']}, loops {m['loops']}, switch {m['switch']}, "
                  f"add_frame ms {m['add_frame_ms']}, add_keyframe ms {m['add_keyframe_ms']}, "
                  f"LM budget {m['lm_budget_per_frame']}, launches {m['launches']}", flush=True)
    record["passed"] = not failed
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.out}")
    if failed:
        print("bounds not held:\n  " + "\n  ".join(failed))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
