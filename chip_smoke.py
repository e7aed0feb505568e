#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port: build its CUDA kernels, hold each to
its plain PyTorch version on the card, then drive the VIO backend's
per-frame step (projection-gated map matching + optimize / marginalize /
prune) at the shipped engine shapes and check what comes out.

    python3 chip_smoke.py

Needs one CUDA card (it exits nonzero without one) and ``nvcc`` (the
kernels build into ``svin_tpu_torch/_build/`` at first use). Phases:

1. Device and build: the card's name and power limit, the kernel build.
2. Kernels: B2 (Hamming distance matrix) exactly equal to its plain version
   at the three matchers' shapes (map: 2 cameras x 400 keypoints x 512
   landmarks; stereo and temporal: 400 x 400, 2-D) and at ragged shapes; B1
   (dense SPD solve) on Jacobi-equilibrated random SPD systems at D = 7,
   120, 132 with relative residual ≤ 1e-4 and relative distance to the
   plain (Cholesky) solution ≤ 1e-3. Median times of kernel and plain
   version at the slice's shapes, CUDA events.
3. Slice: S=8 states, 512 landmark slots (256 live), 4096 observation
   slots, two 752x480 cameras, K=400 keypoints per camera, 10 LM
   iterations, float32, with depth factors on every state and sonar-range
   factors on three. The LM loop runs once under the sync debug mode that
   raises on a host synchronisation. Five frames (distinct seeds) through
   ``BackendStep``, with launch counts reset just before and read just
   after; per frame:
   both kernels launched, outputs finite, cost reduced with accepted
   steps, positions closer to the truth, most true associations matched
   and none wrongly, and the same step with the plain versions on the card
   agreeing (identical matches; cost within 1%, positions within 5 mm:
   f32 LM steps carry the solvers' rounding and the run-dependent order of
   CUDA index_add_ into mm-level differences, printed beside a rerun's).
   Median per-frame time with kernels and with plain versions.

4. Engine: the port's ``VioEngine.add_frame`` (the serial path) at the
   shipped underwater configuration (``configs/underwater_sonar_depth.yaml``:
   two 800x600 radial-tangential cameras, CLAHE, 3-level pyramid, 400
   keypoints per camera, S=8, 10 LM iterations, depth and sonar), float32,
   on the port's synthetic sequence: start-from-rest trajectory, 10 Hz for
   3 s (29 frames), depth and sonar events, rendered on the card before the
   run. B2 first on the first frame's own descriptors as the stereo matcher
   pairs them, exactly equal to its plain version. Then at a fixed 10 LM
   iterations per frame (``time_limit`` 0; the config's 35 ms budget
   follows the wall clock) under deterministic CUDA algorithms: kernels,
   plain versions, kernels again. The rerun must repeat the kernel run
   exactly; the plain run must make the same decisions (keyframes, tracked
   keypoints) on at least SHARED_MIN_FRAMES leading frames, with positions
   within POS_TOL_MM of the kernel run's there (where the runs part is
   printed). Then at the config's budget, four runs in turns: plain
   versions, kernels (the main path: launch counts from 0 just before,
   read just after), kernels, plain versions. Checks, on every run: a
   result for every frame, median tracked keypoints >= 20, the window
   filled and marginalized, a keyframe export with the ABI keys, finite
   landmark covariances, both kernels launched (none in the plain runs),
   and an SE(3)-aligned ATE within ATE_FACTOR x the JAX engine's own ATE on
   the same events at the fixed iteration count (CPU, float32;
   tools/engine_ate_reference.py): 1.5 x for the fixed-count runs, 2 x
   for the budget runs, whose iterations follow the wall clock. Prints per-frame ``add_frame`` median
   and p90 (host clock after a synchronize), the stage timers' medians,
   and launches per frame.

The second-to-last line of standard output is the kernels' JSON record; the
last is ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from svin_tpu_torch import problems, sim
from svin_tpu_torch.convert import tree_to
from svin_tpu_torch.estimator import WindowConfig, optimize
from svin_tpu_torch.kinematics import Transformation
from svin_tpu_torch.evaluation import ate_rmse
from svin_tpu_torch.ops import cuda_lib, hamming, solve
from svin_tpu_torch.pipeline import BackendStep, VioEngine, load_config, run_events, synthetic_sequence
from svin_tpu_torch.utils import Timing

N_FRAMES = 5
K = 400
SOLVE_D = 120  # S·15 at the shipped window with fixed extrinsics
CFG = WindowConfig(num_states=8, num_landmarks=512, num_obs=4096, max_iterations=10)
ENGINE_CONFIG = "configs/underwater_sonar_depth.yaml"
# the JAX engine's SE(3)-aligned ATE on this sequence's events at a fixed 10
# LM iterations per frame, float32 on the CPU (tools/engine_ate_reference.py)
JAX_ATE_M = 0.009505
# runs at that fixed count repeat themselves (deterministic algorithms); runs
# at the config's wall-clock budget do not, and spread wider
ATE_FACTOR = {"fixed": 1.5, "budget": 2.0}
# kernels vs plain engine at the fixed iteration count: the same decisions on
# at least the first SHARED_MIN_FRAMES frames, positions within POS_TOL_MM there
SHARED_MIN_FRAMES = 3
POS_TOL_MM = 5.0
EXPORT_KEYS = ("kf_index", "timestamp", "image", "T_WC_r", "T_WC_q", "points_W", "landmark_ids",
               "keypoints_uv", "quality", "num_tracked", "num_new", "quadrant_counts",
               "response_strengths", "covisibilities", "point_covisibilities", "sequence")
STAGES = ("2.0 frame_total", "2.1 detect_describe", "2.1.2 detect_fetch", "2.4 matching",
          "2.4.1 match_dispatch", "2.4.2 match_fetch", "2.5 stereo_init", "2.6 temporal_init",
          "3.1 optimization", "3.1.1 opt_dispatch", "3.1.2 opt_fetch", "3.2 kf_export")


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, runs: int = 100, warmup: int = 10) -> float:
    """Median over ``runs`` of one call's device time (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def equilibrated_spd(rng, D, dev):
    A = rng.standard_normal((D, D))
    H = A @ A.T + D * np.eye(D)
    s = 1.0 / np.sqrt(np.diag(H))
    b = rng.standard_normal(D) * s
    H = H * np.outer(s, s)
    return (torch.as_tensor(H, dtype=torch.float32, device=dev),
            torch.as_tensor(b, dtype=torch.float32, device=dev))


def kernel_phase(dev) -> dict:
    rng = np.random.default_rng(0)
    words = lambda shape: torch.as_tensor(  # noqa: E731
        rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32),
        device=dev)

    # B2: exact at the three matchers' shapes (map: both cameras' keypoints
    # against the landmark table; stereo and temporal: one camera's
    # keypoints against another's, 2-D) and at ragged ones
    for a_shape, b_shape in (((2, K, 8), (512, 8)), ((K, 8), (K, 8)), ((1, 1, 8), (1, 8)),
                             ((1, 129, 8), (257, 8)), ((1, K, 8), (1, 8)), ((129, 8), (257, 8))):
        a, b = words(a_shape), words(b_shape)
        got = hamming.hamming_matrix(a, b)
        want = hamming.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hamming kernel != plain at {a_shape}x{b_shape}")
    a, b = words((2, K, 8)), words((512, 8))
    ham_err = int((hamming.hamming_matrix(a, b) - hamming.hamming_matrix_plain(a, b)).abs().max())
    ham_ms = event_ms(lambda: hamming.hamming_matrix(a, b))
    ham_plain_ms = event_ms(lambda: hamming.hamming_matrix_plain(a, b))
    log(f"B2 hamming (2,{K},8)x(512,8) (map): exact; kernel {ham_ms:.4f} ms, plain "
        f"{ham_plain_ms:.4f} ms")
    a, b = words((K, 8)), words((K, 8))
    log(f"B2 hamming ({K},8)x({K},8) (stereo, temporal): exact; kernel "
        f"{event_ms(lambda: hamming.hamming_matrix(a, b)):.4f} ms, plain "
        f"{event_ms(lambda: hamming.hamming_matrix_plain(a, b)):.4f} ms")

    # B1: stated tolerance on equilibrated SPD systems
    for D in (7, SOLVE_D, 132):
        H, rhs = equilibrated_spd(rng, D, dev)
        x = solve.solve_spd(H, rhs)
        ref = solve.solve_spd_plain(H, rhs)
        res = float(torch.linalg.norm(H @ x - rhs) / torch.linalg.norm(rhs))
        dist = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
        log(f"B1 solve D={D}: relative residual {res:.3e}, relative distance to plain {dist:.3e}")
        if not (res <= 1e-4 and dist <= 1e-3):
            raise AssertionError(f"spd_solve_gj out of tolerance at D={D}")
        if D == SOLVE_D:
            solve_err = float((x - ref).abs().max())
            solve_ms = event_ms(lambda: solve.solve_spd(H, rhs))
            solve_plain_ms = event_ms(lambda: solve.solve_spd_plain(H, rhs))
    log(f"B1 solve D={SOLVE_D}: kernel {solve_ms:.4f} ms, plain {solve_plain_ms:.4f} ms")
    return {
        "spd_solve_gj": dict(max_abs_err=solve_err, ms=solve_ms, plain_ms=solve_plain_ms),
        "hamming_matrix": dict(max_abs_err=ham_err, ms=ham_ms, plain_ms=ham_plain_ms),
    }


def make_case(seed: int, dev):
    """One frame's problem at the shipped shapes, built on the host in
    float64 and moved to the card in float32."""
    rng = np.random.default_rng(100 + seed)
    w, f, rig, truth = problems.build_window_problem(rng, CFG, n_landmarks=256)
    f = problems.attach_depth_and_sonar(f, truth, w, [2, 4, 6], rng)
    lm_desc = problems.random_descriptors(rng, CFG.num_landmarks)
    frame, tidx = problems.make_frame(rng, w, truth, rig, lm_desc, slot=CFG.num_states - 1, K=K)
    victim = seed % (CFG.num_states - 1)
    on = lambda t: tree_to(t, dev, torch.float32)  # noqa: E731
    return dict(w=on(w), f=on(f), rig=on(rig), frame=on(frame), tidx=tidx,
                r_true=truth["r"].to(dev, torch.float32), victim=victim)


def step_ms(step, c) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(c["w"], c["f"], c["frame"], CFG.max_iterations, c["victim"])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def slice_phase(dev) -> dict:
    t0 = time.perf_counter()
    cases = [make_case(i, dev) for i in range(N_FRAMES)]
    log(f"slice problems built in {time.perf_counter() - t0:.1f} s "
        f"(S={CFG.num_states}, L={CFG.num_landmarks}, O={CFG.num_obs}, K={K}, "
        f"obs live {[int(c['f'].reproj.valid.sum()) for c in cases]})")
    rig = cases[0]["rig"]
    step = BackendStep(rig, problems.IMU_PARAMS, CFG).to(dev)
    plain = BackendStep(rig, problems.IMU_PARAMS, CFG, solve=solve.solve_spd_plain,
                        hamming=hamming.hamming_matrix_plain).to(dev)
    c0 = cases[0]
    step(c0["w"], c0["f"], c0["frame"], CFG.max_iterations, c0["victim"])  # warm-up
    torch.cuda.synchronize()
    # the LM loop never waits on the host: a synchronisation inside it raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        optimize(c0["w"], c0["f"], rig, step.imu_p, CFG)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("LM loop (10 iterations, B1 kernel) ran with no host synchronisation")

    # ---- the main path: counts from 0, read right after ----
    solve.spd_solve_gj.launches = 0
    hamming.hamming_matrix_cuda.launches = 0
    outs = []
    for i, c in enumerate(cases):
        n_s, n_h = solve.spd_solve_gj.launches, hamming.hamming_matrix_cuda.launches
        outs.append(step(c["w"], c["f"], c["frame"], CFG.max_iterations, c["victim"]))
        torch.cuda.synchronize()
        if not (solve.spd_solve_gj.launches > n_s and hamming.hamming_matrix_cuda.launches > n_h):
            raise AssertionError(f"frame {i}: a kernel was not launched")
    launches = {"spd_solve_gj": solve.spd_solve_gj.launches,
                "hamming_matrix": hamming.hamming_matrix_cuda.launches}
    log(f"main path launches over {N_FRAMES} frames: {launches}")

    for i, (c, o) in enumerate(zip(cases, outs)):
        # lm_cov = inv(Hll + 1e-6·I): a landmark seen once has a rank-2 Hll
        # and the 1e-6 shift is below float32 resolution, so its covariance
        # is inf in float32 (as in the JAX package); check the others
        f = c["f"].reproj
        n_obs = torch.zeros(CFG.num_landmarks, device=dev).index_add_(
            0, f.lm_idx.long(), f.valid.float())
        leaves = [o.rays, o.window.r, o.window.q, o.window.hp_W, o.factors.marg.H,
                  o.factors.marg.b, o.lm_cov[n_obs >= 2], o.prune_err, o.cost]
        if not all(bool(torch.isfinite(x).all()) for x in leaves):
            raise AssertionError(f"frame {i}: non-finite output")
        cost0, cost, iters = float(o.cost0), float(o.cost), int(o.iterations)
        if not (cost < cost0 and iters >= 1):
            raise AssertionError(f"frame {i}: cost {cost0} -> {cost}, {iters} accepted")
        # position error vs truth, on the optimized window (before the shift)
        keep = [s for s in range(CFG.num_states) if s != c["victim"]]
        err0 = float((c["w"].r[keep] - c["r_true"][keep]).norm(dim=-1).mean())
        err1 = float((o.window.r[: CFG.num_states - 1] - c["r_true"][keep]).norm(dim=-1).mean())
        if not err1 < err0:
            raise AssertionError(f"frame {i}: position error {err0} -> {err1}")
        mv, mi, tidx = o.match_valid.cpu().numpy(), o.match_idx.cpu().numpy(), c["tidx"]
        n_true = int((tidx >= 0).sum())
        correct = int((mv & (mi == tidx)).sum())
        wrong = int((mv & (mi != tidx)).sum())
        if correct < 0.9 * n_true or wrong:
            raise AssertionError(f"frame {i}: matched {correct}/{n_true} true, {wrong} wrong")
        # kernels vs plain versions. The two solvers round differently and
        # CUDA index_add_ sums in a run-dependent order; ten f32 LM steps
        # carry that into mm-level position differences along weakly
        # observed directions (a rerun of the kernel step shows the same
        # order), well under the estimate's own error vs truth.
        p = plain(c["w"], c["f"], c["frame"], CFG.max_iterations, c["victim"])
        rerun = step(c["w"], c["f"], c["frame"], CFG.max_iterations, c["victim"])
        d_cost = abs(float(p.cost) - cost) / float(p.cost)
        d_pos = float((p.window.r - o.window.r).abs().max())
        d_rerun = float((rerun.window.r - o.window.r).abs().max())
        if not (torch.equal(p.match_idx, o.match_idx) and d_cost <= 1e-2 and d_pos <= 5e-3):
            raise AssertionError(f"frame {i}: kernels vs plain: cost {d_cost:.2e}, pos {d_pos:.2e} m")
        log(f"frame {i}: victim {c['victim']}, cost {cost0:.1f} -> {cost:.3f} ({iters} accepted), "
            f"mean position error {err0 * 1e3:.1f} -> {err1 * 1e3:.1f} mm, matches {correct}/{n_true} "
            f"(0 wrong); vs plain: cost rel {d_cost:.1e}, max |dr| {d_pos:.1e} m; "
            f"kernel rerun max |dr| {d_rerun:.1e} m")

    k_ms, p_ms = [], []
    for _ in range(2):
        for c in cases:  # plain, kernel, kernel, plain
            p_ms.append(step_ms(plain, c))
            k_ms.append(step_ms(step, c))
            k_ms.append(step_ms(step, c))
            p_ms.append(step_ms(plain, c))
    log(f"per-frame step: kernels median {statistics.median(k_ms):.2f} ms, "
        f"plain median {statistics.median(p_ms):.2f} ms ({len(k_ms)} runs each)")
    return launches


class TimedEngine:
    """An engine whose ``add_frame`` is timed on the host clock, the device
    synchronized before each reading."""

    def __init__(self, engine):
        self.engine = engine
        self.frame_ms = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def add_frame(self, t, images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = self.engine.add_frame(t, images)
        torch.cuda.synchronize()
        self.frame_ms.append(1e3 * (time.perf_counter() - t0))
        return r


def drive_engine(name, cfg, events, gt, dev, verbose=True, **kernels) -> dict:
    """One run of the serial engine path over ``events``; checks and prints
    what came out (with ``verbose``, per frame and per stage)."""
    engine = TimedEngine(VioEngine(cfg, device=dev, **kernels))
    Timing.reset()
    solve.spd_solve_gj.launches = 0
    hamming.hamming_matrix_cuda.launches = 0
    results = run_events(engine, events)
    torch.cuda.synchronize()
    launches = {"spd_solve_gj": solve.spd_solve_gj.launches,
                "hamming_matrix": hamming.hamming_matrix_cuda.launches}
    eng = engine.engine
    n_frames = sum(ev.kind == "frame" for ev in events)
    if len(results) != n_frames:
        raise AssertionError(f"{name}: {len(results)} results for {n_frames} frames")
    tracked = [r.num_tracked for r in results]
    if not np.median(tracked[1:]) >= 20:
        raise AssertionError(f"{name}: median tracked {np.median(tracked[1:])}")
    S = eng.wcfg.num_states
    if not (eng.n_states == S - 1 and any(k[1] for k in eng._opt_programs)):
        raise AssertionError(f"{name}: window not filled and marginalized (n_states {eng.n_states})")
    kfs = [r.keyframe_export for r in results if r.keyframe_export is not None]
    if not kfs or any(k not in kf for kf in kfs for k in EXPORT_KEYS):
        raise AssertionError(f"{name}: keyframe export missing or without the ABI keys")
    if not np.isfinite(eng._lm_cov).all():
        raise AssertionError(f"{name}: non-finite landmark covariance in the gate table")
    est = np.stack([r.T_WS.r for r in results])
    ate, _ = ate_rmse(est, gt, with_scale=False)
    _, al = ate_rmse(est, gt, with_scale=True)
    factor = ATE_FACTOR["fixed" if cfg.time_limit <= 0 else "budget"]
    if not ate <= factor * JAX_ATE_M:
        raise AssertionError(f"{name}: ATE {ate:.6f} m over the bound {factor * JAX_ATE_M:.6f} m")
    ms = engine.frame_ms[1:]  # the first frame initializes (no solve)
    if not verbose:
        log(f"engine [{name}]: ATE {ate:.6f} m, add_frame median "
            f"{statistics.median(ms):.2f} ms, p90 {float(np.percentile(ms, 90)):.2f} ms")
        return dict(launches=launches, ate=ate, frame_ms=ms, results=results)
    log(f"engine [{name}]: {len(results)} frames, {len(kfs)} keyframes, median tracked "
        f"{np.median(tracked[1:]):.0f}, n_states {eng.n_states}/{S}, ATE (SE(3)) {ate:.6f} m "
        f"(bound {factor * JAX_ATE_M:.6f} m = {factor} x the JAX engine's {JAX_ATE_M:.6f} m), "
        f"Sim(3) scale {al.scale:.4f}")
    log(f"  tracked per frame {tracked}")
    log(f"  LM iterations per frame {[r.lm_iterations for r in results]}")
    log(f"  add_frame per frame (frames 2-{len(results)}): median {statistics.median(ms):.2f} ms, "
        f"p90 {float(np.percentile(ms, 90)):.2f} ms, max {max(ms):.2f} ms")
    stages = {k: statistics.median(list(Timing.get(k).window)) * 1e3
              for k in STAGES if Timing.get(k) is not None}
    log("  stage medians (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    log(f"  launches {launches}, per frame "
        f"{ {k: round(v / len(results), 2) for k, v in launches.items()} }")
    return dict(launches=launches, ate=ate, frame_ms=ms, results=results)


def frame_descriptor_check(cfg, frame, dev) -> None:
    """B2 on one rendered frame's own descriptors, computed by the engine's
    frontend and matched as the stereo matcher matches them: camera 0's
    (K,8) words against camera 1's, exactly equal to the plain version."""
    eng = VioEngine(cfg, device=dev)
    level = Transformation(r=np.zeros(3), q=np.array([0.0, 0.0, 0.0, 1.0]))
    _, descs, valids, *_ = eng._detect_describe(frame.images, level)
    a, b = (torch.as_tensor(d, device=dev) for d in descs[:2])
    got = hamming.hamming_matrix(a, b)
    want = hamming.hamming_matrix_plain(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"hamming kernel != plain on frame descriptors {tuple(a.shape)}x{tuple(b.shape)}")
    log(f"B2 hamming on the first frame's descriptors {tuple(a.shape)}x{tuple(b.shape)} "
        f"({int(valids[0].sum())} and {int(valids[1].sum())} valid keypoints): exact")


def compare_runs(a: dict, b: dict) -> dict:
    """Frame by frame, two engine runs on the same events: how many leading
    frames make the same decisions (keyframe, tracked keypoints), and the
    position difference per frame (mm)."""
    pairs = list(zip(a["results"], b["results"]))
    same = [x.is_keyframe == y.is_keyframe and x.num_tracked == y.num_tracked for x, y in pairs]
    return dict(
        shared=same.index(False) if False in same else len(same),
        kf_diff=sum(x.is_keyframe != y.is_keyframe for x, y in pairs),
        pos_mm=[1e3 * float(np.linalg.norm(np.asarray(x.T_WS.r) - np.asarray(y.T_WS.r)))
                for x, y in pairs],
    )


def engine_input(dev):
    """(config, events, ground-truth positions per frame): the port's
    synthetic sequence at the underwater configuration, rendered on the
    card, images handed over as host float32 arrays, as a camera delivers
    them."""
    cfg = load_config(ENGINE_CONFIG)
    events, renderer = synthetic_sequence(
        cfg.build_rig(torch.float64, dev), duration=3.0, cam_rate=10.0,
        imu_rate=float(cfg.imu.rate), imu_params=cfg.imu, seed=0, n_points=600,
        traj=sim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0, depth_offset=3.0,
        t_first_frame=0.12, depth_enabled=True, sonar_enabled=True, sonar_T_SSo=cfg.T_SSo,
    )
    events = list(events)  # renders every frame on the card
    gt = np.stack([renderer.pose(ev.t).r.numpy() for ev in events if ev.kind == "frame"])
    return cfg, events, gt


def engine_phase(dev) -> dict:
    t0 = time.perf_counter()
    cfg, events, gt = engine_input(dev)
    torch.cuda.synchronize()
    frames = [ev for ev in events if ev.kind == "frame"]
    cam = cfg.cameras[0]
    log(f"engine input: {len(frames)} frames of {len(frames[0].images)} x {cam.width}x{cam.height}, "
        f"{len(events)} events, rendered in {time.perf_counter() - t0:.1f} s")
    plain_kw = dict(solve=solve.solve_spd_plain, hamming=hamming.hamming_matrix_plain)
    frame_descriptor_check(cfg, frames[0], dev)

    # a fixed LM iteration count (time_limit 0: the config's 35 ms budget
    # follows the wall clock) and deterministic CUDA algorithms (index_add_
    # sums in a fixed order), so a kernel rerun repeats itself exactly and
    # the kernel and plain engines differ only by the kernels' rounding:
    # frame by frame, they make the same decisions until a rounding
    # difference flips a discrete one (a match, an inlier, a keyframe), and
    # from then on are two runs held only by the ATE bound
    fixed = dataclasses.replace(cfg, time_limit=0.0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        k_fix = drive_engine("kernels, 10 LM iterations", fixed, events, gt, dev, verbose=False)
        p_fix = drive_engine("plain, 10 LM iterations", fixed, events, gt, dev, verbose=False,
                             **plain_kw)
        k_fix2 = drive_engine("kernels again, 10 LM iterations", fixed, events, gt, dev,
                              verbose=False)
    finally:
        torch.use_deterministic_algorithms(False)
    vs_plain, vs_rerun = compare_runs(k_fix, p_fix), compare_runs(k_fix, k_fix2)
    for what, c in (("kernels vs plain", vs_plain), ("kernels vs kernels rerun", vs_rerun)):
        n = c["shared"]
        log(f"engine, 10 LM iterations, {what}: same keyframe decisions and tracked counts on "
            f"the first {n} frames (|dr| there max {max(c['pos_mm'][:n]):.3f} mm); keyframe "
            f"decisions differ on {c['kf_diff']} frames; |dr| per frame (mm) "
            f"{[round(x, 2) for x in c['pos_mm']]}")
    if not (vs_rerun["shared"] == len(frames) and max(vs_rerun["pos_mm"]) == 0.0):
        raise AssertionError("engine, 10 LM iterations: the kernel engine did not repeat itself")
    if not (vs_plain["shared"] >= SHARED_MIN_FRAMES
            and max(vs_plain["pos_mm"][:vs_plain["shared"]]) <= POS_TOL_MM):
        raise AssertionError(f"engine, 10 LM iterations: kernels vs plain out of tolerance (same "
                             f"decisions on >= {SHARED_MIN_FRAMES} frames, |dr| <= {POS_TOL_MM} "
                             f"mm there)")

    # at the config's budget, in turns: plain, kernels (the main path: its
    # launch counts are the ones reported), kernels, plain
    plain = drive_engine("plain", cfg, events, gt, dev, **plain_kw)
    out = drive_engine("kernels", cfg, events, gt, dev)
    again = drive_engine("kernels, again", cfg, events, gt, dev, verbose=False)
    plain_again = drive_engine("plain, again", cfg, events, gt, dev, verbose=False, **plain_kw)
    if not all(v > 0 for r in (out, again, k_fix, k_fix2) for v in r["launches"].values()):
        raise AssertionError(f"engine: a kernel was not launched: {out['launches']}")
    if any(v for r in (plain, plain_again, p_fix) for v in r["launches"].values()):
        raise AssertionError("engine [plain]: a kernel was launched")
    k_ms, p_ms = out["frame_ms"] + again["frame_ms"], plain["frame_ms"] + plain_again["frame_ms"]
    log(f"engine add_frame over both runs each (plain, kernels, kernels, plain): kernels median "
        f"{statistics.median(k_ms):.2f} ms, p90 {float(np.percentile(k_ms, 90)):.2f} ms; plain "
        f"median {statistics.median(p_ms):.2f} ms, p90 {float(np.percentile(p_ms, 90)):.2f} ms")
    log(f"engine ATE: 10 LM iterations: kernels {k_fix['ate']:.6f} m and {k_fix2['ate']:.6f} m, "
        f"plain {p_fix['ate']:.6f} m, JAX engine (CPU, float32) {JAX_ATE_M:.6f} m; at the "
        f"config's budget: kernels {out['ate']:.6f} m and {again['ate']:.6f} m, plain "
        f"{plain['ate']:.6f} m and {plain_again['ate']:.6f} m")
    return out["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.load()
    log(f"kernel build+load {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_lib.build_seconds if cuda_lib.build_seconds is not None else 'cached'})")
    if cuda_lib.build_seconds is not None:
        with open(cuda_lib.BUILD_LOG) as fh:
            for line in fh:
                if "Used" in line or "spill" in line:
                    log("  ptxas: " + line.strip().removeprefix("ptxas info    : "))

    timings = kernel_phase(dev)
    launches = slice_phase(dev)
    engine_launches = engine_phase(dev)
    launches = {k: launches[k] + engine_launches[k] for k in launches}
    log(f"launches summed over the backend-step and engine paths: {launches}")

    record = {"kernels": [
        {"name": "spd_solve_gj", "route": "cuda", "source": "svin_tpu_torch/csrc/spd_solve_gj.cu",
         "replaces": "svin_tpu/ops/solve.py:59", "launches": launches["spd_solve_gj"],
         **timings["spd_solve_gj"]},
        {"name": "hamming_matrix", "route": "cuda", "source": "svin_tpu_torch/csrc/hamming.cu",
         "replaces": "svin_tpu/ops/hamming.py:44", "launches": launches["hamming_matrix"],
         **timings["hamming_matrix"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
