#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port: build its CUDA kernels, hold each to
its plain PyTorch version on the card, then drive the VIO backend's
per-frame step, the engine (serial and pipelined), the loop closer (to past
2,048 keyframes), the offline app, global bundle adjustment (to the Cave
shape), the flagship step and the sharded solvers over processes at the
shipped shapes and check what comes out.

    python3 chip_smoke.py

Needs one CUDA card (it exits nonzero without one) and ``nvcc`` (the
kernels build into ``svin_tpu_torch/_build/`` at first use). Phases:

1. Device and build: the card's name and power limit, the kernel build
   (one ``nvcc`` per source, all started together).
2. Kernels, each held to its plain version, then timed at the main path's
   shapes in turns (kernel, library, ...) by ``device_ms``: device ms per
   launch from 200 launches back to back between two CUDA events (a spin
   kernel ahead keeps the card busy while the host enqueues them), and host
   µs per call on the host clock. For B1, the fused matcher and what they
   are compared with (several launches per call), also the device time per
   call summed from a ``torch.profiler`` trace (``traced_ms``), gaps not
   counted, and the device operations per call.
   - B2's distance matrix exactly equal to its plain version at the three
     matchers' shapes (map: 2 cameras x 400 keypoints x 512 landmarks;
     stereo and temporal: 400 x 400, 2-D) and at ragged shapes; timed
     beside one fp16 ``torch.matmul`` of the unpacked ±1 bits (the JAX
     package's ``hamming_matrix_mxu`` formula, exact in fp16; unpacking
     not timed).
   - B1, the blocked-Cholesky solve, on Jacobi-equilibrated random SPD
     systems at D = 7, 120, 132 with relative residual ≤ 1e-4 and relative
     distance to the plain (Cholesky) solution ≤ 1e-3, and a batch of four
     at D = 120 with one non-SPD system that must come out all NaN; timed
     at D = 120 and 132 beside ``cholesky_ex`` + ``cholesky_solve``. Past
     one block's shared memory, the cluster kernel's launch plan
     (``solve.cluster_plan``) and ``cudaOccupancyMaxActiveClusters`` at
     each D (the run fails if the card cannot hold one such cluster), then
     ``solve_spd`` at D = 330, 384, 512, 768, 1020, 1024 through the cluster
     kernel (the same tolerances, the route's count), a batch of three at
     D = 384 with one non-SPD system, float64 and D = 1100 through the
     library route (float64 equal to the plain solve); the cluster kernel
     timed at each D beside the library.
   - The fused matcher bit for bit equal to the plain matcher
     (``match_descriptors_plain``) on planted cases (row and column ties,
     fully masked rows and columns, invalid keypoints and landmarks) and at
     the three matchers' shapes with random masks, ratio 0 and 0.8, mutual
     on and off; timed beside the distance-matrix kernel + ``match()``,
     with its device operations per call from a trace (one launch; the run
     fails at more, or when no trace reads them), its host µs per call and
     its bounds: its 1-bit tensor-core path at the int8 rate, and the
     pair-words as popcounts at ``__popc``'s rate. The planted cases include
     one of 1,100 rows, more than a cluster takes in one pass per CTA.
3. Slice: S=8 states, 512 landmark slots (256 live), 4096 observation
   slots, two 752x480 cameras, K=400 keypoints per camera, 10 LM
   iterations, float32, with depth factors on every state and sonar-range
   factors on three. The LM loop runs once under the sync debug mode that
   raises on a host synchronisation. Five frames (distinct seeds) through
   ``BackendStep``, with launch counts reset just before and read just
   after; per frame: B1 and the fused matcher launched (the distance
   matrix not), outputs finite, cost reduced with accepted steps,
   positions closer to the truth, most true associations matched and
   none wrongly, and the same step with the plain versions on the card
   agreeing (identical matches; cost within 1%, positions within 5 mm:
   f32 LM steps carry the solvers' rounding and the run-dependent order of
   CUDA index_add_ into mm-level differences, printed beside a rerun's).
   Median per-frame time with kernels and with plain versions. Then the
   engine's LM program as CUDA graphs (``programs.OptProgram`` with
   marginalization) over the five frames twice, at LM bounds that change
   between calls: eager, capture, then replays, each held to the eager
   program (``GRAPH_TOL``), B1 launched once per LM iteration, the replay
   counter rising on every call but the first; host ms a call, eager and
   replayed in turns.

4. Engine: the port's ``VioEngine.add_frame`` (the serial path) at the
   shipped underwater configuration (``configs/underwater_sonar_depth.yaml``:
   two 800x600 radial-tangential cameras, CLAHE, 3-level pyramid, 400
   keypoints per camera, S=8, 10 LM iterations, depth and sonar), float32,
   on the port's synthetic sequence: start-from-rest trajectory, 10 Hz for
   3 s (29 frames), depth and sonar events, rendered on the card before the
   run. First B2 on the first frames' own descriptors: the distance matrix
   and the fused matcher as the stereo matcher pairs them, and the fused
   matcher as the temporal matcher pairs the first two frames under its
   optical-flow mask; then the fused matcher against the plain one on every
   matcher call of the engine's first 8 frames, with the engine's real
   inputs (the map matcher's gating mask). Then at a fixed 10 LM
   iterations per frame (``time_limit`` 0; the config's 35 ms budget
   follows the wall clock) under deterministic CUDA algorithms: kernels,
   plain versions, kernels again. The rerun must repeat the kernel run
   exactly; the plain run must make the same decisions (keyframes, tracked
   keypoints) on at least SHARED_MIN_FRAMES leading frames, with positions
   within POS_TOL_MM of the kernel run's there (where the runs part is
   printed). Then at the config's budget: plain versions, then kernels (the
   main path: launch counts from 0 just before, read just after; the
   pipelined phase compares the serial engine's speed in turns). Checks,
   on every run: a
   result for every frame, median tracked keypoints >= 20, the window
   filled and marginalized, a keyframe export with the ABI keys, finite
   landmark covariances, B1 and the fused matcher launched and the
   distance matrix not (no kernel in the plain runs),
   and an SE(3)-aligned ATE within ATE_FACTOR x the JAX engine's own ATE on
   the same events at the fixed iteration count (CPU, float32;
   tools/engine_ate_reference.py): 1.5 x for the fixed-count runs, 2 x
   for the budget runs, whose iterations follow the wall clock. Prints per-frame ``add_frame`` median
   and p90 (host clock after a synchronize), the stage timers' medians,
   and launches per frame. Then a window of S = 22 states (19 keyframes +
   3 IMU frames: D = 330, B1's cluster kernel) over the first 8 frames at a
   fixed 10 LM iterations, kernels then plain versions: a finite result for
   every frame, the cluster kernel launched (counts from 0 just before,
   read just after) and neither the one-block kernel nor the library
   route, the same decisions on >= SHARED_MIN_FRAMES leading frames within
   POS_TOL_MM.

5. Pipelined engine: the same configuration, 29 frames and events through
   ``frontend_stage`` → ``backend_step`` (one solve in flight) and
   ``backend_flush``.
   - Split drive on one thread at a fixed 10 LM iterations under
     deterministic algorithms: kernels, plain versions, kernels. The rerun
     repeats the first kernel run exactly, the plain run makes the same
     decisions on at least SHARED_MIN_FRAMES leading frames within
     POS_TOL_MM, every frame has a result, B1 and the fused matcher are
     launched from ``backend_step`` (launches per frame printed), and the
     ATE is within 1.5 x the JAX engine's own split-drive ATE on the same
     events (JAX_SPLIT_ATE_M). One ``backend_step`` of the first run runs
     under ``torch.cuda.set_sync_debug_mode("warn")``: its host
     synchronisations by call site and op, at most SYNC_LIMIT (the fetch
     and the marginalization's three ``eigh``).
   - Checkpoint round trip on the card: save the flushed engine, load it
     into a fresh ``cuda`` engine, save again; every array equal.
   - ``AsyncVioEngine(blocking=True)`` (frontend, backend and publisher
     threads) at the config's budget, in turns with the serial engine:
     serial, pipelined (the pipelined main path: launch counts from 0 just
     before, read just after), pipelined, serial. Checks: no drop, a result
     for every frame after the first, increasing timestamps, ``finish()``
     raising nothing, B1 and the fused matcher launched and no kernel off
     the engine's path, ATE within 2 x
     JAX_SPLIT_ATE_M. Frames per second end to end (feed to ``finish()``)
     beside the serial engine's, and the device-busy share of the first 6
     frames of each from a ``torch.profiler`` trace.
   - One live-mode run (``blocking=False``) fed at the sequence's 10 Hz:
     processed and dropped frames add up to the frames fed.

6. Loop closure.
   - The kernels at the loop closer's shapes, each bit for bit against its
     plain version with planted ties and timed in turns: the distance
     matrix at the product vocabulary's word assignment, (2, 1012, 4) x
     (2, 256, 4) (a keyframe's 512 window + 500 fresh descriptors, both
     128-bit halves in one launch, a per-batch b), then argmin, beside one
     fp16 ``matmul`` of the unpacked ±1 bits; the nearest-codeword kernel
     (the word assignment's kernel) at that shape and at
     ``train_vocabulary``'s (32768, 8) x (1024, 8), beside the distance
     matrix + argmin and the fp16 ``matmul`` + argmax; the fused matcher
     at verification, (512, 8) x (500, 8), distance 80, mutual, no gate.
   - The revisit drive of the JAX tests at full width (``revisit_exports``:
     the config's 800x600 camera, 12 traverse keyframes and 3 revisits with
     accumulating drift, rendered on the card) through ``LoopCloser`` with
     ``RECENCY_EXCLUSION`` 5: with the kernels (the loop path's launch
     counts from 0 just before, read just after) and with the plain
     versions under deterministic algorithms: loops verified, the same
     loops and inlier counts, the optimized path's RMSE below 0.6 x the
     drifted one; the nearest codeword launched once per keyframe and the
     distance matrix never; ``add_keyframe`` ms per keyframe and its stages; then once
     in 6-DoF (the same loops), replayed by a float64 closer on the CPU on
     the card's descriptors and P3P draws: the same loops, and the card's
     optimized path within 3 mm of the reference's and within a tenth of how
     far the reference's solve moved it. A P3P RANSAC and a 4-DoF solve
     probed alone (host ms, traced device ms and operations).
   - The entry point: ``apps.run_synchronous.main`` at the underwater
     configuration on a short synthetic sequence with ``--save-checkpoint``,
     then a run that ``--resume``s it: a result for every frame, every
     output written and parsed, every healthy keyframe taken by the closer
     and through the nearest-codeword kernel once. The kernels' launches in
     the closer's ``add_keyframe`` are counted apart from the app's engine.
     Then the health gate: one run with the gauntlet rig
     (``tools/gauntlet_torch.py``'s stereo config) over 6 s with a
     featureless stretch at 2-4 s and primitive odometry: the switch to the
     primitive estimator inside the stretch and back after it,
     ``svin_robust.txt`` and ``switch_info.txt`` finite, the nearest
     codeword once per keyframe the closer takes.

7. The loop closer past 512 nodes.
   - Solves on in-place graphs (``closer_past_512``: a circle lapped twice
     with a VIO yaw random walk, loop edges back to the first lap) of 513
     and 1,024 keyframes, ``_optimize_and_update_drift`` in 4-DoF (the
     banded branch's system by ``optimize_4dof_pcg``, 30 GN x 96 CG) and
     6-DoF (PCG, 10 GN x 96 CG), float32: the scalable
     branch in ``pgo_log``, one solver run under the sync debug mode that
     raises on a host synchronisation, the loop residuals under 0.01 m
     (4-DoF; the 6-DoF loop edges, whitened by 20 before a Huber(0.1), only
     halve them, as the JAX closer's), and the same solve by the port in
     float64 on the CPU: its path within SCALABLE_PATH_TOL_M. ms per solve
     (median of 3) with the solver's traced device ms and operations; at
     1,024 nodes the dense ``optimize_4dof`` beside the scalable solve.
   - The in-situ drive of ``tests/test_loopcloser_scale.py:216``: 2,120
     image-free keyframes through ``add_keyframe`` (6 GN x 32 CG, 25
     correspondences, 64 P3P hypotheses), the loops at the end: the tables
     doubled past 2,048, a loop from the revisit, the database's device
     query and inverted file used, the corrected path better than the
     drifted one, the nearest codeword once per keyframe (counts from 0 just
     before the drive, read just after); ``add_keyframe`` ms (median, p90).

8. Global bundle adjustment: ``build_global_ba_problem`` at its defaults
   (K = 64, L = 4,096, O = 16,384), float32, poses perturbed by 5 cm,
   through ``ba_solve_local``, ``ba_solve_bucketed`` and ``ba_solve_pcg``:
   the cost falls, the poses within 1 cm of the truth, the dense routes
   launch the cluster kernel (D = 384) once per GN step (counts from 0 just
   before each route, read just after) and agree with themselves on the
   plain solve under deterministic algorithms; ms per GN step. Then
   ``ba_solve_local`` at K = 128 and 170 (D = 768, 1020): ms per GN step and
   the share of its solve, the cluster kernel timed beside the library
   Cholesky on the step's own system.

9. Global BA at the Cave shape: ``build_global_ba_tracks`` at 2,048
   keyframes and 65,536 landmarks (span 8, two cameras, 2% revisits),
   float32, free poses perturbed by 2 cm and landmarks by 5 cm, through
   ``ba_solve_tracks`` (64 blocks of 1,024 landmarks, 16 slots each) and
   ``ba_solve_pcg`` (``bucket_problem``'s default buckets, pose-major
   index), both at bench.py's 2 GN x 32 CG: the cost falls on both, one
   track solve without a host sync (sync debug mode "error"), the two
   within TRACKS_PCG_TOL_M, no kernel launched; ms per GN step (median of
   3, in turns), traced device ms and operations per GN step, device-busy
   share and peak memory per run. Then the card's float32 track solve at
   K = 256, L = 8,192 against the port's float64 one on the CPU. Then the
   flagship step (``svin_tpu_torch.entry``): a finite cost below the
   start's, median ms.

10. Multi-process: the sharded solvers on ``torch.distributed``, each rank
   a worker process of this script (``--mp-worker``), first one NCCL rank
   (NCCL refuses two ranks on one GPU), then two gloo ranks sharing the
   card (gloo reduces CUDA tensors through the host). Every rank, each
   drive with launch counts from 0 just before and read just after:
   ``make_sharded_ba`` and ``make_sharded_ba_bucketed`` at phase 8's K = 64
   problem (the cost falls, poses within BA_KERNEL_TOL_M of the local solve
   on the card and BA_POSE_TOL_M of the truth, the cluster kernel exactly
   once per GN step); ``make_sharded_ba_tracks`` and ``make_sharded_ba_pcg``
   (pose-major index) at phase 9's Cave shape (within TRACKS_PCG_TOL_M of
   the local solves, no kernel; with NCCL one tracks GN step under the sync
   debug mode that raises); ``make_sharded_posegraph`` and
   ``make_sharded_posegraph_pcg`` on the JAX tests' drifted graph (the far
   end within 0.15 m of the truth, within SCALABLE_PATH_TOL_M of the local
   solve); with two ranks the cooperative mapping of
   tests/test_runtime.py:203 (16 merged poses, >= 8 shared pairs, rank 1's
   drift below 0.3x the injected one, the fused matcher launched); and
   ``dryrun_multichip``. The all_reduce calls per drive are counted; one
   all_reduce of the tracks CG vector's (2048, 6) shape timed alone
   (``device_ms``); ms per GN step of the bucketed BA and the Cave-shape
   tracks, sharded and local in turns (MP_ROUNDS each). A worker that fails or outlives MP_TIMEOUT_S
   fails the run.
11. C4, the VIO's runaway at Cave length (a reference behaviour the port
   keeps), at its shortest showing on the card, in seconds: one 1/3 s frame
   interval of the revisiting sequence's IMU preintegrated on the card in
   float32 with absolute stamps at 0, 300 and 600 s, each held against the
   float64 CPU preintegral in units of the IMU factor's sigma (below
   C4_STAMP_SIGMA: the stamps are not the cause); then a window with depth
   factors whose poses and landmarks sit C4_LIFT_M above the depth,
   marginalized at its gauge slot on the card in float32 and on the CPU in
   float64: the new oldest pose's prior holds x, y, z and yaw at the lifted
   estimate with sqrt information 1e7 on both (the cause), and moving the
   window down onto its depth costs ~1e14 x C4_LIFT_M^2 / 2 more on the
   card.
12. C5, the float32 spread of the two packages at Cave length (float32
   chaos, no fault), at its one float32-only divergence, in seconds: the
   adjugate inverse of C5_BLOCKS rank-2 float32 landmark blocks (one
   observation's Hessian plus the optimizer's 1e-6 I) on the card bit for
   bit the CPU's, inf on the same blocks (the rows the refresh's
   finiteness check declines); then the port's float32 engine on the 1.3 s
   check sequence of ``tests/test_torch_cave_parity.py`` on the card and on
   the CPU, the same host-drawn RANSAC samples, 20 landmarks cut to one
   observation after frame 4: no non-finite gate row on either, the
   declined rows counted on each, positions within C5_POS_TOL_M.

The second-to-last line of standard output is the kernels' JSON record; the
last is ``{"ok": true, "device": {...}}``.
"""
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

from svin_tpu_torch import problems, sim
from svin_tpu_torch.convert import to_numpy_tree, tree_to
from svin_tpu_torch.estimator import WindowConfig, optimize, rig_params
from svin_tpu_torch.kinematics import Transformation
from svin_tpu_torch.evaluation import ate_rmse
from svin_tpu_torch.loopclosure.loop_closure import DESC_DIST_LOOP
from svin_tpu_torch.ops import cuda_lib, hamming, solve
from svin_tpu_torch.pipeline import (BackendStep, VioEngine, load_config, programs, run_events,
                                     synthetic_sequence)
from svin_tpu_torch.pipeline.async_vio import AsyncVioEngine
from svin_tpu_torch.pipeline.checkpoint import load_engine, save_engine
from svin_tpu_torch.utils import Timing, timing
from svin_tpu_torch.utils.timing import device_profile_summary

N_FRAMES = 5
K = 400
SOLVE_D = 120  # S·15 at the shipped window with fixed extrinsics
# the cluster kernel's sizes: an S=22 window (15·22), global BA's 6K at K =
# 64, 128 and 170 (384, 768, 1020: 1020 ends in a partial 32-wide panel),
# then up to the reference kernel's 1024
LARGE_DS = (330, 384, 512, 768, 1020, 1024)
LARGE_S_KEYFRAMES = 19  # + the config's 3 IMU frames: S = 22 states, D = 330
LARGE_S_FRAMES = 8
CFG = WindowConfig(num_states=8, num_landmarks=512, num_obs=4096, max_iterations=10)
ENGINE_CONFIG = "configs/underwater_sonar_depth.yaml"
# the JAX engine's SE(3)-aligned ATE on this sequence's events at a fixed 10
# LM iterations per frame, float32 on the CPU (tools/engine_ate_reference.py)
JAX_ATE_M = 0.009505
# the same through the JAX engine's pipelined split steps (frontend_stage,
# backend_step, backend_flush; one solve in flight), the pipelined bounds'
# base: python3 tools/engine_ate_reference.py write EVENTS.npz, then
# JAX_PLATFORMS=cpu python3 tools/engine_ate_reference.py jax-split EVENTS.npz
JAX_SPLIT_ATE_M = 0.012831
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


# the plain versions of the kernels, as an engine's or a backend step's options
PLAIN = dict(solve=solve.solve_spd_plain, matcher=hamming.match_descriptors_plain)
# every kernel wrapper's launch count. The engine's main path (S=8, D=120)
# runs B1's one-block kernel and the fused matcher; a window of S=22 states
# (D=330) and global BA (D=6K) run B1's cluster kernel; the loop closer runs
# the fused matcher and the nearest-codeword kernel. The distance matrix is on no path (held
# to its plain version and timed in the kernel phases). The solve's library
# route (float64, D > 1024) is counted beside the kernels.
KERNELS = {"spd_solve_chol": solve.spd_solve_chol, "spd_solve_cluster": solve.spd_solve_cluster,
           "hamming_match": hamming.match_descriptors_cuda,
           "hamming_matrix": hamming.hamming_matrix_cuda,
           "hamming_nearest": hamming.nearest_codeword_cuda}
COUNTERS = dict(KERNELS, solve_spd_library=solve.solve_spd_library)
ON_PATH = ("spd_solve_chol", "hamming_match")
# launches the engine's S=8 path must not make
OFF_ENGINE_PATH = ("spd_solve_cluster", "hamming_matrix", "hamming_nearest", "solve_spd_library")
# host synchronisations one backend_step may make: its fetch and the three
# eigh of the marginalization (torch.linalg.eigh checks its info on the host)
SYNC_LIMIT = 4


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in COUNTERS.items()}


def off_engine_path(launches: dict) -> dict:
    """The launches among ``launches`` that the engine's S=8 path must not
    make."""
    return {k: launches[k] for k in OFF_ENGINE_PATH if launches[k]}


def log(msg: str) -> None:
    print(msg, flush=True)


# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s, float32 outside the
# tensor cores 67 TFLOP/s; the bounds below use them
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# __popc issues at 16 per clock per SM on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput): 132 SMs at a 1.98 GHz boost clock
POPC_PER_S = 16 * 132 * 1.98e9
TIMED_LAUNCHES = 200


# dense int8 tensor-core rate (NVIDIA data sheet); the H100's 1-bit mma
# (AND + popcount) has no published rate, so the int8 rate stands in for it
INT8_TC_OPS_PER_S = 1979e12


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over their rate (float32 by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def matcher_bound(n_bytes: float, n_pairs: int, words: int) -> dict:
    """The fused matcher's bounds. ``bound_ms``: the path the kernel takes,
    its bytes against the 1-bit tensor-core product (a multiply-accumulate
    per bit of every pair, 2 operations, at the int8 rate).
    ``popc_bound_ms``: its bytes against its pair-words as popcounts at
    ``__popc``'s rate (the nearest codeword's count), a path it does not
    take."""
    bms, by = bound(n_bytes, 2 * n_pairs * words * 32, INT8_TC_OPS_PER_S)
    return dict(bound_ms=bms, bound_by=by,
                popc_bound_ms=bound(n_bytes, n_pairs * words, POPC_PER_S)[0])


def device_ms(fn, n: int = TIMED_LAUNCHES, warmup: int = 10) -> tuple:
    """(device ms per call, host µs per call) of ``fn``.

    Host: ``time.perf_counter`` over ``n`` calls, the synchronize after them
    not counted. Device: one event, ``n`` calls back to back on the stream,
    a second event, then synchronize and divide. A spin kernel
    (``torch.cuda._sleep``) ahead of the first event keeps the card busy
    while the host enqueues the calls, so the events time the card working
    through a full queue, not the host's dispatch; a function of many small
    launches can still fill the launch queue and read host-bound."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(4e9, 1.5 * host_s * 2.0e9 + 1e6)))  # cycles, ~2 GHz SM clock
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, 1e6 * host_s / n


def in_turns(fns: dict, rounds: int = 3, n: int = TIMED_LAUNCHES) -> dict:
    """``device_ms`` of every function (``n`` calls), in turns (the dict's
    order, repeated ``rounds`` times); the median per function of device ms
    and host µs."""
    got = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            got[k].append(device_ms(fn, n=n))
    return {k: (statistics.median(m for m, _ in v), statistics.median(h for _, h in v))
            for k, v in got.items()}


def traced_ms(fn, n: int = 50, tries: int = 4, agree: bool = True) -> tuple:
    """(device ms per call, device operations per call) of ``fn`` from a
    ``torch.profiler`` trace of ``n`` calls: the summed durations of the
    kernels, copies and fills the card ran for it, the gaps between them not
    counted. A check on ``device_ms`` for a function of several launches,
    whose event time reads the host's dispatch once the launch queue is
    full. A trace can miss device events, so traces are taken until two in
    a row hold the same number of them, a multiple of ``n`` (at most
    ``tries``); (None, 0) if none do. With ``agree`` False, the first
    trace's numbers (for a function whose operation count varies)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    last = None
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        count = len(on_card)
        if count and (not agree or (count % n == 0 and count == last)):
            return sum(e.time_range.elapsed_us() for e in on_card) / n / 1e3, count / n
        last = count
    return None, 0


def one_launch(fn, where: str) -> tuple:
    """``traced_ms`` of a fused-matcher call, which must be one device
    operation: fails at more, and when no two of ten traces agree."""
    ms, ops = traced_ms(fn, tries=10)
    if ms is None:
        raise AssertionError(f"fused matcher at {where}: device operations per call not measured "
                             f"(no two of ten traces agreed)")
    if ops != 1:
        raise AssertionError(f"fused matcher at {where}: {ops:g} device operations per call, not 1")
    return ms, ops


def traced_text(ms, ops) -> str:
    return "not measured (no two traces agreed)" if ms is None else (
        f"{ms:.5f} ms in {ops:g} device operations")


def equilibrated_spd(rng, D, dev):
    A = rng.standard_normal((D, D))
    H = A @ A.T + D * np.eye(D)
    s = 1.0 / np.sqrt(np.diag(H))
    b = rng.standard_normal(D) * s
    H = H * np.outer(s, s)
    return (torch.as_tensor(H, dtype=torch.float32, device=dev),
            torch.as_tensor(b, dtype=torch.float32, device=dev))


def cholesky_library(H, b):
    """One library call per factor and solve: ``cholesky_ex`` +
    ``cholesky_solve`` (cuSOLVER), the yardstick for B1."""
    L, _ = torch.linalg.cholesky_ex(H)
    return torch.cholesky_solve(b[..., None], L)


def pm1_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., N, W) int32 words -> (..., N, 32 W) float16 in {-1, +1}, bit k
    of word w at column 32 w + k (the JAX package's ``unpack_bits_pm1``)."""
    bits = (words[..., None] >> torch.arange(32, device=words.device, dtype=torch.int32)) & 1
    return (2 * bits - 1).to(torch.float16).flatten(-2)


def unfused_match(a, b, va, vb, mask, **kw):
    """The unfused matcher on the card: the B2 distance-matrix kernel, then
    the eager selection (``match``) on the matrix."""
    m = va[..., :, None] & vb[..., None, :]
    if mask is not None:
        m = m & mask
    return hamming.match(hamming.hamming_matrix_cuda(a, b), m, **kw)


def check_matcher(args, what: str, **kw) -> int:
    """The fused matcher bit for bit against the plain one on ``args``;
    returns the number of valid matches."""
    got = hamming.match_descriptors_cuda(*args, **kw)
    want = hamming.match_descriptors_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not (g.dtype == w.dtype and torch.equal(g, w)):
            raise AssertionError(f"fused matcher != plain: {what} {kw}")
    return int(want.valid.sum())


def check_solve(H, rhs, what: str, counter: str) -> None:
    """``solve_spd`` on one equilibrated system: relative residual <= 1e-4
    and relative distance to the plain solution <= 1e-3, through the route
    ``counter`` (one launch, no other route's)."""
    before = read_counts()
    x = solve.solve_spd(H, rhs)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
    ref = solve.solve_spd_plain(H, rhs)
    res = float(torch.linalg.norm(H @ x - rhs) / torch.linalg.norm(rhs))
    dist = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
    log(f"B1 solve_spd {what}: route {moved}, relative residual {res:.3e}, relative distance to "
        f"plain {dist:.3e}")
    if moved != {counter: 1}:
        raise AssertionError(f"solve_spd {what}: routed {moved}, expected {counter}")
    if not (res <= 1e-4 and dist <= 1e-3):
        raise AssertionError(f"solve_spd out of tolerance at {what}")


def large_solve_phase(rng, dev) -> dict:
    """B1 past one block's shared memory: the cluster kernel through
    ``solve_spd`` at D = 330 (the S=22 window), 384, 512, 768, 1020, 1024, a batch
    with a non-SPD system, the float64 and D > 1024 library route; timed at
    each D in turns with ``cholesky_ex`` + ``cholesky_solve``."""
    plans = {}
    for D in LARGE_DS:
        plan = solve.cluster_plan(D)
        plans[D] = dict(cluster=plan.cluster, max_active_clusters=solve.cluster_max_active(D, dev))
        log(f"B1 cluster plan D={D}: {plan.cluster} CTAs, {plan.ntiles} tiles and {plan.ring} ring "
            f"slots per CTA, {plan.smem_bytes} B of shared memory per CTA; "
            f"cudaOccupancyMaxActiveClusters {plans[D]['max_active_clusters']}")
        if plans[D]["max_active_clusters"] < 1:
            raise AssertionError(f"the card cannot schedule the cluster plan of D={D}")
    for D in LARGE_DS:
        check_solve(*equilibrated_spd(rng, D, dev), f"D={D}", "spd_solve_cluster")
    Hs, bs = zip(*(equilibrated_spd(rng, 384, dev) for _ in range(3)))
    Hb, bb = torch.stack(Hs), torch.stack(bs)
    Hb[1] = -Hb[1]  # not positive definite
    x, ref = solve.spd_solve_cluster(Hb, bb), solve.solve_spd_plain(Hb, bb)
    ok = [0, 2]
    if not (bool(torch.isnan(x[1]).all()) and bool(torch.isnan(ref[1]).all())
            and not bool(torch.isnan(x[ok]).any())
            and float(torch.linalg.norm(x[ok] - ref[ok]) / torch.linalg.norm(ref[ok])) <= 1e-3):
        raise AssertionError("spd_solve_cluster batched: a non-SPD system is not all NaN, or the "
                             "others are out of tolerance")
    log("B1 spd_solve_cluster batched (3, 384, 384): the non-SPD system all NaN (as plain), the "
        "other two within tolerance")
    H, rhs = equilibrated_spd(rng, 330, dev)
    before = solve.solve_spd_library.launches
    x64 = solve.solve_spd(H.double(), rhs.double())
    if not (solve.solve_spd_library.launches == before + 1
            and torch.equal(x64, solve.solve_spd_plain(H.double(), rhs.double()))):
        raise AssertionError("solve_spd float64: not the library route, or not the plain solution")
    log("B1 solve_spd float64 D=330: the library route (cholesky_ex + cholesky_solve), equal to "
        "solve_spd_plain")
    check_solve(*equilibrated_spd(rng, 1100, dev), "D=1100 (past the kernels)", "solve_spd_library")
    rows = {}
    for D in LARGE_DS:
        H, rhs = equilibrated_spd(rng, D, dev)
        err = float((solve.spd_solve_cluster(H, rhs) - solve.solve_spd_plain(H, rhs)).abs().max())
        n = TIMED_LAUNCHES if D <= 512 else 50
        t = in_turns({"kernel": lambda H=H, r=rhs: solve.spd_solve_cluster(H, r),
                      "library": lambda H=H, r=rhs: cholesky_library(H, r),
                      "plain": lambda H=H, r=rhs: solve.solve_spd_plain(H, r)}, n=n)
        bms, by = bound((D * (D + 1) // 2 + 2 * D) * 4, D**3 / 3 + 2 * D * D)
        tr_k = traced_ms(lambda H=H, r=rhs: solve.spd_solve_cluster(H, r), n=20)
        tr_l = traced_ms(lambda H=H, r=rhs: cholesky_library(H, r), n=20)
        rows[D] = dict(max_abs_err=err, ms=t["kernel"][0], host_us=t["kernel"][1],
                       plain_ms=t["plain"][0], library_ms=t["library"][0], bound_ms=bms,
                       bound_by=by, traced_ms=tr_k[0], library_traced_ms=tr_l[0],
                       library_ops_per_call=tr_l[1], **plans[D])
        log(f"B1 cluster solve D={D}: device ms per launch kernel {t['kernel'][0]:.5f}, library "
            f"(cholesky_ex + cholesky_solve) {t['library'][0]:.5f}, plain {t['plain'][0]:.5f}; "
            f"host us per call {t['kernel'][1]:.1f}, {t['library'][1]:.1f}, {t['plain'][1]:.1f}; "
            f"bound {bms * 1e3:.4f} us ({by}); max |x - plain| {err:.2e}; traced device time per "
            f"call: kernel {traced_text(*tr_k)}, library {traced_text(*tr_l)}")
    main = LARGE_DS[0]
    return dict(rows[main], **{f"{k}_d{D}": rows[D][k] for D in LARGE_DS[1:]
                               for k in ("ms", "library_ms", "plain_ms", "bound_ms", "traced_ms",
                                         "library_traced_ms", "cluster", "max_active_clusters")})


def kernel_phase(dev) -> dict:
    rng = np.random.default_rng(0)
    words = lambda shape: torch.as_tensor(  # noqa: E731
        rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32),
        device=dev)
    out = {}

    # ---- B2, the distance matrix: exact at the three matchers' shapes (map:
    # both cameras' keypoints against the landmark table; stereo and
    # temporal: one camera's keypoints against another's, 2-D) and ragged ones
    for a_shape, b_shape in (((2, K, 8), (512, 8)), ((K, 8), (K, 8)), ((1, 1, 8), (1, 8)),
                             ((1, 129, 8), (257, 8)), ((1, K, 8), (1, 8)), ((129, 8), (257, 8))):
        a, b = words(a_shape), words(b_shape)
        got = hamming.hamming_matrix(a, b)
        want = hamming.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hamming kernel != plain at {a_shape}x{b_shape}")
    ham = {}
    for name, a_shape, b_shape in (("map", (2, K, 8), (512, 8)), ("400x400", (K, 8), (K, 8))):
        a, b = words(a_shape), words(b_shape)
        pa, pbt = pm1_bits(a).reshape(-1, 256), pm1_bits(b).T.contiguous()
        lib = lambda pa=pa, pbt=pbt: torch.matmul(pa, pbt)  # noqa: E731
        d = hamming.hamming_matrix(a, b)
        err = int((d - hamming.hamming_matrix_plain(a, b)).abs().max())
        lib_d = ((256 - lib().float()) / 2).to(torch.int32).reshape(d.shape)
        if not torch.equal(lib_d, d):
            raise AssertionError(f"fp16 +-1 matmul != Hamming distances at {name}")
        t = in_turns({"kernel": lambda a=a, b=b: hamming.hamming_matrix(a, b), "library": lib,
                      "plain": lambda a=a, b=b: hamming.hamming_matrix_plain(a, b)})
        n_pairs = d.numel()
        bms, by = bound((a.numel() + b.numel() + n_pairs) * 4, n_pairs * 8)
        ham[name] = dict(max_abs_err=err, ms=t["kernel"][0], host_us=t["kernel"][1],
                         plain_ms=t["plain"][0], library_ms=t["library"][0], bound_ms=bms,
                         bound_by=by)
        log(f"B2 hamming_matrix {a_shape}x{b_shape} ({name}): exact; device ms per launch kernel "
            f"{t['kernel'][0]:.5f}, library (fp16 matmul of unpacked +-1 bits, unpacking "
            f"excluded) {t['library'][0]:.5f}, plain {t['plain'][0]:.5f}; host us per call "
            f"kernel {t['kernel'][1]:.1f}, library {t['library'][1]:.1f}, plain "
            f"{t['plain'][1]:.1f}; bound {bms * 1e3:.4f} us ({by})")
    out["hamming_matrix"] = ham["map"]

    # ---- B1: the blocked-Cholesky kernel on equilibrated SPD systems
    for D in (7, SOLVE_D, 132):
        H, rhs = equilibrated_spd(rng, D, dev)
        x = solve.solve_spd(H, rhs)
        ref = solve.solve_spd_plain(H, rhs)
        res = float(torch.linalg.norm(H @ x - rhs) / torch.linalg.norm(rhs))
        dist = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
        log(f"B1 spd_solve_chol D={D}: relative residual {res:.3e}, relative distance to plain "
            f"{dist:.3e}")
        if not (res <= 1e-4 and dist <= 1e-3):
            raise AssertionError(f"spd_solve_chol out of tolerance at D={D}")
    Hs, bs = zip(*(equilibrated_spd(rng, SOLVE_D, dev) for _ in range(4)))
    Hb, bb = torch.stack(Hs), torch.stack(bs)
    Hb[2] = -Hb[2]  # not positive definite
    x, ref = solve.spd_solve_chol(Hb, bb), solve.solve_spd_plain(Hb, bb)
    ok = [0, 1, 3]
    if not (bool(torch.isnan(x[2]).all()) and bool(torch.isnan(ref[2]).all())
            and not bool(torch.isnan(x[ok]).any())
            and float(torch.linalg.norm(x[ok] - ref[ok]) / torch.linalg.norm(ref[ok])) <= 1e-3):
        raise AssertionError("spd_solve_chol batched: a non-SPD system is not all NaN, or the "
                             "others are out of tolerance")
    log(f"B1 spd_solve_chol batched (4, {SOLVE_D}, {SOLVE_D}): the non-SPD system all NaN (as "
        f"plain), the other three within tolerance")
    chol = {}
    for D in (SOLVE_D, 132):
        H, rhs = equilibrated_spd(rng, D, dev)
        err = float((solve.solve_spd(H, rhs) - solve.solve_spd_plain(H, rhs)).abs().max())
        t = in_turns({"kernel": lambda H=H, r=rhs: solve.solve_spd(H, r),
                      "library": lambda H=H, r=rhs: cholesky_library(H, r),
                      "plain": lambda H=H, r=rhs: solve.solve_spd_plain(H, r)})
        # bytes: the lower triangle of H (all an SPD solve needs, and all the
        # kernel reads), b and x
        bms, by = bound((D * (D + 1) // 2 + 2 * D) * 4, D**3 / 3 + 2 * D * D)
        tr_k = traced_ms(lambda H=H, r=rhs: solve.solve_spd(H, r))
        tr_l = traced_ms(lambda H=H, r=rhs: cholesky_library(H, r))
        chol[D] = dict(max_abs_err=err, ms=t["kernel"][0], host_us=t["kernel"][1],
                       plain_ms=t["plain"][0], library_ms=t["library"][0], bound_ms=bms,
                       bound_by=by, traced_ms=tr_k[0], library_traced_ms=tr_l[0],
                       library_ops_per_call=tr_l[1])
        log(f"B1 solve D={D}: device ms per launch Cholesky kernel {t['kernel'][0]:.5f}, library "
            f"(cholesky_ex + cholesky_solve) {t['library'][0]:.5f}, plain {t['plain'][0]:.5f}; "
            f"host us per call {t['kernel'][1]:.1f}, {t['library'][1]:.1f}, {t['plain'][1]:.1f}; "
            f"bound {bms * 1e3:.5f} us ({by}); max |x - plain| {err:.2e}; traced device time "
            f"per call: kernel {traced_text(*tr_k)}, library {traced_text(*tr_l)}")
    out["spd_solve_cluster"] = large_solve_phase(rng, dev)
    out["spd_solve_chol"] = dict(chol[SOLVE_D], ms_d132=chol[132]["ms"],
                                 library_ms_d132=chol[132]["library_ms"],
                                 bound_ms_d132=chol[132]["bound_ms"],
                                 traced_ms_d132=chol[132]["traced_ms"],
                                 library_traced_ms_d132=chol[132]["library_traced_ms"])

    # ---- the fused matcher: bit for bit against the plain matcher with
    # every rule planted (problems.matcher_case: ties, fully masked rows and
    # columns, invalid keypoints and landmarks), then at the three matchers'
    # shapes with random masks, ratio 0 and 0.8, mutual on and off
    for cams, na, nb in ((2, 40, 50), (2, 37, 700), (1, 9, 12), (2, 1100, 300)):
        args = tuple(torch.as_tensor(x, device=dev)
                     for x in problems.matcher_case(rng, cams=cams, na=na, nb=nb))
        for ratio in (0.0, 0.8):
            for mutual in (True, False):
                check_matcher(args, f"planted ({cams},{na})x({nb})", ratio=ratio, mutual=mutual)
    fused = {}
    for kind in problems.MATCHER_SHAPES:
        args = problems.matcher_inputs(kind, rng, dev)
        n_valid = [check_matcher(args, kind, ratio=r, mutual=m)
                   for r in (0.0, 0.8) for m in (True, False)]
        got = hamming.match_descriptors_cuda(*args)
        want = unfused_match(*args)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"fused matcher != distance-matrix kernel + match at {kind}")
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, hamming.match_descriptors_plain(*args)))
        t = in_turns({"kernel": lambda args=args: hamming.match_descriptors_cuda(*args),
                      "unfused": lambda args=args: unfused_match(*args),
                      "plain": lambda args=args: hamming.match_descriptors_plain(*args)})
        tr_k = one_launch(lambda args=args: hamming.match_descriptors_cuda(*args), kind)
        tr_u = traced_ms(lambda args=args: unfused_match(*args))
        a, b, va, vb, mask = args
        n_rows = va.numel()
        n_bytes = (a.numel() + b.numel()) * 4 + va.numel() + vb.numel() + n_rows * 9 + (
            0 if mask is None else mask.numel())
        bnd = matcher_bound(n_bytes, n_rows * b.shape[-2], 8)
        fused[kind] = dict(max_abs_err=err, ms=t["kernel"][0], host_us=t["kernel"][1],
                           plain_ms=t["plain"][0], library_ms=None, **bnd,
                           unfused_ms=t["unfused"][0], unfused_host_us=t["unfused"][1],
                           traced_ms=tr_k[0], launches_per_call=tr_k[1],
                           unfused_traced_ms=tr_u[0], unfused_ops_per_call=tr_u[1])
        log(f"fused matcher {kind} {tuple(a.shape)}x{tuple(b.shape)} mask "
            f"{None if mask is None else tuple(mask.shape)}: bit-exact vs plain (ratio 0/0.8 x "
            f"mutual on/off; valid matches {n_valid}); device ms per call fused "
            f"{t['kernel'][0]:.5f} ({tr_k[1]:g} launch per call), distance-matrix kernel + "
            f"match() {t['unfused'][0]:.5f}, plain {t['plain'][0]:.5f}; host us per call "
            f"{t['kernel'][1]:.1f}, {t['unfused'][1]:.1f}, {t['plain'][1]:.1f}; bound "
            f"{bnd['bound_ms'] * 1e3:.4f} us ({bnd['bound_by']}, 1-bit tensor cores), popcounts "
            f"at __popc's rate {bnd['popc_bound_ms'] * 1e3:.4f} us; traced device time per "
            f"call: fused {traced_text(*tr_k)}, unfused {traced_text(*tr_u)}")
    out["hamming_match"] = dict(fused["map"], **{f"{k}_{f}": fused[k][f] for k in ("stereo", "temporal")
                                                 for f in ("ms", "host_us", "unfused_ms", "bound_ms",
                                                           "traced_ms", "unfused_traced_ms")})
    return out


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
    plain = BackendStep(rig, problems.IMU_PARAMS, CFG, **PLAIN).to(dev)
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
    reset_counts()
    outs = []
    for i, c in enumerate(cases):
        before = read_counts()
        outs.append(step(c["w"], c["f"], c["frame"], CFG.max_iterations, c["victim"]))
        torch.cuda.synchronize()
        after = read_counts()
        if not all(after[k] > before[k] for k in ON_PATH):
            raise AssertionError(f"frame {i}: a kernel was not launched: {before} -> {after}")
    launches = read_counts()
    if off_engine_path(launches):
        raise AssertionError(f"a kernel off the backend step's path ran: {launches}")
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
    graph_launches = opt_graph_check(cases, rig, step.imu_p)
    return {k: launches[k] + graph_launches[k] for k in launches}


# the LM program replayed against eager (positions and landmarks in m, cost
# relative): each run sums CUDA index_add_ in its own order, and ten f32 LM
# steps carry that into mm-level differences along weakly observed
# directions (a kernel rerun above moves positions by up to 1.5e-3 m), so
# the slice's bounds for the plain solver, landmarks at ten times positions
GRAPH_TOL = {"r": 5e-3, "hp_W": 5e-2, "cost": 1e-2}
GRAPH_ITERS = (10, 10, 6, 10, 3)  # n_it per call: the bound changes between replays


def opt_graph_check(cases, rig, imu_p) -> dict:
    """The slice's frames through the engine's LM program as CUDA graphs
    (``programs.OptProgram`` with marginalization), twice over: the first
    call eager, the second captures, every later one replays. Each call is
    held to the eager ``programs.opt_program`` on the same frame (within
    GRAPH_TOL, the same valid slots), launches B1 once per LM iteration,
    and the replay counter rises on every call but the first; then host ms
    a call, eager and replayed in turns, the device synchronized after
    each. Returns the graphed program's launches (the eager reference's
    are not counted)."""
    prog = programs.OptProgram(rig, imu_p, CFG, True)
    ref = programs.opt_program(rig, imu_p, CFG, True)
    before = timing.counters()
    launches = dict.fromkeys(COUNTERS, 0)  # the graphed program's alone
    worst = dict.fromkeys(GRAPH_TOL, 0.0)
    calls = list(zip(cases + cases, GRAPH_ITERS + GRAPH_ITERS))
    for i, (c, n_it) in enumerate(calls):
        args = (c["w"], c["f"], n_it, c["victim"])
        k0 = read_counts()
        got = to_numpy_tree(prog(*args))
        k1 = read_counts()
        if k1["spd_solve_chol"] - k0["spd_solve_chol"] != CFG.max_iterations:
            raise AssertionError(f"graph call {i}: B1 launched "
                                 f"{k1['spd_solve_chol'] - k0['spd_solve_chol']} times")
        launches = {k: launches[k] + k1[k] - k0[k] for k in launches}
        want = to_numpy_tree(ref(*args))
        lv = want[0].lm_valid
        d = {"r": float(np.abs(got[0].r - want[0].r).max()),
             "hp_W": float(np.abs(got[0].hp_W[lv] - want[0].hp_W[lv]).max(initial=0.0)),
             "cost": float(abs(got[2] - want[2]) / abs(want[2]))}
        if not (all(d[k] <= GRAPH_TOL[k] for k in d) and np.array_equal(lv, got[0].lm_valid)):
            raise AssertionError(f"graph call {i} (n_it {n_it}) vs eager: {d}")
        worst = {k: max(worst[k], d[k]) for k in d}
    after = timing.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in ("opt.graph_capture", "opt.graph_replay")}
    if delta != {"opt.graph_capture": 1, "opt.graph_replay": len(calls) - 1}:
        raise AssertionError(f"graph counters: {delta}")
    e_ms, g_ms = [], []
    for c in cases:  # eager, replay, replay, eager
        args = (c["w"], c["f"], CFG.max_iterations, c["victim"])
        for ms, fn in ((e_ms, ref), (g_ms, prog), (g_ms, prog), (e_ms, ref)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    log(f"LM program as CUDA graphs: {len(calls)} calls (1 eager, 1 capture, {delta['opt.graph_replay']} "
        f"replays) within {GRAPH_TOL} of eager, worst {worst}; host ms a call, synchronized: "
        f"eager median {statistics.median(e_ms):.2f}, replayed median {statistics.median(g_ms):.2f} "
        f"({len(e_ms)} each)")
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
    reset_counts()
    t0 = time.perf_counter()
    results = run_events(engine, events)
    torch.cuda.synchronize()
    fps = len(results) / (time.perf_counter() - t0)
    launches = read_counts()
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
            f"{statistics.median(ms):.2f} ms, p90 {float(np.percentile(ms, 90)):.2f} ms, "
            f"{fps:.3f} frames/s end to end")
        return dict(launches=launches, ate=ate, frame_ms=ms, results=results, fps=fps)
    log(f"engine [{name}]: {len(results)} frames, {len(kfs)} keyframes, median tracked "
        f"{np.median(tracked[1:]):.0f}, n_states {eng.n_states}/{S}, ATE (SE(3)) {ate:.6f} m "
        f"(bound {factor * JAX_ATE_M:.6f} m = {factor} x the JAX engine's {JAX_ATE_M:.6f} m), "
        f"Sim(3) scale {al.scale:.4f}")
    log(f"  tracked per frame {tracked}")
    log(f"  LM iterations per frame {[r.lm_iterations for r in results]}")
    log(f"  add_frame per frame (frames 2-{len(results)}): median {statistics.median(ms):.2f} ms, "
        f"p90 {float(np.percentile(ms, 90)):.2f} ms, max {max(ms):.2f} ms; {fps:.3f} frames/s "
        f"end to end")
    stages = {k: statistics.median(list(Timing.get(k).window)) * 1e3
              for k in STAGES if Timing.get(k) is not None}
    log("  stage medians (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    log(f"  launches {launches}, per frame "
        f"{ {k: round(v / len(results), 2) for k, v in launches.items()} }")
    return dict(launches=launches, ate=ate, frame_ms=ms, results=results, fps=fps)


def frame_descriptor_check(cfg, frames, dev) -> None:
    """B2 and the fused matcher on rendered frames' own descriptors,
    computed by the engine's frontend: the first frame's camera 0 against
    its camera 1 as the stereo matcher pairs them (the distance matrix
    exactly equal to its plain version, the fused matcher bit for bit equal
    to the plain matcher), and camera 0 of the first frame against camera 0
    of the second under the temporal matcher's optical-flow mask."""
    eng = VioEngine(cfg, device=dev)
    level = Transformation(r=np.zeros(3), q=np.array([0.0, 0.0, 0.0, 1.0]))
    uv0, desc0, val0, *_ = eng._detect_describe(frames[0].images, level)
    uv1, desc1, val1, *_ = eng._detect_describe(frames[1].images, level)
    on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    a, b = on(desc0[0]), on(desc0[1])
    got = hamming.hamming_matrix(a, b)
    want = hamming.hamming_matrix_plain(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"hamming kernel != plain on frame descriptors {tuple(a.shape)}x{tuple(b.shape)}")
    stereo = check_matcher((a, b, on(val0[0]), on(val0[1]), None), "stereo, frame 0", mutual=True)
    mask = programs.flow_mask(on(uv0[0]), on(uv1[0]), eng._diag[0])
    temporal = check_matcher((a, on(desc1[0]), on(val0[0]), on(val1[0]), mask),
                             "temporal, frames 0-1", mutual=True)
    log(f"B2 on the first frame's descriptors {tuple(a.shape)}x{tuple(b.shape)} "
        f"({int(val0[0].sum())} and {int(val0[1].sum())} valid keypoints): distance matrix "
        f"exact; fused matcher bit-exact as the stereo matcher ({stereo} matches) and as the "
        f"temporal matcher against the second frame under the flow mask ({int(mask.sum())} of "
        f"{mask.numel()} pairs kept; {temporal} matches)")


class CheckedMatcher:
    """An engine ``matcher`` that runs the fused kernel and the plain
    matcher on every call with the engine's real inputs (the map matcher's
    gating mask from ``gate_match_all``, the stereo and temporal pairs),
    requires them bit for bit equal, and returns the kernel's result."""

    def __init__(self):
        self.calls = {"map": 0, "stereo": 0, "temporal": 0}
        self.masks_kept = []

    def __call__(self, a, b, va, vb, mask=None, **kw):
        kind = "map" if a.dim() == 3 else "stereo" if mask is None else "temporal"
        self.calls[kind] += 1
        if mask is not None:
            self.masks_kept.append(float(mask.float().mean()))
        check_matcher((a, b, va, vb, mask), f"engine {kind} call {self.calls[kind]}", **kw)
        return hamming.match_descriptors_cuda(a, b, va, vb, mask, **kw)


def real_mask_check(cfg, events, dev, n_frames: int = 8) -> None:
    """The fused matcher against the plain one on every matcher call of the
    engine's first ``n_frames`` frames (fixed LM iteration count)."""
    first = []
    for ev in events:
        if ev.kind == "frame" and sum(e.kind == "frame" for e in first) == n_frames:
            break
        first.append(ev)
    checked = CheckedMatcher()
    run_events(VioEngine(dataclasses.replace(cfg, time_limit=0.0), device=dev, matcher=checked),
               first)
    torch.cuda.synchronize()
    if not (checked.calls["map"] >= 1 and checked.calls["stereo"] >= 1):
        raise AssertionError(f"engine matcher calls {checked.calls}")
    log(f"fused matcher bit-exact vs plain on every matcher call of the engine's first {n_frames} "
        f"frames: {checked.calls} calls, masks keeping "
        f"{min(checked.masks_kept):.4f}-{max(checked.masks_kept):.4f} of their pairs")


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
    frame_descriptor_check(cfg, frames, dev)
    real_mask_check(cfg, events, dev)

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
                             **PLAIN)
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

    # at the config's budget: plain, then kernels (the main path: its launch
    # counts are the ones reported); the pipelined phase compares the
    # serial engine's speed in turns
    plain = drive_engine("plain", cfg, events, gt, dev, **PLAIN)
    out = drive_engine("kernels", cfg, events, gt, dev)
    for r in (out, k_fix, k_fix2):
        if not all(r["launches"][k] > 0 for k in ON_PATH) or off_engine_path(r["launches"]):
            raise AssertionError(f"engine: a kernel of the path was not launched, or one off it "
                                 f"was: {r['launches']}")
    if any(v for r in (plain, p_fix) for v in r["launches"].values()):
        raise AssertionError("engine [plain]: a kernel was launched")
    k_ms, p_ms = out["frame_ms"], plain["frame_ms"]
    log(f"engine add_frame at the budget (plain, then kernels): kernels median "
        f"{statistics.median(k_ms):.2f} ms, p90 {float(np.percentile(k_ms, 90)):.2f} ms; plain "
        f"median {statistics.median(p_ms):.2f} ms, p90 {float(np.percentile(p_ms, 90)):.2f} ms")
    log(f"engine ATE: 10 LM iterations: kernels {k_fix['ate']:.6f} m and {k_fix2['ate']:.6f} m, "
        f"plain {p_fix['ate']:.6f} m, JAX engine (CPU, float32) {JAX_ATE_M:.6f} m; at the "
        f"config's budget: kernels {out['ate']:.6f} m, plain {plain['ate']:.6f} m")
    return out["launches"], (cfg, events, gt)


def large_window_phase(dev, cfg, events) -> dict:
    """The serial engine with a window of S = 22 states (the config's 3 IMU
    frames + 19 keyframes: D = 15 S = 330, past one block's shared memory)
    over the first LARGE_S_FRAMES frames, at a fixed 10 LM iterations under
    deterministic algorithms: with the kernels (B1's cluster kernel; counts
    from 0 just before, read just after), then with the plain versions. A
    finite result for every frame; the cluster kernel launched, B1's
    one-block kernel and the library route not; the plain run making the
    same decisions on at least SHARED_MIN_FRAMES leading frames within
    POS_TOL_MM."""
    big = dataclasses.replace(cfg, num_keyframes=LARGE_S_KEYFRAMES, time_limit=0.0)
    first, n = [], 0
    for ev in events:
        n += ev.kind == "frame"
        if n > LARGE_S_FRAMES:
            break
        first.append(ev)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, kernels in (("kernels", {}), ("plain", PLAIN)):
            eng = VioEngine(big, device=dev, **kernels)
            reset_counts()
            t0 = time.perf_counter()
            results = run_events(eng, first)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            if not (len(results) == LARGE_S_FRAMES and eng.wcfg.num_states == 22
                    and all(np.isfinite(r.T_WS.r).all() for r in results)):
                raise AssertionError(f"S=22 engine [{name}]: {len(results)} results for "
                                     f"{LARGE_S_FRAMES} frames, S={eng.wcfg.num_states}, or a "
                                     f"non-finite pose")
            runs[name] = dict(results=results, launches=launches)
            log(f"engine S=22 (D=330) [{name}, 10 LM iterations]: {len(results)} results for "
                f"{LARGE_S_FRAMES} frames, n_states {eng.n_states}, {wall:.2f} s; launches "
                f"{launches}")
    finally:
        torch.use_deterministic_algorithms(False)
    k = runs["kernels"]["launches"]
    if not (k["spd_solve_cluster"] > 0 and k["hamming_match"] > 0 and k["spd_solve_chol"] == 0
            and k["solve_spd_library"] == 0):
        raise AssertionError(f"S=22 engine: the cluster kernel not launched, or the one-block "
                             f"kernel or the library route was: {k}")
    if any(runs["plain"]["launches"].values()):
        raise AssertionError(f"S=22 engine [plain]: a kernel was launched: {runs['plain']['launches']}")
    c = compare_runs(runs["kernels"], runs["plain"])
    m = c["shared"]
    log(f"engine S=22, kernels vs plain: same decisions on the first {m} frames (|dr| there max "
        f"{max(c['pos_mm'][:m]):.3f} mm); |dr| per frame (mm) {[round(x, 2) for x in c['pos_mm']]}; "
        f"cluster-kernel launches per frame {k['spd_solve_cluster'] / LARGE_S_FRAMES:.2f}")
    if not (m >= SHARED_MIN_FRAMES and max(c["pos_mm"][:m]) <= POS_TOL_MM):
        raise AssertionError("engine S=22: kernels vs plain out of tolerance")
    return k


# ---------------------------------------------------------------- pipelined
def _port_frames(stack) -> list:
    return [f for f in stack if os.sep + "svin_tpu_torch" + os.sep in f.filename]


def sync_probe(engine, t, images, fd):
    """One ``backend_step`` under ``set_sync_debug_mode("warn")``: (its
    result, Counter of host synchronisations by (innermost port call site,
    its source line, the backend_step line it came from))."""
    torch.cuda.synchronize()
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = _port_frames(stack) or stack[-1:]
        inner = port[-1]
        step = next((f for f in reversed(port) if f.name == "backend_step"), inner)
        rel = os.path.relpath(inner.filename, os.path.dirname(os.path.abspath(__file__)))
        sites[(f"{rel}:{inner.lineno} {inner.name}", (inner.line or "").strip(),
               step.lineno)] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = engine.backend_step(t, images, fd)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sites


def split_drive(engine, events, probe_frame=None):
    """The events through the engine's split steps on one thread: the frame
    that initializes through ``add_frame``, every later one through
    ``frontend_stage`` → ``backend_step``, then ``backend_flush``. Returns
    (results, the kernels' launches inside backend_step and the flush,
    the sync probe's sites or None)."""
    results, inside, sites = [], dict.fromkeys(COUNTERS, 0), None
    n_frame = 0

    def step(fn, *args):
        before = read_counts()
        out = fn(*args)
        for k, v in read_counts().items():
            inside[k] += v - before[k]
        return out

    for ev in events:
        if ev.kind == "imu":
            engine.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "depth":
            engine.add_depth_measurement(ev.t, ev.depth)
        elif ev.kind == "sonar":
            engine.add_sonar_measurement(ev.t, *ev.sonar)
        else:
            if engine.n_states == 0:
                r = engine.add_frame(ev.t, ev.images)
            else:
                t_s, fd = engine.frontend_stage(ev.t, ev.images)
                if n_frame == probe_frame:
                    r, sites = step(sync_probe, engine, t_s, ev.images, fd)
                else:
                    r = step(engine.backend_step, t_s, ev.images, fd)
            if r is not None:
                results.append(r)
            n_frame += 1
    r = step(engine.backend_flush)
    if r is not None:
        results.append(r)
    torch.cuda.synchronize()
    return results, inside, sites


def check_pipelined(name, results, n_frames, gt, factor, eng) -> float:
    """A result for every frame after the first, in order; tracking; the
    window filled and marginalized; the ATE within ``factor`` x the JAX
    engine's split-drive ATE. Returns the ATE."""
    if len(results) < n_frames - 1:
        raise AssertionError(f"{name}: {len(results)} results for {n_frames} frames")
    ts = [r.timestamp for r in results]
    if not all(b > a for a, b in zip(ts, ts[1:])):
        raise AssertionError(f"{name}: timestamps not increasing")
    if not np.median([r.num_tracked for r in results[1:]]) >= 20:
        raise AssertionError(f"{name}: median tracked below 20")
    if eng.n_states != eng.wcfg.num_states - 1:
        raise AssertionError(f"{name}: window not filled and marginalized (n_states {eng.n_states})")
    est = np.stack([r.T_WS.r for r in results])
    ate, _ = ate_rmse(est, gt[len(gt) - len(results):], with_scale=False)
    if not ate <= factor * JAX_SPLIT_ATE_M:
        raise AssertionError(f"{name}: ATE {ate:.6f} m over the bound {factor * JAX_SPLIT_ATE_M:.6f} m")
    return ate


def async_drive(engine, events, blocking=True, pace=None) -> dict:
    """The events through an ``AsyncVioEngine`` over ``engine`` (camera by
    camera, through the synchronizer; with ``pace``, at that many times the
    sequence's rate). Returns the results, frames fed and dropped, and
    frames per second end to end (first feed to ``finish()`` returning)."""
    results = []
    t0 = time.perf_counter()
    ae = AsyncVioEngine(engine, blocking=blocking)
    ae.state_callback = results.append
    n_fed, t_seq0 = 0, None
    for ev in events:
        if pace is not None:
            t_seq0 = ev.t if t_seq0 is None else t_seq0
            lag = (ev.t - t_seq0) / pace - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
        if ev.kind == "imu":
            ae.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "depth":
            ae.add_depth_measurement(ev.t, ev.depth)
        elif ev.kind == "sonar":
            ae.add_sonar_measurement(ev.t, *ev.sonar)
        else:
            for ci, img in enumerate(ev.images):
                ae.add_image(ev.t, ci, img)
            n_fed += 1
    ae.finish()  # raises if a stage died
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(results=results, fed=n_fed, dropped=ae.dropped_frames, fps=len(results) / wall,
                wall=wall, engine=engine)


def device_profile(fn, top: int = 0) -> dict:
    """One ``fn()`` under ``torch.profiler``: ``device_profile_summary`` of
    the window (busy share, wall s, device ms and operations, the ``top``
    operations by device ms)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_profile_summary(prof, wall, top)


def npz_arrays(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def pipelined_phase(dev, cfg, events, gt) -> dict:
    frames = [ev for ev in events if ev.kind == "frame"]
    n = len(frames)
    fixed = dataclasses.replace(cfg, time_limit=0.0)

    # ---- split drive on one thread, fixed 10 LM iterations, deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = {}
    try:
        for name, kernels, probe in (("kernels", {}, 12), ("plain", PLAIN, None),
                                     ("kernels again", {}, None)):
            eng = VioEngine(fixed, device=dev, **kernels)
            reset_counts()
            t0 = time.perf_counter()
            results, inside, sites = split_drive(eng, events, probe_frame=probe)
            wall = time.perf_counter() - t0
            launches = read_counts()
            ate = check_pipelined(f"split [{name}]", results, n, gt, ATE_FACTOR["fixed"], eng)
            if len(results) != n:
                raise AssertionError(f"split [{name}]: {len(results)} results for {n} frames")
            if kernels:
                if launches != dict.fromkeys(COUNTERS, 0):
                    raise AssertionError(f"split [{name}]: a kernel was launched: {launches}")
            elif not all(inside[k] > 0 for k in ON_PATH) or off_engine_path(launches):
                raise AssertionError(f"split [{name}]: B1 and the fused matcher not both launched "
                                     f"from backend_step, or a kernel off the path was: {launches}")
            runs[name] = dict(results=results, ate=ate, launches=launches, inside=inside,
                              engine=eng, sites=sites)
            log(f"pipelined split drive [{name}, 10 LM iterations]: {len(results)} results for {n} "
                f"frames, ATE {ate:.6f} m (bound {ATE_FACTOR['fixed'] * JAX_SPLIT_ATE_M:.6f} m = "
                f"{ATE_FACTOR['fixed']} x the JAX engine's split drive {JAX_SPLIT_ATE_M:.6f} m), "
                f"{n / wall:.3f} frames/s; launches {launches}, from backend_step per pipelined "
                f"frame { {k: round(v / (n - 1), 2) for k, v in inside.items()} }")
    finally:
        torch.use_deterministic_algorithms(False)
    k1, p1, k2 = ({"results": runs[k]["results"]} for k in ("kernels", "plain", "kernels again"))
    vs_plain, vs_rerun = compare_runs(k1, p1), compare_runs(k1, k2)
    for what, c in (("kernels vs plain", vs_plain), ("kernels vs kernels rerun", vs_rerun)):
        m = c["shared"]
        log(f"pipelined, 10 LM iterations, {what}: same keyframe decisions and tracked counts on "
            f"the first {m} frames (|dr| there max {max(c['pos_mm'][:m]):.3f} mm); |dr| per frame "
            f"(mm) {[round(x, 2) for x in c['pos_mm']]}")
    if not (vs_rerun["shared"] == n and max(vs_rerun["pos_mm"]) == 0.0):
        raise AssertionError("pipelined, 10 LM iterations: the kernel engine did not repeat itself")
    if not (vs_plain["shared"] >= SHARED_MIN_FRAMES
            and max(vs_plain["pos_mm"][:vs_plain["shared"]]) <= POS_TOL_MM):
        raise AssertionError("pipelined, 10 LM iterations: kernels vs plain out of tolerance")

    # ---- the host synchronisations of one backend_step (frame 12)
    sites = runs["kernels"]["sites"]
    fetch = sum(c for (site, _, _), c in sites.items() if site.endswith(" to_numpy_tree"))
    total = sum(sites.values())
    log(f"host synchronisations in one backend_step (frame 12, sync debug mode 'warn'): {total}, "
        f"of them {fetch} in to_numpy_tree fetches, so {total - fetch} besides the fetch (limit "
        f"{SYNC_LIMIT}: the fetch and the marginalization's three eigh); by call site:")
    for (site, src, step_line), c in sites.most_common():
        log(f"  {c:4d} x {site}: {src}   (from backend_step line {step_line})")
    if not (fetch >= 1 and total <= SYNC_LIMIT):
        raise AssertionError(f"backend_step: {total} host synchronisations ({fetch} in fetches), "
                             f"limit {SYNC_LIMIT}")

    # ---- checkpoint round trip on the card
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a.npz"), os.path.join(tmp, "b.npz")
        save_engine(runs["kernels"]["engine"], a)
        save_engine(load_engine(VioEngine(cfg, device=dev), a), b)
        A, B = npz_arrays(a), npz_arrays(b)
        if A.keys() != B.keys() or not all(np.array_equal(A[k], B[k]) for k in A):
            raise AssertionError("checkpoint round trip on the card: arrays differ")
        log(f"checkpoint round trip on the card: {len(A)} arrays equal after save, load into a "
            f"fresh cuda engine, save")

    # ---- AsyncVioEngine (blocking) at the budget, in turns with the serial engine
    serial, asyncs, main_launches = [], {"kernels": []}, None
    for name in ("serial", "kernels", "kernels", "serial"):
        if name == "serial":
            r = drive_engine("serial, beside the pipelined runs", cfg, events, gt, dev, verbose=False)
            serial.append(r["fps"])
            continue
        eng = VioEngine(cfg, device=dev)
        main = not asyncs["kernels"]
        reset_counts()  # the pipelined main path: counts from 0 just before
        out = async_drive(eng, events)
        launches = read_counts()  # ... and read just after
        ate = check_pipelined(f"async [{name}]", out["results"], out["fed"], gt,
                              ATE_FACTOR["budget"], eng)
        if out["dropped"] or out["fed"] != n:
            raise AssertionError(f"async [{name}]: {out['dropped']} dropped of {out['fed']} fed")
        if not all(launches[k] > 0 for k in ON_PATH) or off_engine_path(launches):
            raise AssertionError(f"async [kernels]: B1 and the fused matcher not both launched, or "
                                 f"a kernel off the path was: {launches}")
        if main:
            main_launches = launches
        asyncs[name].append(out["fps"])
        log(f"AsyncVioEngine [{name}, blocking, budget]: {len(out['results'])} results for "
            f"{out['fed']} frames, 0 dropped, ATE {ate:.6f} m (bound "
            f"{ATE_FACTOR['budget'] * JAX_SPLIT_ATE_M:.6f} m), {out['fps']:.3f} frames/s end to end "
            f"({out['wall']:.2f} s); launches {launches}, per frame "
            f"{ {k: round(v / n, 2) for k, v in launches.items()} }")
    log(f"frames/s end to end, in turns (serial, async, async, serial): serial "
        f"{[round(x, 3) for x in serial]}, pipelined {[round(x, 3) for x in asyncs['kernels']]}")

    # ---- device-busy share over the first frames, serial and pipelined
    first = []
    for ev in events:
        if ev.kind == "frame" and sum(e.kind == "frame" for e in first) == 6:
            break
        first.append(ev)
    ser = device_profile(lambda: run_events(VioEngine(cfg, device=dev), first))
    pip = device_profile(lambda: async_drive(VioEngine(cfg, device=dev), first))
    log(f"device busy over the first 6 frames (torch.profiler): serial {100 * ser['busy']:.1f}% "
        f"of {ser['wall']:.2f} s, pipelined (AsyncVioEngine) {100 * pip['busy']:.1f}% of "
        f"{pip['wall']:.2f} s")

    # ---- live mode, fed at the sequence's rate
    out = async_drive(VioEngine(cfg, device=dev), events, blocking=False, pace=1.0)
    processed = len(out["results"])
    if processed + out["dropped"] != out["fed"] or not processed:
        raise AssertionError(f"live mode: {processed} processed + {out['dropped']} dropped != "
                             f"{out['fed']} fed")
    if not all(np.isfinite(r.T_WS.r).all() for r in out["results"]):
        raise AssertionError("live mode: non-finite pose")
    log(f"AsyncVioEngine [live, kernels, fed at 10 Hz]: {out['fed']} frames fed, {processed} "
        f"processed, {out['dropped']} dropped, {out['fps']:.3f} frames/s over {out['wall']:.2f} s")
    return main_launches


# ------------------------------------------------------------ loop closure
RETRIEVAL_K = 512 + 500  # WINDOW_CAP window descriptors + N_EXTRA_CORNERS fresh corners
TRAIN_N = 32768  # train_vocabulary's pooled descriptors, against its 1024 codewords
LOOP_RECENCY = 5  # RECENCY_EXCLUSION for the short revisit, as the JAX tests set it
# the entry point's synthetic sequence, seconds: at 20 Hz the engine's first
# keyframes track ~20% of their keypoints, and the health gate (new-keypoint
# ratio < 0.75) takes one of the first five
ENTRY_DURATION_S = "3.0"
# the health gate's run on the card: the gauntlet rig at the CLI parity
# test's quick case (tests/test_torch_cli_parity.py), a featureless stretch
# and primitive odometry
HEALTH_SETTINGS = {"SVIN_SYNTH_DURATION": "6", "SVIN_SYNTH_REVISIT": "1",
                   "SVIN_SYNTH_DEGRADE": "2:4", "SVIN_SYNTH_PRIMITIVE": "1"}
HEALTH_STRETCH = (2.0, 4.0)
# wall seconds of runs inside a phase, printed beside the phases'
SUBPHASE_S = {}
# the card's 6-DoF revisit path against a float64 CPU closer's
REF_TOL_M = 0.003
LOOP_STAGES = ("lc.1 describe_detect", "lc.2 bow", "lc.3 query", "lc.4 verify", "lc.4.1 match",
               "lc.4.2 p3p", "lc.5 pose_graph")


def loop_kernel_phase(dev) -> dict:
    """The two kernels at the loop path's shapes: the distance matrix at the
    product vocabulary's word assignment, (2, 1012, 4) x (2, 256, 4) (both
    128-bit halves in one launch, a per-batch b), then argmin; the fused
    matcher at loop verification, (512, 8) x (500, 8), valid masks, no gate,
    distance 80, mutual. Each bit for bit against its plain version on
    seeded inputs with planted ties, then timed in turns."""
    rng = np.random.default_rng(11)
    words = lambda shape: torch.as_tensor(  # noqa: E731
        rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32),
        device=dev)
    out = {}
    # ---- retrieval: ties planted (codewords repeated, descriptors on them)
    desc, vocab = words((RETRIEVAL_K, 8)), words((2, 256, 4))
    vocab[:, 200:] = vocab[:, 100:156]
    desc[:56] = torch.cat([vocab[0, 100:156], vocab[1, 100:156]], dim=1)
    a = torch.stack([desc[:, :4], desc[:, 4:]])
    d = hamming.hamming_matrix_cuda(a, vocab)
    want = hamming.hamming_matrix_plain(a, vocab)
    torch.cuda.synchronize()
    w_k, w_p = torch.argmin(d, dim=-1), torch.argmin(want, dim=-1)
    if not (torch.equal(d, want) and torch.equal(w_k, w_p) and bool((w_k[:, :56] < 200).all())):
        raise AssertionError("distance-matrix kernel != plain at the retrieval shape")
    pa, pbt = pm1_bits(a), pm1_bits(vocab).transpose(-1, -2).contiguous()  # (2,1012,128), (2,128,256)
    lib = lambda: torch.matmul(pa, pbt)  # noqa: E731
    if not torch.equal(((128 - lib().float()) / 2).to(torch.int32), d):
        raise AssertionError("fp16 +-1 matmul != Hamming distances at the retrieval shape")
    fns = {"kernel": lambda: hamming.hamming_matrix_cuda(a, vocab),
           "kernel+argmin": lambda: torch.argmin(hamming.hamming_matrix_cuda(a, vocab), dim=-1),
           "library": lib,
           "library+argmin": lambda: torch.argmax(lib(), dim=-1),
           "plain": lambda: hamming.hamming_matrix_plain(a, vocab)}
    t = in_turns(fns)
    tr_k = traced_ms(fns["kernel"])
    tr_l = traced_ms(lib)
    n_pairs = d.numel()
    # bytes: a and b read once, the (2, 1012, 256) int32 matrix written once;
    # operations: XOR, popcount and add per word
    bms, by = bound((a.numel() + vocab.numel() + n_pairs) * 4, n_pairs * 4 * 3)
    out["retrieval"] = dict(max_abs_err=0, ms=t["kernel"][0], host_us=t["kernel"][1],
                            argmin_ms=t["kernel+argmin"][0], plain_ms=t["plain"][0],
                            library_ms=t["library"][0], library_argmin_ms=t["library+argmin"][0],
                            bound_ms=bms, bound_by=by, traced_ms=tr_k[0], library_traced_ms=tr_l[0])
    log(f"distance matrix at the retrieval shape {tuple(a.shape)}x{tuple(vocab.shape)}: exact vs "
        f"plain, argmin identical (56 planted ties resolve to the lower index); device ms per call: "
        f"kernel {t['kernel'][0]:.5f}, kernel + argmin {t['kernel+argmin'][0]:.5f}, library (fp16 "
        f"matmul of unpacked +-1 bits, unpacking excluded) {t['library'][0]:.5f}, library + argmax "
        f"{t['library+argmin'][0]:.5f}, plain {t['plain'][0]:.5f}; host us per call kernel "
        f"{t['kernel'][1]:.1f}, library {t['library'][1]:.1f}; bound {bms * 1e3:.4f} us ({by}); "
        f"traced: kernel {traced_text(*tr_k)}, library {traced_text(*tr_l)}")
    out["nearest"] = nearest_phase(words, a, vocab, dev)
    # ---- verification: near matches, ties (repeated corners), masked rows
    A, B = words((512, 8)), words((500, 8))
    A[:200] = B[:200] ^ torch.as_tensor(rng.integers(0, 2, (200, 8)), dtype=torch.int32, device=dev)
    B[400:450] = B[:50]
    va = torch.arange(512, device=dev) < 470
    vb = torch.as_tensor(rng.random(500) < 0.95, device=dev)
    args = (A, B, va, vb, None)
    n_valid = check_matcher(args, "verification", max_distance=DESC_DIST_LOOP, mutual=True)
    kw = dict(max_distance=DESC_DIST_LOOP, mutual=True)
    t = in_turns({"kernel": lambda: hamming.match_descriptors_cuda(*args, **kw),
                  "unfused": lambda: unfused_match(*args, **kw),
                  "plain": lambda: hamming.match_descriptors_plain(*args, **kw)})
    tr_k = one_launch(lambda: hamming.match_descriptors_cuda(*args, **kw), "verification")
    tr_u = traced_ms(lambda: unfused_match(*args, **kw))
    bnd = matcher_bound((A.numel() + B.numel()) * 4 + 512 + 500 + 512 * 9, 512 * 500, 8)
    out["verification"] = dict(max_abs_err=0, ms=t["kernel"][0], host_us=t["kernel"][1],
                               plain_ms=t["plain"][0], unfused_ms=t["unfused"][0], **bnd,
                               traced_ms=tr_k[0], launches_per_call=tr_k[1],
                               unfused_traced_ms=tr_u[0])
    log(f"fused matcher at the verification shape (512,8)x(500,8), distance {DESC_DIST_LOOP}, "
        f"mutual, no gate: bit-exact vs plain ({n_valid} matches, 50 planted ties); device ms per "
        f"call fused {t['kernel'][0]:.5f} ({tr_k[1]:g} launch per call), distance-matrix kernel + "
        f"match() {t['unfused'][0]:.5f}, plain {t['plain'][0]:.5f}; host us {t['kernel'][1]:.1f}; "
        f"bound {bnd['bound_ms'] * 1e3:.4f} us ({bnd['bound_by']}, 1-bit tensor cores), popcounts "
        f"at __popc's rate {bnd['popc_bound_ms'] * 1e3:.4f} us; traced: fused "
        f"{traced_text(*tr_k)}, unfused {traced_text(*tr_u)}")
    return out


def nearest_phase(words, a, vocab, dev) -> dict:
    """The nearest-codeword kernel bit for bit against its plain version,
    ties planted, at the retrieval shape (``a``, ``vocab``: the product
    vocabulary's two halves, a per-batch codebook) and at train_vocabulary's
    (32768, 8) x (1024, 8) (a shared codebook); timed in turns with the
    distance-matrix kernel + argmin, one fp16 ``matmul`` of the unpacked ±1
    bits + argmax (two PyTorch calls; the yardstick), and the plain version.
    Two bounds: XOR, popcount and add per word at the float32 rate, and the
    popcounts alone at ``__popc``'s issue rate."""
    d2, v2 = words((TRAIN_N, 8)), words((1024, 8))
    v2[900:] = v2[100:224]  # equal codewords: ties
    d2[:124] = v2[100:224]
    rows = {}
    for name, desc, cb in (("retrieval", a, vocab), ("train_vocabulary", d2, v2)):
        got = hamming.nearest_codeword_cuda(desc, cb)
        want = hamming.nearest_codeword_plain(desc, cb)
        torch.cuda.synchronize()
        tie_lo, tie_hi = (100, 156) if name == "retrieval" else (100, 224)
        hits = got[..., :56] if name == "retrieval" else got[:124]
        if not (got.dtype == want.dtype == torch.int64 and torch.equal(got, want)
                and bool(((hits >= tie_lo) & (hits < tie_hi)).all())):
            raise AssertionError(f"nearest codeword != plain at the {name} shape")
        W = desc.shape[-1]
        pa, pbt = pm1_bits(desc), pm1_bits(cb).transpose(-1, -2).contiguous()
        lib = lambda pa=pa, pbt=pbt: torch.argmax(torch.matmul(pa, pbt), dim=-1)  # noqa: E731
        if not torch.equal(lib(), got):
            raise AssertionError(f"fp16 +-1 matmul + argmax != nearest codeword at {name}")
        fns = {"kernel": lambda d=desc, c=cb: hamming.nearest_codeword_cuda(d, c),
               "matrix+argmin": lambda d=desc, c=cb: torch.argmin(hamming.hamming_matrix_cuda(d, c),
                                                                  dim=-1),
               "library": lib,
               "plain": lambda d=desc, c=cb: hamming.nearest_codeword_plain(d, c)}
        t = in_turns(fns, n=TIMED_LAUNCHES if name == "retrieval" else 20)
        tr_k = traced_ms(fns["kernel"], n=20)
        tr_m = traced_ms(fns["matrix+argmin"], n=20)
        tr_l = traced_ms(lib, n=20)
        n_words = got.numel() * cb.shape[-2] * W  # word comparisons
        bms, by = bound((desc.numel() + cb.numel()) * 4 + got.numel() * 8, 3 * n_words)
        popc_ms = 1e3 * n_words / POPC_PER_S
        rows[name] = dict(max_abs_err=0, ms=t["kernel"][0], host_us=t["kernel"][1],
                          plain_ms=t["plain"][0], library_ms=t["library"][0],
                          matrix_argmin_ms=t["matrix+argmin"][0], bound_ms=bms, bound_by=by,
                          popc_bound_ms=popc_ms, traced_ms=tr_k[0],
                          matrix_argmin_traced_ms=tr_m[0], library_traced_ms=tr_l[0])
        log(f"nearest codeword at the {name} shape {tuple(desc.shape)}x{tuple(cb.shape)}: bit-exact "
            f"vs plain, planted ties to the lower index; device ms per call kernel "
            f"{t['kernel'][0]:.5f}, distance-matrix kernel + argmin {t['matrix+argmin'][0]:.5f}, "
            f"fp16 +-1 matmul + argmax (unpacking excluded) {t['library'][0]:.5f}, plain "
            f"{t['plain'][0]:.5f}; host us per call {t['kernel'][1]:.1f}; bound {bms * 1e3:.4f} us "
            f"({by}, float32 rate), popcounts at __popc's rate {popc_ms * 1e3:.4f} us; traced: "
            f"kernel {traced_text(*tr_k)}, matrix + argmin {traced_text(*tr_m)}, matmul + argmax "
            f"{traced_text(*tr_l)}")
    return rows


def revisit_exports(cfg, dev, n_traverse: int = 12, revisit_times=(0.0, 0.25, 0.5),
                    drift_step=(0.03, -0.02, 0.01)):
    """The JAX loop-closure tests' revisit drive (``tests/test_loopclosure.py``,
    ``test_loop_closure_reduces_trajectory_error_e2e``) at full width: the
    config's camera 0 (800x600, radial-tangential), a blob scene rendered on
    the card along the default trajectory, ``n_traverse`` keyframes 0.25 s
    apart then revisits of the first ones (offset by a few cm); keypoints
    detected at the config's 400, each associated with the landmark that
    projects within 2 px; VIO poses and maps carrying an accumulating
    translation drift. Returns (camera, exports, true positions)."""
    from svin_tpu_torch.cameras import project
    from svin_tpu_torch.kinematics import inverse, transform_point
    from svin_tpu_torch.ops import detection
    from svin_tpu_torch.pipeline import SyntheticRenderer

    rig = cfg.build_rig(torch.float64, dev)
    renderer = SyntheticRenderer(rig, n_points=600, seed=5, spread=6.0, depth_offset=3.0)
    cam = rig.cameras[0]
    lms = renderer.points_W
    times = [0.25 * k for k in range(n_traverse)] + list(revisit_times)
    drift = np.asarray(drift_step)
    exports, gt = [], []
    for k, t in enumerate(times):
        T = renderer.pose(t)
        T = type(T)(r=T.r.to(dev), q=T.q.to(dev))
        if k >= n_traverse:
            T = type(T)(r=T.r + torch.tensor([0.04, -0.02, 0.01], dtype=T.r.dtype, device=T.r.device),
                        q=T.q)
        img = renderer.render(T, 0)
        kp = detection.detect(img, max_keypoints=cfg.max_keypoints)
        uv, ok = project(cam, transform_point(inverse(T), lms))
        d2 = ((kp.uv.double()[:, None, :] - uv[None]) ** 2).sum(-1)
        d2 = torch.where(ok[None] & kp.valid[:, None], d2, torch.full_like(d2, 1e9))
        best, j = d2.min(dim=1)
        sel = (best < 4.0).cpu().numpy()
        j, kuv, lm = j.cpu().numpy()[sel], kp.uv.cpu().numpy()[sel], lms.cpu().numpy()
        d_k = k * drift
        quad = np.bincount((kuv[:, 1] >= cam.height / 2) * 2 + (kuv[:, 0] >= cam.width / 2),
                           minlength=4)
        exports.append({
            "kf_index": k, "timestamp": t + (10.0 if k >= n_traverse else 0.0),
            "image": img.cpu().numpy(), "T_WC_r": T.r.cpu().numpy() + d_k,
            "T_WC_q": T.q.cpu().numpy(), "points_W": lm[j] + d_k, "landmark_ids": j,
            "keypoints_uv": kuv, "quality": np.full(len(j), 0.5), "num_tracked": len(j),
            "num_new": 0, "quadrant_counts": quad, "response_strengths": np.ones(len(j)),
        })
        gt.append(T.r.cpu().numpy())
    return cam, exports, np.stack(gt)


def loop_drive(name, cfg, cam, exports, gt, dev, verbose=True, rmse_factor=0.6, **kw) -> dict:
    """One LoopCloser over the revisit exports; checks and prints what came
    out: loops, the optimized path's RMSE against the drifted one (below
    ``rmse_factor`` x, where it is not None), per keyframe ``add_keyframe``
    ms and stage times, launches per keyframe."""
    from svin_tpu_torch.loopclosure import LoopCloser

    closer = LoopCloser(cam, cfg, device=dev, **kw)
    draws, draw = {}, closer.draw_p3p

    def recorded(cur, old, valid, n):  # kept for a reference run to replay
        draws[(cur, old)] = hyp = draw(cur, old, valid, n)
        return hyp

    closer.draw_p3p = recorded
    Timing.reset()
    reset_counts()
    ms, loops = [], []
    for e in exports:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = closer.add_keyframe(e)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if lp is not None:
            loops.append((lp.query_index, lp.match_index, lp.num_inliers))
    closer.flush()
    launches = read_counts()
    n = len(exports)
    if len(closer.keyframes) != n:
        raise AssertionError(f"loop drive [{name}]: {len(closer.keyframes)} keyframes of {n}")
    if not loops or not any(q >= n - 3 for q, _, _ in loops):
        raise AssertionError(f"loop drive [{name}]: no revisit closed a loop: {loops}")
    vio = np.stack([e["T_WC_r"] for e in exports])
    rmse = lambda p: float(np.sqrt(np.mean(np.sum((p - gt) ** 2, axis=1))))  # noqa: E731
    r_vio, r_opt = rmse(vio), rmse(closer.optimized_path())
    if not np.isfinite(closer.optimized_path()).all():
        raise AssertionError(f"loop drive [{name}]: non-finite optimized path")
    if rmse_factor is not None and not r_opt < rmse_factor * r_vio:
        raise AssertionError(f"loop drive [{name}]: RMSE {r_opt:.4f} m not below {rmse_factor} x "
                             f"{r_vio:.4f} m")
    stages = {}
    for k in LOOP_STAGES:
        st = Timing.get(k)
        if st is not None:
            v = 1e3 * np.asarray(list(st.window))
            stages[k] = dict(n=st.count, median=float(np.median(v)), p90=float(np.percentile(v, 90)),
                             per_kf=float(v.sum()) / n)
    log(f"loop drive [{name}]: {n} keyframes, loops (query, match, inliers) {loops}; RMSE "
        f"drifted {r_vio:.4f} m -> optimized {r_opt:.4f} m ({r_opt / r_vio:.3f}x); "
        f"stats {closer.stats}")
    if verbose:
        log(f"  add_keyframe ms per keyframe: median {statistics.median(ms):.2f}, p90 "
            f"{float(np.percentile(ms, 90)):.2f}, max {max(ms):.2f}; per keyframe "
            f"{[round(x, 1) for x in ms]}")
        for k, v in stages.items():
            log(f"  {k}: {v['n']} calls, median {v['median']:.2f} ms, p90 {v['p90']:.2f} ms, "
                f"{v['per_kf']:.2f} ms per keyframe")
        per_kf = {k: round(v / n, 2) for k, v in launches.items()}
        log(f"  launches {launches}, per keyframe {per_kf}")
    return dict(loops=loops, launches=launches, ms=ms, stages=stages, rmse=(r_vio, r_opt),
                path=closer.optimized_path(), closer=closer, draws=draws)


def cpu_reference(name, cfg, cam, exports, run) -> None:
    """The card's closer against a float64 closer on the CPU, fed the
    descriptors the card computed (the closer's image-free intake) and the
    card's P3P draws: the same (query, match) loops, and the optimized path
    within REF_TOL_M of the reference and within a tenth of how far the
    reference's solve moved the path off the drifted one, so that a solve
    on the card that does not move the graph fails."""
    from svin_tpu_torch.loopclosure import LoopCloser

    draws = {k: v.cpu() for k, v in run["draws"].items()}

    def replay(cur, old, valid, n):
        if (cur, old) not in draws:
            raise AssertionError(f"CPU reference [{name}]: verifies ({cur}, {old}), the card did not")
        return draws[(cur, old)]

    ref = LoopCloser(cam, cfg, device="cpu", draw_p3p=replay)
    t0 = time.perf_counter()
    loops = []
    for e, kf in zip(exports, run["closer"].keyframes):
        free = {k: v for k, v in e.items() if k != "image"}
        free.update(window_desc=kf.window_desc, extra_desc=kf.extra_desc, extra_uv=kf.extra_uv,
                    extra_valid=kf.extra_valid)
        lp = ref.add_keyframe(free)
        if lp is not None:
            loops.append((lp.query_index, lp.match_index, lp.num_inliers))
    ref.flush()
    want = ref.optimized_path()
    moved = float(np.abs(want - np.stack([e["T_WC_r"] for e in exports])).max())
    err = float(np.abs(run["path"] - want).max())
    log(f"CPU reference [{name}] (float64, the card's descriptors and draws, "
        f"{time.perf_counter() - t0:.1f} s): loops {loops}; the solve moved the path by up to "
        f"{moved * 1e3:.3f} mm; the card's optimized path within {err * 1e3:.4f} mm of it")
    if [lp[:2] for lp in loops] != [lp[:2] for lp in run["loops"]]:
        raise AssertionError(f"CPU reference [{name}]: loops {loops} != card {run['loops']}")
    if not err < min(REF_TOL_M, 0.1 * moved):
        raise AssertionError(f"CPU reference [{name}]: card path {err * 1e3:.4f} mm off, tolerance "
                             f"{REF_TOL_M * 1e3} mm and a tenth of the {moved * 1e3:.3f} mm moved")


def entry_point_phase(dev) -> dict:
    """``svin_tpu_torch.apps.run_synchronous.main`` on the card at the
    underwater configuration with a short synthetic sequence and a
    checkpoint, then a second run resuming it. Every frame gets a result,
    every output is written and parses, the closer takes in every healthy
    keyframe and each goes through the nearest-codeword kernel once."""
    import contextlib
    import io

    from svin_tpu_torch import pipeline as tpipe
    from svin_tpu_torch.apps import run_synchronous
    from svin_tpu_torch.loopclosure import LoopCloser, check_health

    seen = dict(frames=0, results=0, exports=0, healthy=0, taken=0, bow=[],
                reasons=collections.Counter(), closer=collections.Counter())
    run_events0, add0 = tpipe.run_events, LoopCloser.add_keyframe

    def counted_run_events(engine, events):
        evs = list(events)
        seen["frames"] += sum(ev.kind == "frame" for ev in evs)
        res = run_events0(engine, evs)
        seen["results"] += len(res)
        return res

    def counted_add(closer, export):
        seen["exports"] += 1
        h = check_health(closer.cfg.health, int(export.get("num_tracked", 0)),
                         np.asarray(export.get("quadrant_counts", np.zeros(4))),
                         int(export.get("num_new", 0)),
                         np.asarray(export.get("response_strengths", np.zeros(0))))
        seen["healthy"] += int(h.healthy or not closer.cfg.health.enable)
        seen["reasons"][h.reason.split(" ")[0] if h.reason else "healthy"] += 1
        n0, before = len(closer.keyframes), read_counts()
        out = add0(closer, export)
        after = read_counts()
        seen["closer"].update({k: after[k] - before[k] for k in KERNELS})
        if len(closer.keyframes) > n0:
            seen["taken"] += 1
            seen["bow"].append(after["hamming_nearest"] - before["hamming_nearest"])
        return out

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SVIN_SYNTH_DURATION"] = ENTRY_DURATION_S
        tpipe.run_events, LoopCloser.add_keyframe = counted_run_events, counted_add
        try:
            for run, extra in (("first", ["--save-checkpoint", os.path.join(tmp, "s")]),
                               ("resumed", ["--resume", os.path.join(tmp, "s")])):
                for k in ("frames", "results", "exports", "healthy", "taken"):
                    seen[k] = 0
                seen["bow"], seen["reasons"], seen["closer"] = [], collections.Counter(), \
                    collections.Counter()
                d = os.path.join(tmp, run)
                reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as buf:
                    rc = run_synchronous.main([ENGINE_CONFIG, "--synthetic", d] + extra)
                wall = time.perf_counter() - t0
                launches = read_counts()
                summary = [x for x in buf.getvalue().splitlines() if x.startswith("frames:")]
                files = set(os.listdir(d))
                missing = {"svin_vio.txt", "svin_loop.txt", "svin_robust.txt", "state.csv",
                           "landmarks.csv", "global_map.ply", "keyframes.ply", "switch_info.txt",
                           "loop_stats.json", "top_view.png"} - files
                if rc != 0 or missing:
                    raise AssertionError(f"run_synchronous [{run}]: rc {rc}, missing {missing}")
                traj = np.loadtxt(os.path.join(d, "svin_vio.txt"), ndmin=2)
                loop_traj = np.loadtxt(os.path.join(d, "svin_loop.txt"), ndmin=2)
                np.loadtxt(os.path.join(d, "svin_robust.txt"), ndmin=2)
                state = np.loadtxt(os.path.join(d, "state.csv"), delimiter=",", ndmin=2)
                stats = json.loads(open(os.path.join(d, "loop_stats.json")).read())
                for ply in ("global_map.ply", "keyframes.ply"):
                    if not open(os.path.join(d, ply)).readline().startswith("ply"):
                        raise AssertionError(f"run_synchronous [{run}]: {ply} is not a PLY file")
                # the engine's trajectory carries a resumed session's frames too
                n_vio = seen["frames"] + (out["first"]["frames"] if run == "resumed" else 0)
                if not (seen["results"] == seen["frames"] == len(state)
                        and traj.shape == (n_vio, 8)):
                    raise AssertionError(f"run_synchronous [{run}]: {seen} results / frames, "
                                         f"state.csv {len(state)}, svin_vio {traj.shape}")
                if not (seen["taken"] == seen["healthy"] and seen["bow"] == [1] * seen["taken"]
                        and launches["hamming_nearest"] == seen["taken"]
                        and launches["hamming_matrix"] == 0
                        and all(launches[k] > 0 for k in ON_PATH)):
                    raise AssertionError(f"run_synchronous [{run}]: closer took {seen['taken']} of "
                                         f"{seen['healthy']} healthy of {seen['exports']} keyframes "
                                         f"(health {dict(seen['reasons'])}); nearest-codeword "
                                         f"launches per keyframe {seen['bow']}, total {launches}")
                n_restored = stats["n_restored"]
                if run == "resumed" and not (n_restored == out["first"]["n_kf"]
                                             and loop_traj.shape[0] == n_restored + seen["taken"]):
                    raise AssertionError(f"run_synchronous [resumed]: restored {n_restored}, "
                                         f"keyframes {loop_traj.shape[0]}")
                out[run] = dict(n_kf=stats["n_keyframes"], launches=launches, frames=seen["frames"],
                                taken=seen["taken"], closer_launches=dict(seen["closer"]))
                log(f"run_synchronous [{run}] on the card: {summary[0] if summary else ''}; "
                    f"{seen['results']} results for {seen['frames']} frames in {wall:.1f} s; "
                    f"{seen['exports']} keyframe exports, {seen['healthy']} healthy "
                    f"({dict(seen['reasons'])}), all taken by "
                    f"the closer, each through the nearest-codeword kernel once; restored "
                    f"{n_restored}; {len(files)} outputs parse; loops {stats['n_loops']}; launches "
                    f"{launches}, of them in the closer's add_keyframe {dict(seen['closer'])}")
        finally:
            tpipe.run_events, LoopCloser.add_keyframe = run_events0, add0
            os.environ.pop("SVIN_SYNTH_DURATION", None)
    if out["first"]["taken"] + out["resumed"]["taken"] < 1:
        raise AssertionError("run_synchronous: no healthy keyframe reached the closer in either run")
    out["health"] = health_gate_run()
    return out


def health_gate_run() -> dict:
    """``run_synchronous`` on the card with the gauntlet rig over a
    featureless stretch (HEALTH_SETTINGS): the health gate switches to the
    primitive estimator inside the stretch and back after it,
    ``svin_robust.txt`` and ``switch_info.txt`` are written and finite, and
    every keyframe the closer takes goes through the nearest-codeword kernel
    once. Launch counts from 0 just before the run, read just after."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import gauntlet_torch

    with tempfile.TemporaryDirectory() as d:
        run = gauntlet_torch.run_cli(gauntlet_torch.STEREO_YAML, HEALTH_SETTINGS, d, "cuda")
        probe, launches = run["probe"], run["launches"]
        sw = gauntlet_torch.switch_stamps(d)
        robust = np.loadtxt(os.path.join(d, "svin_robust.txt"), ndmin=2)
        stamps = [float(x.split()[0]) for x in open(os.path.join(d, "switch_info.txt"))
                  if x.strip()]
    SUBPHASE_S["health gate run"] = round(run["wall_s"], 1)
    t_p, t_v = sw["to_primitive_s"], sw["to_vio_s"]
    lo, hi = HEALTH_STRETCH
    if run["rc"] != 0 or t_p is None or t_v is None or not (lo <= t_p <= hi and t_v > t_p):
        raise AssertionError(f"health gate: rc {run['rc']}, switches {sw} (stretch {lo}-{hi} s)")
    if not (robust.shape[1] == 8 and len(robust) > 0 and np.isfinite(robust).all()
            and np.isfinite(stamps).all()):
        raise AssertionError(f"health gate: svin_robust.txt {robust.shape} or switch_info.txt "
                             f"{stamps} not finite")
    taken = sum(probe.kf_taken)
    if not (taken >= 1 and launches["hamming_nearest"] == taken
            and probe.closer_launches["hamming_nearest"] == taken
            and launches["hamming_matrix"] == 0 and all(launches[k] > 0 for k in ON_PATH)):
        raise AssertionError(f"health gate: the closer took {taken} of {len(probe.kf_taken)} "
                             f"keyframes; launches {launches}, in add_keyframe "
                             f"{dict(probe.closer_launches)}")
    log(f"health gate on the card ({HEALTH_SETTINGS}): VIO->PRIMITIVE at {t_p:.3f} s, back at "
        f"{t_v:.3f} s; {len(probe.frame_ms)} frames in {run['wall_s']:.1f} s, {len(robust)} "
        f"robust poses; the closer took {taken} of {len(probe.kf_taken)} keyframe exports, each "
        f"through the nearest-codeword kernel once; launches {launches}")
    return {"launches": launches, "closer_launches": dict(probe.closer_launches)}


def loop_probe(dev) -> None:
    """Where a verification and a pose-graph solve spend their time: one
    seed-free P3P RANSAC at the verification shape (512 rows, 200 matches,
    a third wrong, 100 hypotheses, float32) and one 4-DoF solve at the
    revisit drive's size (64 node slots, 128 edge slots, 30 GN iterations):
    host ms per call (synchronized), and device time and operations per call
    from a profiler trace."""
    from svin_tpu_torch.frontend.ransac import absolute_pose_ransac_p3p, draw_hypotheses
    from svin_tpu_torch.loopclosure import posegraph

    rng = np.random.default_rng(12)
    n, cap = 200, 512
    Pc = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 8, (n, 1))], 1)
    b = Pc + rng.normal(size=Pc.shape) * 2e-3
    bad = rng.choice(n, n // 3, replace=False)
    b[bad] = rng.normal(size=(len(bad), 3)) + np.array([0, 0, 3.0])
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    p_W, bear = np.zeros((cap, 3)), np.tile([0.0, 0.0, 1.0], (cap, 1))
    p_W[:n], bear[:n] = Pc + np.array([0.3, -0.2, 0.1]), b
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    valid = torch.arange(cap, device=dev) < n
    hyp = draw_hypotheses(valid, 100, 3, torch.Generator(device=dev).manual_seed(1))
    p_W_d, bear_d = f32(p_W), f32(bear)
    p3p = lambda: absolute_pose_ransac_p3p(  # noqa: E731
        hyp, p_W_d, bear_d, valid, focal_px=700.0, threshold_px=20.0, min_inliers=25)
    r = p3p()
    if not (bool(r.success) and int(r.num_inliers) >= 120):
        raise AssertionError(f"P3P probe: {int(r.num_inliers)} inliers")
    N, E = 64, 128
    yaw = np.cumsum(rng.normal(size=N) * 0.05)
    p = np.cumsum(rng.normal(size=(N, 3)) * 0.2, axis=0)
    i = np.r_[np.arange(N - 1), rng.integers(0, 8, E - N + 1)].astype(np.int32)
    j = np.r_[np.arange(1, N), rng.integers(N - 8, N, E - N + 1)].astype(np.int32)
    R = posegraph.ypr_to_matrix_np(yaw[i], 0 * yaw[i], 0 * yaw[i]).transpose(2, 0, 1)
    t_ij = np.einsum("eba,eb->ea", R, p[j] - p[i])
    nodes = posegraph.PoseGraphNodes(f32(p + 0.1), f32(yaw), f32(0 * yaw), f32(0 * yaw),
                                     torch.ones(N, dtype=torch.bool, device=dev))
    edges = posegraph.PoseGraphEdges(
        torch.as_tensor(i, device=dev), torch.as_tensor(j, device=dev), f32(t_ij),
        f32(yaw[j] - yaw[i]), f32(np.ones(E)), torch.as_tensor(np.arange(E) >= N - 1, device=dev),
        torch.ones(E, dtype=torch.bool, device=dev))
    pgo = lambda: posegraph.optimize_4dof(nodes, edges, 1, iters=30)  # noqa: E731
    for name, fn in (("P3P RANSAC (512 rows, 100 hypotheses)", p3p),
                     ("4-DoF pose graph (64 nodes, 128 edges, 30 GN iterations)", pgo)):
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        tr = traced_ms(fn, n=3)
        if tr[0] is None:  # the operation count varies between calls: read one trace
            tr = traced_ms(fn, n=1, tries=1, agree=False)
        log(f"{name}: host ms per call (synchronized) median {statistics.median(ms):.2f}; device "
            f"time per call {traced_text(*tr)}")


def loop_phase(dev) -> dict:
    from svin_tpu_torch.loopclosure import loop_closure

    cfg = load_config(ENGINE_CONFIG)
    t0 = time.perf_counter()
    cam, exports, gt = revisit_exports(cfg, dev)
    log(f"loop revisit input: {len(exports)} keyframes of {cam.width}x{cam.height} rendered on "
        f"the card in {time.perf_counter() - t0:.1f} s, window keypoints associated "
        f"{[e['num_tracked'] for e in exports]}")
    old = loop_closure.RECENCY_EXCLUSION
    loop_closure.RECENCY_EXCLUSION = LOOP_RECENCY
    log(f"loop closer: RECENCY_EXCLUSION {loop_closure.RECENCY_EXCLUSION} (50 by default), "
        f"N_EXTRA_CORNERS {loop_closure.N_EXTRA_CORNERS}, WINDOW_CAP {loop_closure.WINDOW_CAP}, "
        f"2 x 256-word product vocabulary, {cfg.loop_closure.pnp_ransac_iterations} P3P "
        f"hypotheses, min {cfg.loop_closure.min_correspondences} correspondences, 30 GN "
        f"iterations (4-DoF); P3P draws from the closer's generator seeded per pair, the same "
        f"in every run")
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            main_run = loop_drive("kernels, 4-DoF", cfg, cam, exports, gt, dev)
            plain = loop_drive("plain, 4-DoF", cfg, cam, exports, gt, dev, verbose=False,
                               matcher=hamming.match_descriptors_plain,
                               nearest=hamming.nearest_codeword_plain)
        finally:
            torch.use_deterministic_algorithms(False)
        if plain["loops"] != main_run["loops"]:
            raise AssertionError(f"loop drive: kernels {main_run['loops']} != plain {plain['loops']}")
        if any(plain["launches"].values()):
            raise AssertionError(f"loop drive [plain]: a kernel was launched: {plain['launches']}")
        if not (main_run["launches"]["hamming_nearest"] == len(exports)
                and main_run["launches"]["hamming_matrix"] == 0
                and main_run["launches"]["hamming_match"] > 0):
            raise AssertionError(f"loop drive: nearest codeword not once per keyframe, the "
                                 f"distance matrix launched, or the fused matcher not: "
                                 f"{main_run['launches']}")
        log(f"loop drive, kernels vs plain: the same loops and inlier counts; optimized paths "
            f"within {float(np.abs(main_run['path'] - plain['path']).max()) * 1e3:.3f} mm")
        cfg6 = load_config(ENGINE_CONFIG)
        cfg6.loop_closure.pgo_mode = "6dof"
        # the 6-DoF graph whitens a loop residual by 20 before its Huber(0.1)
        # weight, so a drift of a few decimetres barely moves it (the JAX
        # package's graph does the same; the CPU parity tests hold the port
        # to it in 6-DoF): no RMSE bound, the same loops as the 4-DoF run and
        # the path of a float64 CPU closer on the same descriptors and draws
        six = loop_drive("kernels, 6-DoF", cfg6, cam, exports, gt, dev, verbose=False,
                         rmse_factor=None)
        if six["loops"] != main_run["loops"]:
            raise AssertionError(f"loop drive 6-DoF: loops {six['loops']} != 4-DoF {main_run['loops']}")
        cpu_reference("kernels, 6-DoF", cfg6, cam, exports, six)
        log(f"loop drive 6-DoF: the 4-DoF run's loops; add_keyframe median "
            f"{statistics.median(six['ms']):.2f} ms, p90 {float(np.percentile(six['ms'], 90)):.2f} "
            f"ms; pose graph "
            f"{six['stages'].get('lc.5 pose_graph', {}).get('median', float('nan')):.2f} ms median "
            f"per solve; launches per keyframe "
            f"{ {k: round(v / len(exports), 2) for k, v in six['launches'].items()} }")
    finally:
        loop_closure.RECENCY_EXCLUSION = old
    loop_probe(dev)
    entry = entry_point_phase(dev)
    # every launch of the phase, and those of the closer alone (the revisit
    # drives, and add_keyframe within the apps)
    launches = {k: main_run["launches"][k] + six["launches"][k] + entry["first"]["launches"][k]
                + entry["resumed"]["launches"][k] + entry["health"]["launches"][k]
                for k in KERNELS}
    closer = {k: main_run["launches"][k] + six["launches"][k]
              + entry["first"]["closer_launches"].get(k, 0)
              + entry["resumed"]["closer_launches"].get(k, 0)
              + entry["health"]["closer_launches"].get(k, 0) for k in KERNELS}
    return launches, closer


# -------------------------------------------------- the closer past 512 nodes
SCALABLE_NODES = (513, 1024)
# tests/test_loopcloser_scale.py's in-situ drive: keyframes, first revisit, radius (m)
DRIVE = (2120, 2100, 80.0)
# the card's float32 scalable solve against the port's float64 one on the
# CPU: the chain's slow yaw ramp is a quasi-null mode of an anchored pose
# graph, along which float32 and float64 runs part by up to ~1 cm (printed
# below); the loop residuals and the cost are what agree
SCALABLE_PATH_TOL_M = 0.02
LOOP_RESIDUAL_M = 0.01  # the JAX tests' bound on loop residuals (tests/test_pcg.py:240)


def closer_past_512(mode, n, dev):
    """A port closer on ``dev`` (float32 on the card, float64 on the CPU)
    holding ``n`` keyframes in place, as a long session leaves them
    (``tests/test_torch_loopclosure.py``'s graph): a circle of radius 20 m
    lapped twice whose VIO poses carry a yaw random walk, sequential edges
    from the VIO poses, loop edges at the true relative poses from the
    second lap back to the first every 32 keyframes."""
    from svin_tpu_torch.kinematics import npq
    from svin_tpu_torch.loopclosure import loop_closure as tlc
    from svin_tpu_torch.loopclosure.posegraph import ypr_to_matrix_np as ypr

    cfg = load_config(ENGINE_CONFIG)
    cfg.loop_closure.pgo_mode = mode
    closer = tlc.LoopCloser(_drive_camera(dev), cfg, capacity=1024, device=dev)
    rng = np.random.default_rng(7)
    th = np.linspace(0, 4 * np.pi, n)
    p_gt = np.stack([20.0 * np.cos(th), 20.0 * np.sin(th), 0.1 * np.sin(3 * th)], 1)
    yaw_gt = th + np.pi / 2
    yaw_vio = yaw_gt + np.cumsum(rng.normal(0, 2e-3, n))
    p_vio = np.cumsum([p_gt[0]] + [ypr(yaw_vio[k - 1], 0, 0) @ ypr(yaw_gt[k - 1], 0, 0).T
                                   @ (p_gt[k] - p_gt[k - 1]) for k in range(1, n)], axis=0)
    z8 = np.zeros((8, 8), np.int32)
    for k in range(n):
        T = Transformation(r=p_vio[k], q=npq.from_rotation_matrix(ypr(yaw_vio[k], 0, 0)))
        closer.keyframes.append(tlc.LoopKeyframe(
            index=k, timestamp=float(k), T_WC_vio=T, points_W=np.zeros((0, 3)),
            point_uv=np.zeros((0, 2)), window_desc=z8, window_valid=np.zeros(8, bool),
            extra_uv=np.zeros((8, 2), np.float32), extra_desc=z8, extra_valid=np.zeros(8, bool)))
        closer.nodes.p[k], closer.nodes.yaw[k], closer.nodes.valid[k] = p_vio[k], yaw_vio[k], True
        for back in range(1, (4 if mode == "6dof" else 2) + 1):
            if k - back >= 0:
                closer._add_sequential_edge(k - back, k)
    for k in range(n // 2 + 8, n, 32):
        m = k - n // 2
        rel_t = ypr(yaw_gt[m], 0, 0).T @ (p_gt[k] - p_gt[m])
        rel_yaw = float(yaw_gt[k] - yaw_gt[m])
        closer._add_loop_edge(tlc.LoopInfo(k, m, 40, rel_t, rel_yaw, rel_t_full=rel_t,
                                           rel_q_full=npq.from_rotation_matrix(ypr(rel_yaw, 0, 0))))
        closer.earliest_loop_index = min(closer.earliest_loop_index, m)
    return closer


def _drive_camera(dev):
    """tests/test_loopcloser_scale.py's camera (200x150, f = 160 px)."""
    from svin_tpu_torch.cameras import make_camera

    return make_camera(200, 150, 160.0, 160.0, 100.0, 75.0, model="none", device=dev)


def loop_residuals(closer) -> np.ndarray:
    """Translation residual (m) of every valid loop edge of a closer's graph."""
    from svin_tpu_torch.loopclosure.posegraph import ypr_to_matrix_np as ypr

    e, nd = closer.edges, closer.nodes
    kk = np.nonzero(e.valid[: closer.n_edges] & e.is_loop[: closer.n_edges])[0]
    return np.array([np.linalg.norm(ypr(nd.yaw[i], nd.pitch[i], nd.roll[i]).T @ (nd.p[j] - nd.p[i])
                                    - e.t_ij[k]) for k, i, j in zip(kk, e.i[kk], e.j[kk])])


class SolverProbe:
    """Wraps the closer's scalable solver (``optimize_4dof_pcg`` or
    ``optimize_6dof_pcg``, looked up by the closer at call time): keeps the
    last call's arguments, and runs a call under the CUDA sync debug mode
    that raises on a host synchronisation when ``strict`` is set."""

    def __init__(self, module, name):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.args, self.strict, self.calls = None, False, 0

    def __call__(self, *args, **kw):
        self.args, self.calls = (args, kw), self.calls + 1
        if not self.strict:
            return self.fn(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = self.fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def timed_ms(fn, n=3) -> list:
    """Host ms per call of ``fn`` (synchronized), ``n`` calls."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def scalable_solves(dev) -> None:
    """The closer's solve past 512 nodes on in-place graphs of 513 and
    1,024 keyframes, 4-DoF (PCG, 30 GN x 96 CG) and 6-DoF (PCG, 10 GN x
    96 CG), float32: the scalable branch taken, one solver run under the sync
    debug mode that raises, the loop residuals down (4-DoF under
    LOOP_RESIDUAL_M; 6-DoF to under half: its loop edges are whitened by 20
    before a Huber(0.1), as the JAX closer's), and the port's float64 closer
    on the CPU on the same graph: its loop residuals and its path within
    SCALABLE_PATH_TOL_M. ms per solve (median of 3), and at 1,024 keyframes
    the solver's traced device ms and operations and the dense 4-DoF solve
    beside the scalable one."""
    from svin_tpu_torch.loopclosure import posegraph
    from svin_tpu_torch.parallel import pcg

    for mode in ("4dof", "6dof"):
        for n in SCALABLE_NODES:
            closer = closer_past_512(mode, n, dev)
            snap = ([a.copy() for a in closer.nodes], closer.edges.valid.copy())
            res0 = loop_residuals(closer)

            def solve():
                for a, b in zip(closer.nodes, snap[0]):
                    a[...] = b
                closer.edges.valid[...] = snap[1]
                closer._optimize_and_update_drift()

            name = "optimize_4dof_pcg" if mode == "4dof" else "optimize_6dof_pcg"
            with SolverProbe(pcg, name) as probe:
                probe.strict = True
                solve()  # builds nothing new: the first solve, strict
                probe.strict = False
                ms = timed_ms(solve)
            if closer.pgo_log[-1]["branch"] != "scalable" or probe.calls < 4:
                raise AssertionError(f"closer past 512 [{mode}, {n}]: branch "
                                     f"{closer.pgo_log[-1]['branch']}, solver calls {probe.calls}")
            res = loop_residuals(closer)
            if not np.isfinite(closer.optimized_path()).all() or not (
                    res.max() < LOOP_RESIDUAL_M if mode == "4dof" else res.max() < 0.5 * res0.max()):
                raise AssertionError(f"closer past 512 [{mode}, {n}]: loop residuals {res0.max():.4f}"
                                     f" -> {res.max():.4f} m")
            ref = closer_past_512(mode, n, "cpu")
            # one CPU thread: the solve's small ops on a host shared with
            # other jobs take 3-7x longer across 8 threads than on one
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                t0 = time.perf_counter()
                ref._optimize_and_update_drift()
                t_ref = time.perf_counter() - t0
            finally:
                torch.set_num_threads(threads)
            err = float(np.abs(closer.optimized_path() - ref.optimized_path()).max())
            res_ref = loop_residuals(ref)
            if not err < SCALABLE_PATH_TOL_M:
                raise AssertionError(f"closer past 512 [{mode}, {n}]: card path {err:.4f} m off the "
                                     f"float64 CPU solve's")
            args, kw = probe.args
            # both sizes solve a 1,024-node prefix: one trace (~115k device
            # operations for the 4-DoF solve) at the larger
            tr = (traced_ms(lambda: probe.fn(*args, **kw), n=1, tries=1, agree=False)
                  if n == SCALABLE_NODES[-1] else None)
            log(f"closer past 512 [{mode}, {n} keyframes, {closer._prefix()[0]}-node prefix, "
                f"{closer.n_edges} edges]: branch scalable, one solver run without a host sync; "
                f"loop residuals {res0.max():.4f} -> {res.max():.6f} m (CPU float64 "
                f"{res_ref.max():.6f} m, {t_ref:.1f} s); path within {err * 1e3:.3f} mm of the "
                f"CPU float64 solve's; ms per solve median {statistics.median(ms):.2f} "
                f"({[round(x, 2) for x in ms]}); the solver alone: device time per call "
                f"{traced_text(*tr) if tr else 'traced at the larger graph'}; pgo_log "
                f"{closer.pgo_log[-1]}")
            if mode == "4dof" and n == SCALABLE_NODES[-1]:
                Np, Ep = closer._prefix()
                f = lambda a: closer._dev(a, closer.dtype if a.dtype.kind == "f" else None)  # noqa
                nd = posegraph.PoseGraphNodes(*(f(a[:Np]) for a in snap[0]))
                ed = posegraph.PoseGraphEdges(*(f(a[:Ep]) for a in closer.edges))
                fix = max(closer.earliest_loop_index + 1, 1)
                dense = lambda: posegraph.optimize_4dof(nd, ed, fix, iters=30)  # noqa: E731
                dense()
                dms = timed_ms(dense)
                trd = traced_ms(dense, n=1, tries=1, agree=False)
                scalable = lambda: pcg.optimize_4dof_pcg(  # noqa: E731
                    nd, ed, fix, iters=30, cg_iters=96, coarse_group=32)
                sms = timed_ms(scalable)
                log(f"  4-DoF at {Np} nodes, 30 GN iterations, the solver alone: dense "
                    f"optimize_4dof (({4 * Np})^2 Cholesky) median {statistics.median(dms):.2f} ms, "
                    f"device {traced_text(*trd)}; scalable PCG (96 CG per GN) median "
                    f"{statistics.median(sms):.2f} ms")


def scalable_drive(dev) -> dict:
    """tests/test_loopcloser_scale.py:216 on the card: DRIVE[0] image-free
    keyframes (``problems.closer_drive``) through ``add_keyframe`` at the
    test's settings (6 GN x 32 CG, 25 correspondences, 64 P3P hypotheses),
    loops at the end: capacity doubled past 2,048, a loop verified from the
    revisit, the database's device query and inverted file used, the
    corrected path better than half the drifted one's median error, the
    nearest codeword once per keyframe (launch counts from 0 just before the
    drive, read just after). add_keyframe ms (median, p90)."""
    from svin_tpu_torch.loopclosure import LoopCloser

    n, start, radius = DRIVE
    cfg = load_config(ENGINE_CONFIG)
    cfg.health.enable = False
    cfg.loop_closure.min_correspondences = 25
    cfg.loop_closure.pnp_ransac_iterations = 64
    closer = LoopCloser(_drive_camera(dev), cfg, device=dev)
    closer.pgo_gn_iters, closer.pgo_cg_iters = 6, 32
    exports, pos_true, pos_vio = problems.closer_drive(closer.camera, n, start, radius)
    Timing.reset()
    reset_counts()
    ms, n_loops = [], 0
    for e in exports:
        t0 = time.perf_counter()
        n_loops += closer.add_keyframe(e) is not None
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    path = closer.optimized_path()
    err_c = np.linalg.norm(path[start:] - pos_true[start:], axis=1)
    err_v = np.linalg.norm(pos_vio[start:] - pos_true[start:], axis=1)
    solves = [e for e in closer.pgo_log if e["branch"] == "scalable"]
    log(f"in-situ drive [{n} keyframes, loops from {start}]: {n_loops} loops (first "
        f"{closer.loops[0].query_index if closer.loops else None} -> "
        f"{closer.loops[0].match_index if closer.loops else None}), capacity {closer.capacity}, "
        f"database {closer.db.count} entries ({len(closer.db._inv)} inverted-file words), "
        f"{len(solves)} scalable solves (wall s {[e['wall_s'] for e in solves]}); median error "
        f"corrected {np.median(err_c):.3f} m vs drifted {np.median(err_v):.3f} m; add_keyframe ms "
        f"median {statistics.median(ms):.2f}, p90 {float(np.percentile(ms, 90)):.2f}, max "
        f"{max(ms):.2f}; stats {closer.stats}; launches {launches}")
    for k in ("lc.2 bow", "lc.3 query", "lc.4 verify", "lc.5 pose_graph"):
        st = Timing.get(k)
        if st is not None:
            v = 1e3 * np.asarray(list(st.window))
            log(f"  {k}: {st.count} calls, median {float(np.median(v)):.2f} ms (last "
                f"{len(v)}), p90 {float(np.percentile(v, 90)):.2f} ms")
    if not (len(closer.keyframes) == n and closer.capacity > 2048 and n_loops >= 1
            and closer.loops[0].query_index >= start and solves
            and closer.db.count >= closer.db.DEVICE_QUERY_AT and len(closer.db._inv) > 0
            and np.median(err_c) < 0.5 * np.median(err_v)):
        raise AssertionError("in-situ drive: a check of tests/test_loopcloser_scale.py:216 failed")
    if not (launches["hamming_nearest"] == n and launches["hamming_matrix"] == 0):
        raise AssertionError(f"in-situ drive: nearest codeword not once per keyframe: {launches}")
    return launches


def scalable_phase(dev) -> dict:
    scalable_solves(dev)
    return scalable_drive(dev)


# ---------------------------------------------------------------- global BA
BA_K = (64, 128, 170)  # D = 6K = 384 (the problem's default K), 768, 1020: the cluster kernel
BA_ITERS = 10
BA_PERTURB_M = 0.05  # pose perturbation (the JAX BA tests'), seeded, the two gauge poses kept
BA_POSE_TOL_M = 0.01  # the JAX BA tests' bound against the truth (tests/test_dist_ba.py:66)
# a route with the kernels against the same route with the plain solve on the
# card, under deterministic algorithms: float32 solves that round differently,
# carried through BA_ITERS GN steps (float32 and float64 runs of the same
# route on the CPU agree to ~1e-6 m at K = 12 and 64)
BA_KERNEL_TOL_M = 1e-4
# the cluster kernel on every reduced system a run gave it, against the plain
# solve on the same system: check_solve's limits (relative residual, here in
# float64, and relative distance to the plain solution). Near the optimum b
# shrinks by 1e5 while H keeps its ~1e7 condition, and the float32 plain
# solve's own residual reaches ~5e-5 there (CPU, K = 64-170), so the residual
# limit is 1e-4 or 4x the plain solve's residual on that system, the larger
BA_STEP_RESIDUAL, BA_STEP_DISTANCE = 1e-4, 1e-3


def ba_problem(K, dev):
    """``problems.build_global_ba_problem`` at L = 4096, O = 16384 and K
    poses, float32, its non-gauge poses perturbed by BA_PERTURB_M (seeded):
    (truth, start, rig)."""
    prob, rig = problems.build_global_ba_problem(np.random.default_rng(3), K=K, L=4096, O=16384,
                                                 device=dev)
    dp = torch.as_tensor(np.random.default_rng(4).normal(0, BA_PERTURB_M, (K, 3)),
                         dtype=torch.float32, device=dev)
    return prob, prob._replace(pose_r=prob.pose_r + dp * (~prob.pose_fixed)[:, None]), rig


def check_step_systems(systems, what: str) -> str:
    """``spd_solve_cluster`` against ``solve_spd_plain`` on each (H, b) a GN
    run solved (BA_STEP_RESIDUAL, BA_STEP_DISTANCE): the worst residual and
    distance, as text."""
    worst_r = worst_d = 0.0
    for H, b in systems:
        x, ref = solve.spd_solve_cluster(H, b), solve.solve_spd_plain(H, b)
        Hd, bd = H.double(), b.double()
        res = lambda v: float(torch.linalg.norm(Hd @ v.double() - bd) / torch.linalg.norm(bd))  # noqa
        r, r_plain = res(x), res(ref)
        d = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
        if not (r <= max(BA_STEP_RESIDUAL, 4 * r_plain) and d <= BA_STEP_DISTANCE):
            raise AssertionError(f"{what}: cluster kernel on a GN step's system: relative residual "
                                 f"{r:.3e} (plain {r_plain:.3e}), distance to plain {d:.3e}")
        worst_r, worst_d = max(worst_r, r), max(worst_d, d)
    return (f"cluster kernel on the run's {len(systems)} step systems: relative residual <= "
            f"{worst_r:.3e}, distance to plain <= {worst_d:.3e}")


def keeping_solve(systems: list):
    """``solve.solve_spd`` that keeps each system it is given."""
    def keep(H, b):
        systems.append((H, b))
        return solve.solve_spd(H, b)
    return keep


def global_ba_phase(dev) -> dict:
    """Global BA at the problem's defaults (K = 64, L = 4096, O = 16384),
    float32, through ``ba_solve_local``, ``ba_solve_bucketed`` and
    ``ba_solve_pcg`` (pose-major index, 48 CG per GN), BA_ITERS GN steps
    from the perturbed start: the cost falls, the poses within BA_POSE_TOL_M
    of the truth, the dense routes launch the cluster kernel once per GN
    step (counts from 0 just before, read just after), the kernel within
    check_step_systems's limits of the plain solve on every system the run
    gave it, each dense route within BA_KERNEL_TOL_M of itself with the
    plain solve on the card and PCG within BA_POSE_TOL_M of the dense
    optimum (deterministic algorithms). ms per GN step (the run's host time
    over BA_ITERS steps, median of 3). Then ``ba_solve_local`` at K = 128
    and 170 (D = 768, 1020), checked the same way: ms per GN step and the
    solve's share of it (the last step's reduced system solved alone by
    the cluster kernel and by the library Cholesky, device ms)."""
    from svin_tpu_torch import parallel as tpar

    truth, start, rig = ba_problem(BA_K[0], dev)
    bstart = tpar.bucket_problem(start)
    perm = tpar.pose_major_index(bstart.obs_pose, bstart.obs_valid, BA_K[0])
    _, cost0 = tpar.ba_solve_bucketed(bstart, rig, iters=0, solve=solve.solve_spd_plain)
    routes = {
        "local": lambda **kw: tpar.ba_solve_local(start, rig, iters=BA_ITERS, **kw),
        "bucketed": lambda **kw: tpar.ba_solve_bucketed(bstart, rig, iters=BA_ITERS, **kw),
        "pcg": lambda: tpar.ba_solve_pcg(bstart, rig, iters=BA_ITERS, cg_iters=48, pose_perm=perm),
    }
    launches = {k: 0 for k in KERNELS}
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, run in routes.items():
            systems = []
            reset_counts()
            res, cost = run() if name == "pcg" else run(solve=keeping_solve(systems))
            torch.cuda.synchronize()
            got = read_counts()
            for k in KERNELS:
                launches[k] += got[k]
            err = float((res.pose_r - truth.pose_r).abs().max())
            line = (f"global BA [{name}, K={BA_K[0]}, D={6 * BA_K[0]}]: cost {float(cost0):.4f} -> "
                    f"{float(cost):.3e}, poses within {err * 1e3:.4f} mm of the truth; launches "
                    f"{ {k: v for k, v in got.items() if v} }")
            if not (float(cost) < float(cost0) and err < BA_POSE_TOL_M):
                raise AssertionError(line)
            if name == "pcg":
                dense = (out["bucketed"].pose_r - res.pose_r).abs().max()
                line += f"; within {float(dense) * 1e3:.4f} mm of the bucketed optimum"
                if not float(dense) < BA_POSE_TOL_M or any(got.values()):
                    raise AssertionError(line)
            else:
                plain, _ = run(solve=solve.solve_spd_plain)
                d = float((plain.pose_r - res.pose_r).abs().max())
                line += f"; plain solve on the card within {d * 1e3:.5f} mm"
                if got["spd_solve_cluster"] != BA_ITERS or not d < BA_KERNEL_TOL_M:
                    raise AssertionError(line)
                line += "; " + check_step_systems(systems, f"global BA [{name}, K={BA_K[0]}]")
            out[name] = res
            log(line)
    finally:
        torch.use_deterministic_algorithms(False)
    for name, run in routes.items():
        ms = timed_ms(run)
        log(f"  [{name}] ms per GN step median {statistics.median(ms) / BA_ITERS:.3f} "
            f"({[round(x / BA_ITERS, 3) for x in ms]})")
    for K in BA_K[1:]:
        truth, start, rig = ba_problem(K, dev)
        seen = []
        reset_counts()
        res, cost = tpar.ba_solve_local(start, rig, iters=BA_ITERS, solve=keeping_solve(seen))
        torch.cuda.synchronize()
        got = read_counts()
        for k in KERNELS:
            launches[k] += got[k]
        err = float((res.pose_r - truth.pose_r).abs().max())
        if not (got["spd_solve_cluster"] == BA_ITERS and err < BA_POSE_TOL_M):
            raise AssertionError(f"global BA [local, K={K}]: launches {got}, poses {err} m off")
        checked = check_step_systems(seen, f"global BA [local, K={K}]")
        ms = timed_ms(lambda: tpar.ba_solve_local(start, rig, iters=BA_ITERS))
        step = statistics.median(ms) / BA_ITERS
        H, b = seen[-1]
        t = in_turns({"cluster": lambda: solve.spd_solve_cluster(H, b),
                      "library": lambda: cholesky_library(H, b)}, n=20)
        log(f"global BA [local, K={K}, D={6 * K}]: poses within {err * 1e3:.4f} mm of the truth; "
            f"ms per GN step median {step:.3f}; the step's solve alone: cluster kernel "
            f"{t['cluster'][0]:.5f} ms ({100 * t['cluster'][0] / step:.2f}% of the step), library "
            f"Cholesky {t['library'][0]:.5f} ms; launches { {k: v for k, v in got.items() if v} }; "
            f"{checked}")
    return launches


# ------------------------------------------------- global BA at the Cave shape
CAVE = (2048, 65536, 8, 1024)  # keyframes, landmarks, span, block: bench.py's track shape
CAVE_REDUCED = (256, 8192, 8, 256)  # the shape the float64 CPU solve checks the card at
CAVE_GN, CAVE_CG = 2, 32  # bench.py's budget
# the track solver and the bucketed PCG, float32 on the card, on the same
# problem: the same linear algebra summed in other orders, which a truncated
# CG carries into the poses (they part by 2.6e-5 / 4.2e-5 m on the CPU in
# float32 at K = 512 / 256, and by 1e-13 in float64)
TRACKS_PCG_TOL_M = 5e-4
# the card's float32 track solve against the port's float64 one on the CPU at
# CAVE_REDUCED: poses (the CPU's float32 solve lands 2.5e-5 m off), and the
# cost, which float32 rounds at ~2e-5 px per 400 px projection where the
# residuals left are ~1e-2 px
TRACKS_F64_TOL_M, TRACKS_F64_COST_RTOL = 2e-4, 5e-3


def cave_problem(K, L, span, dtype, dev, seed=5):
    """``problems.build_global_ba_tracks`` (float ``dtype`` on ``dev``), its
    free poses moved by 2 cm and its landmarks by 5 cm (seeded; the JAX
    tests' perturbation, tests/test_tracks.py:122): (truth, start, rig)."""
    prob, rig = problems.build_global_ba_tracks(np.random.default_rng(seed), K=K, L=L, span=span,
                                                dtype=dtype, device=dev)
    rng = np.random.default_rng(seed + 1)
    dp = torch.as_tensor(rng.normal(0, 0.02, (K, 3)), dtype=dtype, device=dev)
    dl = torch.as_tensor(rng.normal(0, 0.05, (L, 3)), dtype=dtype, device=dev)
    return prob, prob._replace(pose_r=prob.pose_r + dp * (~prob.pose_fixed)[:, None],
                               lm=prob.lm + dl), rig


def cave_ba_phase(dev) -> dict:
    """Global BA at the Cave shape: ``build_global_ba_tracks`` at 2,048
    keyframes and 65,536 landmarks (span 8, float32, on the card),
    perturbed, through ``ba_solve_tracks`` (blocks of 1,024: 64 blocks, 16
    slots per landmark) and through ``ba_solve_pcg`` on ``bucket_problem``'s
    default buckets with ``pose_major_index``, both at bench.py's budget (2
    GN x 32 CG): the cost falls on both, one track solve under the sync
    debug mode that raises, the two solvers' poses within
    TRACKS_PCG_TOL_M, no kernel launched (counts from 0 just before, read
    just after). ms per GN step (host, median of 3, in turns), traced device
    ms and operations per GN step, the device-busy share and the peak memory
    of a run. Then at CAVE_REDUCED the card's float32 track solve against
    the port's float64 one on the CPU (one thread): poses within
    TRACKS_F64_TOL_M, cost within TRACKS_F64_COST_RTOL."""
    from svin_tpu_torch import parallel as tpar

    K, L, span, block = CAVE
    t0 = time.perf_counter()
    _, start, rig = cave_problem(K, L, span, torch.float32, dev)
    tp, meta, _ = tpar.tracks_from_problem(start, span=span, block=block)
    bp = tpar.bucket_problem(start)
    perm = tpar.pose_major_index(bp.obs_pose, bp.obs_valid, K)
    torch.cuda.synchronize()
    log(f"global BA at the Cave shape [K={K}, L={L}, span {span}]: {int(start.obs_valid.sum())} "
        f"valid observations ({int(tp.ov_valid.sum())} in the overflow, M={meta.M}); tracks "
        f"{meta.n_blocks} blocks of {meta.B}, {meta.slots} slots, window S={meta.S}; PCG buckets "
        f"R={bp.obs_pose.shape[1]}, pose-major index {tuple(perm.shape)}; build and relayouts "
        f"{time.perf_counter() - t0:.1f} s")
    routes = {
        "tracks": lambda: tpar.ba_solve_tracks(tp, rig, meta, iters=CAVE_GN, cg_iters=CAVE_CG),
        "pcg": lambda: tpar.ba_solve_pcg(bp, rig, iters=CAVE_GN, cg_iters=CAVE_CG, pose_perm=perm),
    }
    _, cost0 = tpar.ba_solve_tracks(tp, rig, meta, iters=0)
    reset_counts()
    out, peak = {}, {}
    for name, run in routes.items():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[name] = run()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - held) / 2**30
    launches = read_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        routes["tracks"]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms = {k: [] for k in routes}
    for _ in range(3):
        for name, run in routes.items():
            ms[name] += timed_ms(run, n=1)
    (res_t, cost_t), (res_p, cost_p) = out["tracks"], out["pcg"]
    d_pose = float((res_t.pose_r - res_p.pose_r).abs().max())
    d_q = float((res_t.pose_q - res_p.pose_q).abs().max())
    for name, run in routes.items():
        run()
        prof = device_profile(run, top=6)
        step = statistics.median(ms[name]) / CAVE_GN
        log(f"  [{name}] ms per GN step median {step:.3f} ({[round(x / CAVE_GN, 3) for x in ms[name]]}); "
            f"device per GN step {prof['ms'] / CAVE_GN:.3f} ms in {prof['ops'] / CAVE_GN:g} "
            f"operations ({100 * prof['ms'] / CAVE_GN / step:.1f}% of the unprofiled step; busy "
            f"{100 * prof['busy']:.1f}% of the profiled run's wall time); peak memory "
            f"{peak[name]:.3f} GiB above the problem; device ms by operation (whole run) "
            f"{prof['top']}")
    line = (f"  cost {float(cost0):.2f} -> tracks {float(cost_t):.4f}, PCG {float(cost_p):.4f}; poses "
            f"of the two within {d_pose * 1e3:.5f} mm (quaternions {d_q:.3e}); one track solve made "
            f"no host sync; launches {launches}")
    log(line)
    if not (float(cost_t) < float(cost0) and float(cost_p) < float(cost0)
            and d_pose < TRACKS_PCG_TOL_M and not any(launches.values())):
        raise AssertionError("global BA at the Cave shape:" + line)

    K, L, span, block = CAVE_REDUCED
    truth, start, rig64 = cave_problem(K, L, span, torch.float64, "cpu", seed=7)
    tp64, meta, _ = tpar.tracks_from_problem(start, span=span, block=block)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        ref, ref_cost = tpar.ba_solve_tracks(tp64, rig64, meta, iters=CAVE_GN, cg_iters=CAVE_CG)
        t_ref = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    got, cost = tpar.ba_solve_tracks(tree_to(tp64, dev, torch.float32), tree_to(rig64, dev, torch.float32),
                                     meta, iters=CAVE_GN, cg_iters=CAVE_CG)
    err = float((got.pose_r.cpu().double() - ref.pose_r).abs().max())
    c_err = abs(float(cost) - float(ref_cost)) / float(ref_cost)
    line = (f"global BA, tracks at K={K}, L={L} (blocks of {block}): the card's float32 solve within "
            f"{err * 1e3:.5f} mm and cost {c_err:.2e} relative of the float64 CPU solve's "
            f"({float(ref_cost):.4f}, {t_ref:.1f} s on one thread); truth within "
            f"{float((ref.pose_r - truth.pose_r).abs().max()) * 1e3:.3f} mm")
    log(line)
    if not (err < TRACKS_F64_TOL_M and c_err < TRACKS_F64_COST_RTOL):
        raise AssertionError(line)
    return launches


def entry_phase(dev) -> dict:
    """The flagship step (``svin_tpu_torch.entry``: S=8, 512 / 4096 slots,
    256 live landmarks, 5 LM iterations, float32): a finite cost below the
    start's and its median ms over 5 calls (host, synchronized), launch
    counts from 0 just before the first call, read after the last."""
    from svin_tpu_torch.entry import entry
    from svin_tpu_torch.estimator.gauss_newton import total_cost

    step, (window, factors) = entry()
    cfg = WindowConfig(num_states=8, num_landmarks=512, num_obs=4096, max_iterations=5)
    rig = rig_params(problems.euroc_like_rig(device=dev), torch.float32, dev)
    cost0 = total_cost(window, factors, rig, problems.IMU_PARAMS, cfg)
    reset_counts()
    r, cost = step(window, factors)
    ms = timed_ms(lambda: step(window, factors), n=5)
    launches = read_counts()
    line = (f"flagship step (entry(): S=8, 512 / 4096 slots, 5 LM iterations, float32): cost "
            f"{float(cost0):.4f} -> {float(cost):.6f}, median {statistics.median(ms):.3f} ms "
            f"({[round(x, 3) for x in ms]}); launches { {k: v for k, v in launches.items() if v} }")
    log(line)
    if not (torch.isfinite(r).all() and float(cost) < float(cost0)
            and launches["spd_solve_chol"] > 0):
        raise AssertionError(line)
    return launches


# ------------------------------------------------------- the multi-process phase
# Two topologies on the one card: one NCCL rank (NCCL refuses two ranks on one
# GPU), then two gloo ranks sharing it (gloo reduces CUDA tensors through the
# host). Each rank is a worker process of this script (``--mp-worker``).
MP_TOPOLOGIES = (("nccl", 1), ("gloo", 2))
MP_TIMEOUT_S = 420
MP_ROUNDS = 5  # timed runs per solver, sharded and local in turns
# the JAX tests' cooperative mapping (tests/test_runtime.py:203) and its bounds
COOP = dict(K=8, L_window=32, iters=10, cg_iters=32)
COOP_DRIFT_FACTOR, COOP_MIN_PAIRS = 0.3, 8
DRIFT_AFTER_M = 0.15  # the JAX pose-graph tests' bound at the far end (test_dist_posegraph.py:15)


def drifted_graph(dev, N=40, drift_per_step=(0.02, 0.01, 0.0), yaw_drift=0.004):
    """tests/test_loopclosure.py::_make_drifted_graph rebuilt with numpy (a
    circle of radius 3 m, odometry edges from the drifted poses, one exact
    loop edge of weight 5; 64 node and 192 edge slots), float32 on ``dev``:
    (nodes, edges, true positions, N)."""
    from svin_tpu_torch.loopclosure import PoseGraphEdges, PoseGraphNodes
    from svin_tpu_torch.loopclosure.posegraph import ypr_to_matrix_np

    k = np.arange(N)
    t_gt = 3.0 * np.stack([np.cos(2 * np.pi * k / N), np.sin(2 * np.pi * k / N),
                           0.1 * np.sin(4 * np.pi * k / N)], 1)
    yaw_gt = 2 * np.pi * k / N + np.pi / 2
    p_od = t_gt + k[:, None] * np.asarray(drift_per_step)
    yaw_od = yaw_gt + k * yaw_drift
    cap, E = 64, 192

    def rel(i, j, p, yaw):
        return ypr_to_matrix_np(yaw[i], 0.0, 0.0).T @ (p[j] - p[i]), yaw[j] - yaw[i]

    rows = [(i - 1, i, *rel(i - 1, i, p_od, yaw_od), 1.0, False) for i in range(1, N)]
    rows.append((0, N - 1, *rel(0, N - 1, t_gt, yaw_gt), 5.0, True))
    ii, jj, ts, ys, ws, il = (list(x) for x in zip(*rows))
    pad = E - len(rows)
    f32 = dict(dtype=torch.float32, device=dev)
    pz = lambda a, n=cap: np.concatenate([a, np.zeros((n - len(a),) + np.shape(a)[1:])])  # noqa: E731
    nodes = PoseGraphNodes(p=torch.tensor(pz(p_od), **f32), yaw=torch.tensor(pz(yaw_od), **f32),
                           pitch=torch.zeros(cap, **f32), roll=torch.zeros(cap, **f32),
                           valid=torch.arange(cap, device=dev) < N)
    edges = PoseGraphEdges(
        i=torch.tensor(ii + [0] * pad, device=dev), j=torch.tensor(jj + [0] * pad, device=dev),
        t_ij=torch.tensor(pz(np.stack(ts), E), **f32), yaw_ij=torch.tensor(pz(np.array(ys), E), **f32),
        weight=torch.tensor(ws + [1.0] * pad, **f32),
        is_loop=torch.tensor(il + [False] * pad, device=dev),
        valid=torch.arange(E, device=dev) < len(rows))
    return nodes, edges, t_gt, N


class CollectiveCount:
    """Counts ``torch.distributed.all_reduce`` calls inside the block."""

    def __enter__(self):
        import torch.distributed as dist

        self.n, self._dist, self._orig = 0, dist, dist.all_reduce

        def counted(*a, **kw):
            self.n += 1
            return self._orig(*a, **kw)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self._dist.all_reduce = self._orig


def mp_rank(backend: str, rank: int, world: int, rendezvous: str, dev) -> dict:
    """One rank of the multi-process phase on ``dev``: the sharded solvers
    through ``torch.distributed`` (``backend``, ``world`` ranks, a
    ``file://`` rendezvous), each main-path drive with launch counts from 0
    just before and read just after, held to the local solver on the same
    problem; ms per GN step, sharded and local in turns. Raises at a failed
    gate. Returns {"lines", "launches", "ms"}."""
    import torch.distributed as dist

    from svin_tpu_torch import parallel as tpar
    from svin_tpu_torch.apps.run_distributed_mapping import run as coop_run
    from svin_tpu_torch.entry import dryrun_multichip
    from svin_tpu_torch.loopclosure import optimize_4dof

    tpar.initialize_distributed(f"file://{rendezvous}", world, rank, device=dev,
                                backend=None if backend == "nccl" else backend)
    mesh = tpar.make_process_mesh(device=dev)
    mesh.psum(torch.zeros(1, device=dev))  # communicator set-up, outside every window below
    torch.cuda.synchronize()
    tag = f"[{backend}, rank {rank} of {world}]"
    out = {"lines": [], "launches": {k: 0 for k in KERNELS}, "ms": {}}

    def say(line, ok=True):
        out["lines"].append(f"{tag} {line}")
        if not ok:
            raise AssertionError(f"{tag} {line}")

    def drive(fn):
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        got = read_counts()
        for k in KERNELS:
            out["launches"][k] += got[k]
        return res, {k: v for k, v in got.items() if v}

    def in_turns_ms(name, fns: dict, n_gn: int) -> None:
        ms = {k: [] for k in fns}
        for _ in range(MP_ROUNDS):
            for k, fn in fns.items():
                ms[k] += timed_ms(fn, n=1)
        out["ms"][name] = {k: [x / n_gn for x in v] for k, v in ms.items()}
        say(f"{name}: ms per GN step " + ", ".join(
            f"{k} median {statistics.median(v) / n_gn:.3f} ({[round(x / n_gn, 3) for x in v]})"
            for k, v in ms.items()))

    # one all_reduce alone, at the tracks CG matvec's (K, 6) float32 shape
    v = torch.zeros(CAVE[0], 6, device=dev)
    ms, us = device_ms(lambda: mesh.psum(v))
    out["ms"]["all_reduce"] = {"device_ms": ms, "host_us": us}
    say(f"one all_reduce of a ({CAVE[0]}, 6) float32 tensor: device {ms:.5f} ms, host {us:.1f} "
        f"µs per call (200 back to back)")

    # (a) the sharded dense BA at the JAX builder's defaults: the cluster kernel
    K = BA_K[0]
    truth, start, rig = ba_problem(K, dev)
    L = start.lm.shape[0]
    ps, bstart = tpar.partition_problem(start, world), tpar.bucket_problem(start)
    b_step, b_shard = tpar.make_sharded_ba_bucketed(mesh, rig, K, L, iters=BA_ITERS)
    b_local = b_shard(bstart)
    _, cost0 = tpar.make_sharded_ba_bucketed(mesh, rig, K, L, iters=0)[0](b_local)
    f_step, f_shard = tpar.make_sharded_ba(mesh, rig, K, L, ps.obs_uv.shape[0], iters=BA_ITERS)
    f_local = f_shard(ps)
    for name, run, ref in (
            ("make_sharded_ba", lambda: f_step(f_local),
             lambda: tpar.ba_solve_local(ps, rig, iters=BA_ITERS)),
            ("make_sharded_ba_bucketed", lambda: b_step(b_local),
             lambda: tpar.ba_solve_bucketed(bstart, rig, iters=BA_ITERS))):
        with CollectiveCount() as cc:
            (res, cost), got = drive(run)
        want, _ = ref()
        d = float((res.pose_r - want.pose_r).abs().max())
        err = float((res.pose_r - truth.pose_r).abs().max())
        say(f"{name} [K={K}, L={L}, D={6 * K}, {BA_ITERS} GN]: cost {float(cost0):.4f} -> "
            f"{float(cost):.3e}, poses within {d * 1e3:.5f} mm of the local solve on the card and "
            f"{err * 1e3:.4f} mm of the truth; {cc.n} all_reduce; launches {got}",
            float(cost) < float(cost0) and d < BA_KERNEL_TOL_M and err < BA_POSE_TOL_M
            and got.get("spd_solve_cluster") == BA_ITERS)
    in_turns_ms(f"bucketed BA K={K}", {
        "sharded": lambda: b_step(b_local),
        "local": lambda: tpar.ba_solve_bucketed(bstart, rig, iters=BA_ITERS)}, BA_ITERS)

    # (b) the track and PCG solvers at the Cave shape (no kernel)
    Kc, Lc, span, block = CAVE
    _, cstart, crig = cave_problem(Kc, Lc, span, torch.float32, dev)
    tp1, meta1, _ = tpar.tracks_from_problem(cstart, span=span, block=block)
    tpw, metaw, _ = tpar.tracks_from_problem(cstart, span=span, block=block, n_shards=world)
    t_step, t_shard = tpar.make_sharded_ba_tracks(mesh, crig, metaw, iters=CAVE_GN,
                                                  cg_iters=CAVE_CG)
    t_local = t_shard(tpw)
    bp = tpar.bucket_problem(cstart)
    p_step, (p_shard, perm_shard) = tpar.make_sharded_ba_pcg(
        mesh, crig, Kc, Lc, iters=CAVE_GN, cg_iters=CAVE_CG, use_pose_perm=True)
    p_local, p_perm = p_shard(bp), perm_shard(tpar.sharded_pose_major_index(bp, Kc, world))
    perm1 = tpar.pose_major_index(bp.obs_pose, bp.obs_valid, Kc)
    _, c_cost0 = tpar.ba_solve_tracks(tp1, crig, meta1, iters=0)
    for name, run, ref in (
            ("make_sharded_ba_tracks", lambda: t_step(t_local),
             lambda: tpar.ba_solve_tracks(tp1, crig, meta1, iters=CAVE_GN, cg_iters=CAVE_CG)),
            ("make_sharded_ba_pcg (pose-major)", lambda: p_step(p_local, p_perm),
             lambda: tpar.ba_solve_pcg(bp, crig, iters=CAVE_GN, cg_iters=CAVE_CG,
                                       pose_perm=perm1))):
        with CollectiveCount() as cc:
            (res, cost), got = drive(run)
        want, _ = ref()
        d = float((res.pose_r - want.pose_r).abs().max())
        say(f"{name} [Cave: K={Kc}, L={Lc}, {CAVE_GN} GN x {CAVE_CG} CG]: cost "
            f"{float(c_cost0):.2f} -> {float(cost):.4f}, poses within {d * 1e3:.5f} mm of the "
            f"local solve on the card; {cc.n} all_reduce; launches {got}",
            float(cost) < float(c_cost0) and d < TRACKS_PCG_TOL_M and not got)
    if backend == "nccl":
        one_step, _ = tpar.make_sharded_ba_tracks(mesh, crig, metaw, iters=1, cg_iters=CAVE_CG)
        one_step(t_local)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            one_step(t_local)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        say("one sharded tracks GN step under sync-debug \"error\": no host sync")
    in_turns_ms("tracks at the Cave shape", {
        "sharded": lambda: t_step(t_local),
        "local": lambda: tpar.ba_solve_tracks(tp1, crig, meta1, iters=CAVE_GN, cg_iters=CAVE_CG)},
        CAVE_GN)

    # (c) the pose graphs: the JAX tests' drifted graph
    nodes, edges, t_gt, n = drifted_graph(dev)
    edges_p = tpar.pad_edges_for_mesh(edges, world)
    N, E = nodes.p.shape[0], edges_p.i.shape[0]
    for name, step, shard, ref in (
            ("make_sharded_posegraph", *tpar.make_sharded_posegraph(mesh, N, E, iters=10),
             lambda: optimize_4dof(nodes, edges, 1, iters=10)),
            ("make_sharded_posegraph_pcg",
             *tpar.make_sharded_posegraph_pcg(mesh, N, E, iters=10, cg_iters=64),
             lambda: tpar.optimize_4dof_pcg(nodes, edges, 1, iters=10, cg_iters=64))):
        local_edges = shard(edges_p)
        (nd, cost), got = drive(lambda: step(nodes, local_edges, 1))
        d = float((nd.p - ref().p)[:n].abs().max())
        err = float(np.linalg.norm(nd.p[n - 1].cpu().numpy() - t_gt[n - 1]))
        say(f"{name} [N={N}, E={E}, 10 GN]: far end {err:.4f} m from the truth, within "
            f"{d * 1e3:.4f} mm of the local solve; cost {float(cost):.3e}; launches {got}",
            err < DRIFT_AFTER_M and d < SCALABLE_PATH_TOL_M and bool(torch.isfinite(cost)))

    # (d) cooperative mapping (two ranks only): the fused matcher associates
    if world > 1:
        s, got = drive(lambda: coop_run(**COOP, backend=backend, device=dev))
        ok = (s["merged_poses"] == 2 * COOP["K"] and s["shared_pairs"] >= COOP_MIN_PAIRS
              and got.get("hamming_match", 0) > 0)
        if rank == 1:
            ok = ok and s["residual_drift_m"] < COOP_DRIFT_FACTOR * s["injected_drift_m"]
        say(f"cooperative mapping {COOP}: {s}; launches {got}", ok)

    # (e) the dry run
    costs, got = drive(lambda: dryrun_multichip(world, device=dev))
    say(f"dryrun_multichip({world}): {costs}; launches {got}",
        all(np.isfinite(v) for v in costs.values()))
    dist.destroy_process_group()
    return out


def mp_worker(backend: str, rank: str, world: str, rendezvous: str, out_path: str) -> int:
    """``chip_smoke.py --mp-worker``: one rank, its record written to
    ``out_path`` as JSON."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)  # the gloo ranks share the card
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.load()
    res = mp_rank(backend, int(rank), int(world), rendezvous, dev)
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def multiprocess_phase(dev) -> dict:
    """The sharded solvers on ``torch.distributed``, one NCCL rank, then two
    gloo ranks sharing the card, each rank a worker process (``mp_rank``);
    a worker that fails or outlives MP_TIMEOUT_S fails the run. Logs every
    rank's lines; returns the launches summed over the ranks."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world in MP_TOPOLOGIES:
            rdv = os.path.join(tmp, f"rendezvous_{backend}")
            paths = [os.path.join(tmp, f"{backend}_{r}.json") for r in range(world)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker",
                                       backend, str(r), str(world), rdv, paths[r]])
                     for r in range(world)]
            try:
                codes = [p.wait(timeout=max(1.0, MP_TIMEOUT_S - (time.perf_counter() - t0)))
                         for p in procs]
            except subprocess.TimeoutExpired:
                codes = None
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if codes is None or any(codes):
                raise AssertionError(f"multi-process phase [{backend} x {world}]: workers "
                                     f"{'outlived ' + str(MP_TIMEOUT_S) + ' s' if codes is None else 'exited ' + str(codes)}")
            for path in paths:
                with open(path) as f:
                    rec = json.load(f)
                for line in rec["lines"]:
                    log(line)
                for k in KERNELS:
                    launches[k] += rec["launches"][k]
            log(f"multi-process phase [{backend} x {world}]: {time.perf_counter() - t0:.1f} s")
    return launches


C4_STAMP_SIGMA = {0.0: 1e-3, 300.0: 0.05, 600.0: 0.1}  # IMU factor sigmas, by t0
C4_LIFT_M = 0.5


def c4_stamp_probe(dev) -> dict:
    """The frame interval [0.12 + 2/3, 0.12 + 1] s of the revisiting
    sequence's noisy 100 Hz IMU (with the engine's 20 ms overlap),
    preintegrated on the card in float32 with every stamp moved by t0,
    against the float64 CPU preintegral: the whitened IMU factor error
    between two states the float64 one joins exactly."""
    from svin_tpu_torch.imu import preintegration as tp

    params = tp.ImuParameters()
    traj = sim.default_trajectory(scale=0.4, ramp_tau=0.8)
    traj = traj._replace(r_lin=traj.r_lin * 0.0)
    s = sim.simulate_imu(traj, 0.0, 2.0, 100.0, params, rng=np.random.default_rng(1), noisy=True)
    t0f, t1f = 0.12 + 2 / 3, 0.12 + 1.0
    sel = (s.t >= t0f - 0.02) & (s.t <= t1f + 0.02)
    t, gy, ac = s.t[sel].numpy(), s.gyro[sel].numpy(), s.acc[sel].numpy()

    def pre(shift, device, dtype):
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
        p = tp.preintegrate(f(t + shift), f(gy), f(ac), torch.ones(len(t), dtype=torch.bool,
                                                                   device=device),
                            f(t0f + shift), f(t1f + shift), f(np.zeros(6)), params)
        return tp.Preintegral(*(x.detach().cpu().to(torch.float64) for x in p))

    ref = pre(0.0, "cpu", torch.float64)
    kw = dict(dtype=torch.float64)
    T0 = Transformation(r=torch.zeros(3, **kw), q=torch.tensor([0.0, 0.0, 0.0, 1.0], **kw))
    sb0 = torch.tensor([0.5, -0.3, 0.2, 0, 0, 0, 0, 0, 0], **kw)
    T1, sb1 = tp.propagate(T0, sb0, ref, params)
    W = tp.sqrt_information(ref)
    out = {}
    for shift, bound in C4_STAMP_SIGMA.items():
        e, _, _ = tp.error_and_jacobians(T0, sb0, T1, sb1, pre(shift, dev, torch.float32), params)
        sigma = float((W @ e).abs().max())
        if not sigma < bound:
            raise RuntimeError(f"C4 stamp probe at t0 = {shift:g} s: the card's float32 IMU "
                               f"factor is {sigma:.3e} sigma off the float64 one (bound {bound})")
        out[f"t0_{shift:g}s_sigma"] = sigma
    return out


def c4_gauge_window(device, dtype):
    """A window like ``tests/test_torch_cave_parity.py``'s (S=4, depth on
    every state, no sonar factor, poses and landmarks C4_LIFT_M above the
    depth, the gauge prior on slot 0) marginalized at slot 0 on ``device``:
    (window, factors, rig, cfg) after the marginalization."""
    from svin_tpu_torch.estimator import marginalization

    rng = np.random.default_rng(0)
    cfg = WindowConfig(num_states=4, num_landmarks=64, num_obs=512, max_iterations=6)
    w, f, rig_p, truth = problems.build_window_problem(rng, cfg, n_landmarks=48)
    f = problems.attach_depth_and_sonar(f, truth, w, [1, 2], rng)
    f = f._replace(sonar=f.sonar._replace(valid=torch.zeros_like(f.sonar.valid)))
    w = c4_shifted(w, C4_LIFT_M)
    w, f, rig_p = tree_to((w, f, rig_p), device, dtype)
    return (*marginalization.marginalize_slot(w, f, 0, rig_p, problems.IMU_PARAMS, cfg),
            rig_p, cfg)


def c4_shifted(w, dz):
    lift = torch.zeros(3, dtype=w.r.dtype, device=w.r.device)
    lift[2] = dz
    hp = w.hp_W.clone()
    hp[:, :3] += lift * hp[:, 3:4]
    return w._replace(r=w.r + lift, hp_W=hp)


def c4_phase(dev) -> dict:
    """C4 at its shortest showing on the card (phase 11)."""
    from svin_tpu_torch.estimator import total_cost

    out = {"stamp_probe": c4_stamp_probe(dev)}
    w, f, rig_p, cfg = c4_gauge_window(dev, torch.float32)
    wc, fc, _, _ = c4_gauge_window("cpu", torch.float64)
    si = torch.diagonal(f.priors.pose_sqrt_info[0]).cpu().numpy()
    if not np.array_equal(si, [1e7, 1e7, 1e7, 0.0, 0.0, 1e7]):
        raise RuntimeError(f"C4: the card's gauge re-fixation holds {si}, not x, y, z and yaw")
    mean, est = f.priors.pose_mean_r[0].cpu().double(), w.r[0].cpu().double()
    if not (torch.equal(mean, est) and torch.allclose(mean, fc.priors.pose_mean_r[0], atol=1e-5)):
        raise RuntimeError(f"C4: the card's gauge mean {mean.tolist()} is not its estimate "
                           f"{est.tolist()} / the CPU's {fc.priors.pose_mean_r[0].tolist()}")
    cost = lambda ww: float(total_cost(ww, f, rig_p, problems.IMU_PARAMS, cfg))  # noqa: E731
    rise = cost(c4_shifted(w, -C4_LIFT_M)) - cost(w)
    if not rise > 0.9 * 0.5 * 1e14 * C4_LIFT_M ** 2:
        raise RuntimeError(f"C4: moving the window onto its depth costs {rise:.3e} on the card")
    out.update(gauge_height_m=float(mean[2]), depth_offset_m=C4_LIFT_M, cost_rise=rise)
    log(f"C4: the card's float32 IMU factor off the float64 one by {out['stamp_probe']} sigma "
        f"(stamps at 0 / 300 / 600 s); the gauge re-fixation holds the lifted height "
        f"{mean[2]:.4f} m (the CPU's {float(fc.priors.pose_mean_r[0, 2]):.4f}); moving the "
        f"window onto its depth costs {rise:.4e} more")
    return out


C5_BLOCKS = 20000  # rank-2 landmark blocks for the adjugate check
C5_CUT_FRAME, C5_CUT_LANDMARKS = 4, 20
C5_POS_TOL_M = 0.05  # card against CPU, float32, 8 frames (1.90 cm measured on the H100)


def c5_rank2_blocks(n: int = C5_BLOCKS, seed: int = 0) -> np.ndarray:
    """``tests/test_torch_cave_parity.py::rank2_blocks``: J^T J of a 2x3
    Jacobian at 10-1000 px per unit plus 1e-6 I, in float32."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(n, 2, 3)) * rng.uniform(10, 1000, size=(n, 1, 1))
    return (np.einsum("nab,nac->nbc", J, J) + 1e-6 * np.eye(3)).astype(np.float32)


def c5_rig():
    """``tests/torch_parity.py::port_rig``: two 200x150 pinhole cameras,
    20 cm baseline (on the host; the engine moves what it needs)."""
    from svin_tpu_torch.cameras import NCameraSystem
    from svin_tpu_torch.kinematics import from_rq

    cam = _drive_camera("cpu")
    rig = NCameraSystem()
    rig.add_camera(from_rq([0.0, 0.0, 0.0], [0, 0, 0, 1]), cam)
    rig.add_camera(from_rq([0.2, 0.0, 0.0], [0, 0, 0, 1]), cam)
    return rig


def c5_draw(seed, sub, valid, num_hypotheses, sample_size):
    """RANSAC samples drawn on the host from (seed, sub), so that the card's
    engine and the CPU's draw the same ones."""
    from svin_tpu_torch.frontend.ransac import draw_hypotheses

    g = torch.Generator().manual_seed(int(seed) * 4 + (3 if sub is None else int(sub)))
    return draw_hypotheses(valid.cpu(), num_hypotheses, sample_size, g).to(valid.device)


def c5_drive(events, device) -> dict:
    """The port's float32 engine on ``tests/cli_parity.py::gate_sequence``
    (two 200x150 cameras, 150 keypoints, S = 4 + 2, 5 LM iterations,
    ``time_limit`` 0), 20 landmarks cut to one observation after frame 4;
    per frame the gate table's non-finite rows of valid landmarks, the rows
    the refresh declined (program covariance not finite, quality past the
    bound) and the position."""
    from svin_tpu_torch.pipeline import VioConfig

    cfg = VioConfig()
    cfg.num_keyframes, cfg.num_imu_frames, cfg.max_keypoints = 4, 2, 150
    cfg.max_iterations, cfg.time_limit = 5, 0.0
    eng = VioEngine(cfg, rig=c5_rig(), dtype=torch.float32, device=device)
    eng.draw_hypotheses = c5_draw
    out = {"nonfinite": [], "declined": [], "r": []}
    apply = eng._apply_opt_results

    def record(win_h, fac_h, cost_h, iters_h, lm_cov_h, *a, **k):
        bad = ~np.isfinite(np.asarray(lm_cov_h)).all(axis=(1, 2))
        out["declined"][-1] += int((bad & win_h.lm_valid & (win_h.lm_quality > 1e-6)).sum())
        return apply(win_h, fac_h, cost_h, iters_h, lm_cov_h, *a, **k)

    eng._apply_opt_results = record
    for ev in events:
        if ev.kind == "imu":
            eng.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "frame":
            out["declined"].append(0)
            r = eng.add_frame(ev.t, ev.images)
            valid = np.asarray(eng.window.lm_valid, bool)
            out["nonfinite"].append(int((~np.isfinite(eng._lm_cov).all(axis=(1, 2)) & valid).sum()))
            out["r"].append(np.asarray(r.T_WS.r, np.float64))
            if len(out["r"]) == C5_CUT_FRAME:
                f = eng.factors.reproj
                for lm in np.nonzero(valid)[0][:C5_CUT_LANDMARKS]:
                    f.valid[np.nonzero(f.valid & (f.lm_idx == lm))[0][1:]] = False
    return out


def c5_phase(dev) -> dict:
    """C5 at its shortest showing on the card (phase 12)."""
    from svin_tpu_torch.ops.linalg3 import inv3x3
    from svin_tpu_torch.pipeline import VioConfig

    H = c5_rank2_blocks()
    cpu = inv3x3(torch.as_tensor(H)).numpy()
    card = inv3x3(torch.as_tensor(H, device=dev)).cpu().numpy()
    if not ((card == cpu) | (np.isnan(card) & np.isnan(cpu))).all():
        raise RuntimeError("C5: the card's adjugate inverse of rank-2 float32 blocks is not the "
                           "CPU's bit for bit")
    inf_share = float((~np.isfinite(card).all(axis=(1, 2))).mean())
    events, _ = synthetic_sequence(
        c5_rig(), duration=1.3, cam_rate=6.0, imu_rate=100.0, imu_params=VioConfig().imu,
        seed=3, n_points=300, traj=sim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0,
        depth_offset=3.0, t_first_frame=0.12)
    events = list(events)
    runs = {"cpu": c5_drive(events, "cpu"), "card": c5_drive(events, dev)}
    for name, run in runs.items():
        if any(run["nonfinite"]):
            raise RuntimeError(f"C5: non-finite gate rows on the {name} {run['nonfinite']}")
    parts = np.abs(np.stack(runs["card"]["r"]) - np.stack(runs["cpu"]["r"])).max(axis=1)
    part = float(parts.max())
    if not part <= C5_POS_TOL_M:
        raise RuntimeError(f"C5: the card's float32 engine parts from the CPU's by {part:.4e} m")
    out = {"inf_share": inf_share, "frames": len(runs["card"]["r"]), "max_part_m": part,
           "part_per_frame_m": [round(float(x), 6) for x in parts],
           "declined": {k: sum(v["declined"]) for k, v in runs.items()}}
    log(f"C5: the card's adjugate inverse of {C5_BLOCKS} rank-2 float32 blocks is the CPU's bit "
        f"for bit (inf on {inf_share:.4f}); the float32 check sequence, {out['frames']} frames: "
        f"gate tables finite on both, the refresh declined {out['declined']['card']} inf rows on "
        f"the card and {out['declined']['cpu']} on the CPU, positions within {part:.4e} m "
        f"(per frame {out['part_per_frame_m']})")
    return out


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

    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    timings = phase("kernels", kernel_phase, dev)
    loop_timings = phase("loop kernels", loop_kernel_phase, dev)
    launches = phase("backend step", slice_phase, dev)
    engine_launches, inputs = phase("engine", engine_phase, dev)
    large_launches = phase("engine S=22", large_window_phase, dev, inputs[0], inputs[1])
    pipelined_launches = phase("pipelined", pipelined_phase, dev, *inputs)
    loop_launches, closer_launches = phase("loop closure", loop_phase, dev)
    drive_launches = phase("closer past 512", scalable_phase, dev)
    ba_launches = phase("global BA", global_ba_phase, dev)
    cave_launches = phase("global BA, Cave shape", cave_ba_phase, dev)
    entry_launches = phase("flagship step", entry_phase, dev)
    mp_launches = phase("multi-process", multiprocess_phase, dev)
    phase("C4", c4_phase, dev)
    phase("C5", c5_phase, dev)
    log(f"wall seconds per phase: {phase_s}; within them: {SUBPHASE_S}")
    launches = {k: launches[k] + engine_launches[k] + large_launches[k] + pipelined_launches[k]
                + loop_launches[k] + drive_launches[k] + ba_launches[k] + cave_launches[k]
                + entry_launches[k] + mp_launches[k] for k in KERNELS}
    closer_launches = {k: closer_launches[k] + drive_launches[k] for k in KERNELS}
    log(f"launches summed over the backend-step, engine (S=8 and S=22), pipelined, "
        f"loop-closure, closer past 512, global BA (K <= 170 and the Cave shape) and "
        f"flagship-step and multi-process paths: {launches} (S=22 engine: {large_launches}; "
        f"multi-process, every rank: {mp_launches}; loop-closure phase, "
        f"the apps' engine included: {loop_launches}; the loop closer alone, the "
        f"{DRIVE[0]}-keyframe drive included: {closer_launches}; global BA: {ba_launches}; "
        f"flagship step: {entry_launches})")

    ret, ver = loop_timings["retrieval"], loop_timings["verification"]
    near = loop_timings["nearest"]
    record = {"kernels": [
        {"name": "spd_solve_chol", "route": "cuda", "source": "svin_tpu_torch/csrc/spd_solve_chol.cu",
         "replaces": "svin_tpu/ops/solve.py:59", "launches": launches["spd_solve_chol"],
         "shape": f"D={SOLVE_D}", **timings["spd_solve_chol"]},
        {"name": "spd_solve_cluster", "route": "cuda",
         "source": "svin_tpu_torch/csrc/spd_solve_cluster.cu",
         "replaces": "svin_tpu/ops/solve.py:59", "launches": launches["spd_solve_cluster"],
         "ba_launches": ba_launches["spd_solve_cluster"],
         "mp_launches": mp_launches["spd_solve_cluster"],
         "shape": f"D={LARGE_DS[0]}", **timings["spd_solve_cluster"]},
        {"name": "hamming_match", "route": "cuda", "source": "svin_tpu_torch/csrc/hamming_match.cu",
         "replaces": "svin_tpu/ops/hamming.py:44", "launches": launches["hamming_match"],
         "loop_launches": closer_launches["hamming_match"],
         "mp_launches": mp_launches["hamming_match"],
         "shape": f"(2,{K},8)x(512,8), mask (2,{K},512)", **timings["hamming_match"],
         **{f"verification_{k}": v for k, v in ver.items() if k != "max_abs_err"}},
        {"name": "hamming_matrix", "route": "cuda", "source": "svin_tpu_torch/csrc/hamming.cu",
         "replaces": "svin_tpu/ops/hamming.py:44", "launches": launches["hamming_matrix"],
         "loop_launches": closer_launches["hamming_matrix"],
         "shape": f"(2,{RETRIEVAL_K},4)x(2,256,4)", **ret,
         **{f"map_{k}": v for k, v in timings["hamming_matrix"].items() if k != "max_abs_err"}},
        {"name": "hamming_nearest", "route": "cuda", "source": "svin_tpu_torch/csrc/hamming_nearest.cu",
         "replaces": "svin_tpu/ops/hamming.py:44", "launches": launches["hamming_nearest"],
         "loop_launches": closer_launches["hamming_nearest"],
         "shape": f"(2,{RETRIEVAL_K},4)x(2,256,4)", **near["retrieval"],
         **{f"train_{k}": v for k, v in near["train_vocabulary"].items() if k != "max_abs_err"}},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(*sys.argv[2:]))
    sys.exit(main())
