"""The port's CUDA kernels on the card, held to their plain PyTorch versions.

Every test carries the ``cuda`` marker and skips without a CUDA device (the
kernels have no CPU mode). This file imports no JAX, so it runs on a machine
with the card and without JAX; there, skip the JAX-importing conftest and
the xdist options of pytest.ini:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: B2's distance matrix, the fused matcher and the nearest
codeword are integer-exact (bit for bit against their plain versions, ties
included). B1 (the float32 blocked-Cholesky kernels, one block up to D = 320
and one thread-block cluster up to 1024, vs float32 ``cholesky_ex`` +
``cholesky_solve``) on Jacobi-equilibrated SPD systems: relative residual ≤
1e-4 and relative distance to the plain solution ≤ 1e-3; a system that does
not factor gives all NaN in both; float64 and D > 1024 take the library
route and equal the plain solve. The fused matcher is one kernel launch
and no memset per call (from a ``torch.profiler`` trace), neither cluster
kernel's wrapper synchronises with the host, and the card holds at least
one cluster of each solve plan the paths use. One pipelined ``backend_step`` makes at
most 4 host synchronisations (its fetch and the marginalization's three
``eigh``). The backend step with kernels vs with plain versions:
identical matches (the matcher is exact), cost within 1% and positions
within 1 mm (the two solvers round differently and the LM loop carries that
forward). The
engine's serial path at the CPU tests' size: the CPU tests' tracking and
5 cm ATE bounds, with the kernels and with the plain versions. The loop
closer's shapes: the distance matrix at the word assignment (2, 1012, 4) x
(2, 256, 4) with a per-batch b and the fused matcher at verification
(512, 8) x (500, 8), both bit for bit with planted ties; the dense
pose-graph solve (4-DoF and 6-DoF) makes no host synchronisation and lands
within 1 mm of the float64 CPU solve. The track-structured global BA makes
no host synchronisation and lands within 2e-4 m of the float64 CPU solve.
The sharded bucketed BA at K = 64 (D = 384): on one NCCL rank in this
process and on two gloo ranks sharing the card (worker processes,
``torch_dist_worker.py``), the cluster kernel once per GN step and the
poses within 1e-4 m of the local solve on the card (float32 solves summed
in another order, carried through 10 GN steps). The five float32
regressions of ``tests/test_f32_numerics.py`` hold on the card with the JAX
tests' bounds (``test_torch_f32_numerics.py``'s checks).
"""
import numpy as np
import pytest
import torch

from svin_tpu_torch import problems
from svin_tpu_torch.convert import tree_to
from svin_tpu_torch.estimator import WindowConfig, optimize
from svin_tpu_torch.ops import hamming as tham
from svin_tpu_torch.ops import solve as tsolve
from svin_tpu_torch.pipeline import BackendStep
import test_torch_f32_numerics as f32_checks

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _desc(rng, shape):
    return torch.as_tensor(
        rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("na,nb", [(1, 1), (129, 257), (400, 1), (400, 512)])
def test_hamming_kernel_matches_plain(dev, na, nb):
    rng = np.random.default_rng(na)
    a, b = _desc(rng, (2, na, 8)).to(dev), _desc(rng, (nb, 8)).to(dev)
    n0 = tham.hamming_matrix_cuda.launches
    got = tham.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert tham.hamming_matrix_cuda.launches == n0 + 1
    assert torch.equal(got, tham.hamming_matrix_plain(a, b))
    b2 = _desc(rng, (2, nb, 8)).to(dev)  # a batch of distinct b
    assert torch.equal(tham.hamming_matrix(a, b2), tham.hamming_matrix_plain(a, b2))


def _equilibrated_spd(rng, D, batch=()):
    A = rng.standard_normal(batch + (D, D))
    H = A @ np.swapaxes(A, -1, -2) + D * np.eye(D)
    b = rng.standard_normal(batch + (D,))
    s = 1.0 / np.sqrt(np.diagonal(H, axis1=-2, axis2=-1))
    return H * s[..., :, None] * s[..., None, :], b * s


@pytest.mark.parametrize("D", [7, 120, 132])
def test_solve_kernel_matches_plain(dev, D):
    rng = np.random.default_rng(D)
    H, b = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in _equilibrated_spd(rng, D))
    n0 = tsolve.spd_solve_chol.launches
    x = tsolve.solve_spd(H, b)
    torch.cuda.synchronize()
    assert tsolve.spd_solve_chol.launches == n0 + 1
    ref = tsolve.solve_spd_plain(H, b)
    assert float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b)) <= 1e-4
    assert float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)) <= 1e-3


def test_solve_kernel_batched_and_refusals(dev):
    rng = np.random.default_rng(1)
    H, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in _equilibrated_spd(rng, 40, batch=(3,)))
    H[1] = -H[1]  # not positive definite: that system's x is all NaN, the others solve
    x = tsolve.spd_solve_chol(H, b)
    ref = tsolve.solve_spd_plain(H, b)
    assert bool(torch.isnan(x[1]).all()) and bool(torch.isnan(ref[1]).all())
    keep = [0, 2]
    assert not bool(torch.isnan(x[keep]).any())
    assert float((x[keep] - ref[keep]).abs().max() / ref[keep].abs().max()) <= 1e-3
    # D = 250: more trailing rows than one sweep carries, and more than 48 KB
    # of shared memory (the opt-in)
    H, b = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in _equilibrated_spd(rng, 250))
    x, ref = tsolve.spd_solve_chol(H, b), tsolve.solve_spd_plain(H, b)
    assert float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b)) <= 1e-4
    assert float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)) <= 1e-3
    with pytest.raises(TypeError):
        tsolve.spd_solve_chol(H.double(), b.double())  # the kernel is float32 only
    # D = 320 is the largest that one block's shared memory holds, and
    # solve_spd sends it to the one-block kernel
    assert tsolve.spd_solve_chol_max_d(dev) == 320
    H, b = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in _equilibrated_spd(rng, 320))
    n0 = tsolve.spd_solve_chol.launches
    x = tsolve.solve_spd(H, b)
    assert tsolve.spd_solve_chol.launches == n0 + 1
    assert float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b)) <= 1e-4
    with pytest.raises(TypeError):
        tham.hamming_matrix(torch.zeros((4, 8), device=dev), torch.zeros((4, 8), device=dev))


@pytest.mark.parametrize("D", [321, 330, 352, 384, 512, 768, 1020, 1024])
def test_cluster_solve_matches_plain(dev, D):
    """Past one block's shared memory (D > 320) up to the reference kernel's
    1024, solve_spd runs the cluster kernel (8 CTAs to D = 864, 16 past it;
    1020 ends in a partial block row)."""
    rng = np.random.default_rng(D)
    H, b = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in _equilibrated_spd(rng, D))
    counts = (tsolve.spd_solve_chol.launches, tsolve.spd_solve_cluster.launches,
              tsolve.solve_spd_library.launches)
    x = tsolve.solve_spd(H, b)
    torch.cuda.synchronize()
    assert (tsolve.spd_solve_chol.launches, tsolve.spd_solve_cluster.launches,
            tsolve.solve_spd_library.launches) == (counts[0], counts[1] + 1, counts[2])
    ref = tsolve.solve_spd_plain(H, b)
    assert float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b)) <= 1e-4
    assert float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)) <= 1e-3


def test_cluster_solve_batched_small_and_not_positive_definite(dev):
    """A batch of clusters with one non-SPD system (all NaN, the others
    solve), and sizes off the path (one panel, a ragged one)."""
    rng = np.random.default_rng(2)
    H, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in _equilibrated_spd(rng, 400, batch=(3,)))
    H[1] = -H[1]
    x, ref = tsolve.spd_solve_cluster(H, b), tsolve.solve_spd_plain(H, b)
    assert bool(torch.isnan(x[1]).all()) and bool(torch.isnan(ref[1]).all())
    keep = [0, 2]
    assert not bool(torch.isnan(x[keep]).any())
    assert float((x[keep] - ref[keep]).abs().max() / ref[keep].abs().max()) <= 1e-3
    for D in (1, 32, 45):
        H, b = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in _equilibrated_spd(rng, D))
        x = tsolve.spd_solve_cluster(H, b)
        assert float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b)) <= 1e-4


def test_solve_float64_and_past_1024_take_the_library_route(dev):
    """float64 keeps Cholesky for its precision, and D > 1024 is past the
    kernels, as in the reference: both go to the library route."""
    rng = np.random.default_rng(3)
    for D, dtype in ((330, torch.float64), (60, torch.float64), (1100, torch.float32)):
        H, b = (torch.as_tensor(x, dtype=dtype, device=dev) for x in _equilibrated_spd(rng, D))
        counts = (tsolve.spd_solve_chol.launches, tsolve.spd_solve_cluster.launches,
                  tsolve.solve_spd_library.launches)
        x = tsolve.solve_spd(H, b)
        assert (tsolve.spd_solve_chol.launches, tsolve.spd_solve_cluster.launches,
                tsolve.solve_spd_library.launches) == (counts[0], counts[1], counts[2] + 1)
        assert x.dtype == dtype and torch.equal(x, tsolve.solve_spd_plain(H, b))


@pytest.mark.parametrize("shape", ["retrieval", "train_vocabulary", "ragged"])
def test_nearest_codeword_matches_plain(dev, shape):
    """The nearest-codeword kernel bit for bit against its plain version with
    planted ties: the product vocabulary's word assignment (both halves, a
    per-batch codebook), train_vocabulary's (32768, 8) x (1024, 8) (a shared
    codebook, more than one shared-memory tile), and odd widths and sizes."""
    rng = np.random.default_rng(len(shape))
    if shape == "retrieval":
        desc, vocab = _desc(rng, (2, 1012, 4)), _desc(rng, (2, 256, 4))
    elif shape == "train_vocabulary":
        desc, vocab = _desc(rng, (32768, 8)), _desc(rng, (1024, 8))
    else:
        desc, vocab = _desc(rng, (3, 37, 5)), _desc(rng, (3000, 5))
    n = min(50, vocab.shape[-2] // 4, desc.shape[-2])
    vocab[..., -n:, :] = vocab[..., :n, :]  # equal codewords
    desc[..., :n, :] = vocab[..., :n, :]  # hits on them
    desc, vocab = desc.to(dev), vocab.to(dev)
    n0 = tham.nearest_codeword_cuda.launches
    got = tham.nearest_codeword(desc, vocab)
    torch.cuda.synchronize()
    assert tham.nearest_codeword_cuda.launches == n0 + 1
    want = tham.nearest_codeword_plain(desc, vocab)
    assert got.dtype == want.dtype == torch.int64 and torch.equal(got, want)
    assert bool((got[..., :n] == torch.arange(n, device=dev)).all())


@pytest.mark.parametrize("kind", list(problems.MATCHER_SHAPES))
def test_fused_matcher_matches_plain(dev, kind):
    rng = np.random.default_rng(len(kind))
    args = problems.matcher_inputs(kind, rng, dev)
    for ratio, mutual in ((0.0, True), (0.8, True), (0.0, False), (0.8, False)):
        n0 = tham.match_descriptors_cuda.launches
        got = tham.match_descriptors(*args, max_distance=60, ratio=ratio, mutual=mutual)
        torch.cuda.synchronize()
        assert tham.match_descriptors_cuda.launches == n0 + 1
        want = tham.match_descriptors_plain(*args, max_distance=60, ratio=ratio, mutual=mutual)
        assert bool(want.valid.any())
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (kind, ratio, mutual)


@pytest.mark.parametrize("nb", [1, 12, 700, tham.MATCH_MAX_NB])
def test_fused_matcher_ragged_and_batched_b(dev, nb):
    """Shapes off the main path: a one-column table, tables wider than one
    column chunk (256), the largest table the cluster's column minima hold,
    and a batch of distinct tables and valid flags."""
    rng = np.random.default_rng(nb)
    a, b, va, vb, mask = (torch.as_tensor(x, device=dev)
                          for x in problems.matcher_case(rng, cams=2, na=37, nb=max(nb, 12)))
    b, vb, mask = b[:nb].contiguous(), vb[:nb].contiguous(), mask[..., :nb].contiguous()
    b2 = torch.stack([b, b.flip(0)]).contiguous()
    vb2 = torch.stack([vb, ~vb]).contiguous()
    for args in ((a, b, va, vb, mask), (a, b2, va, vb2, None)):
        for ratio in (0.0, 0.8):
            got = tham.match_descriptors_cuda(*args, ratio=ratio)
            want = tham.match_descriptors_plain(*args, ratio=ratio)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (nb, ratio)


@pytest.mark.parametrize("na,nb", [(513, 300), (1100, 300), (4000, 700)])
def test_fused_matcher_past_one_pass_per_cta(dev, na, nb):
    """More rows than a cluster takes in one 32-row pass per CTA (Na > 512):
    each CTA keeps its rows' results in device memory across passes and
    reads them back for the mutual check."""
    rng = np.random.default_rng(na)
    args = tuple(torch.as_tensor(x, device=dev) for x in problems.matcher_case(rng, cams=2, na=na, nb=nb))
    assert tham.match_plan(na, nb, 8).rows_per_cta > 32
    for mask in (args[4], None):
        for ratio in (0.0, 0.8):
            for mutual in (True, False):
                got = tham.match_descriptors_cuda(*args[:4], mask, ratio=ratio, mutual=mutual)
                want = tham.match_descriptors_plain(*args[:4], mask, ratio=ratio, mutual=mutual)
                assert bool(want.valid.any())
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (na, ratio, mutual, mask is None)


def test_cluster_plans_schedule_on_the_card(dev):
    """The card holds at least one cluster of each plan the paths use (8
    CTAs at D = 330 and 768, 16 at D = 1024): cudaOccupancyMaxActiveClusters."""
    for D, size in ((330, 8), (768, 8), (1024, 16)):
        assert tsolve.cluster_plan(D).cluster == size
        assert tsolve.cluster_max_active(D, dev) >= 1, D


def _card_ops(fn, tries=3):
    """The device operations of one call of ``fn`` from a torch.profiler
    trace (a trace can miss device events: retried while it shows none)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            return ops
    return []


def test_fused_matcher_is_one_kernel_and_no_memset(dev):
    args = problems.matcher_inputs("map", np.random.default_rng(4), dev)
    tham.match_descriptors_cuda(*args)
    torch.cuda.synchronize()
    ops = _card_ops(lambda: tham.match_descriptors_cuda(*args))
    names = [e.name for e in ops]
    assert len(ops) == 1 and "match_kernel" in names[0], names
    assert not any("emset" in n for n in names)


def test_cluster_kernels_never_wait_on_the_host(dev):
    """Neither wrapper synchronises with the host (sync debug mode "error")."""
    rng = np.random.default_rng(6)
    args = problems.matcher_inputs("map", rng, dev)
    H, b = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in _equilibrated_spd(rng, 1024))
    tham.match_descriptors_cuda(*args)
    tsolve.spd_solve_cluster(H, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tham.match_descriptors_cuda(*args)
        tsolve.solve_spd(H, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _small_case(dev):
    cfg = WindowConfig(num_states=5, num_landmarks=96, num_obs=768, max_iterations=5)
    rng = np.random.default_rng(3)
    w, f, rig, truth = problems.build_window_problem(rng, cfg, n_landmarks=80)
    f = problems.attach_depth_and_sonar(f, truth, w, [1, 3], rng)
    lm_desc = problems.random_descriptors(rng, cfg.num_landmarks)
    frame, _ = problems.make_frame(rng, w, truth, rig, lm_desc, slot=cfg.num_states - 1, K=120)
    return (cfg, *(tree_to(t, dev, torch.float32) for t in (w, f, rig, frame)))


def test_backend_step_kernels_match_plain(dev):
    cfg, w, f, rig, frame = _small_case(dev)
    n_solve, n_match = tsolve.spd_solve_chol.launches, tham.match_descriptors_cuda.launches
    kern = BackendStep(rig, problems.IMU_PARAMS, cfg).to(dev)(w, f, frame, cfg.max_iterations, 0)
    torch.cuda.synchronize()
    assert tsolve.spd_solve_chol.launches == n_solve + cfg.max_iterations
    assert tham.match_descriptors_cuda.launches == n_match + 1
    plain = BackendStep(rig, problems.IMU_PARAMS, cfg, solve=tsolve.solve_spd_plain,
                        matcher=tham.match_descriptors_plain).to(dev)(w, f, frame, cfg.max_iterations, 0)
    assert torch.equal(kern.match_idx, plain.match_idx)
    assert float(kern.cost) < float(kern.cost0)
    assert abs(float(kern.cost) - float(plain.cost)) <= 1e-2 * float(plain.cost)
    assert float((kern.window.r - plain.window.r).abs().max()) < 1e-3


def test_lm_loop_never_waits_on_the_host(dev):
    """The LM loop (with the B1 kernel) makes no host synchronisation: it
    runs under the sync debug mode that raises on one."""
    cfg, w, f, rig, _ = _small_case(dev)
    imu = BackendStep(rig, problems.IMU_PARAMS, cfg).to(dev).imu_p
    optimize(w, f, rig, imu, cfg)  # builds and loads the kernel library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = optimize(w, f, rig, imu, cfg, n_iters=cfg.max_iterations)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(res.cost) < float(res.cost0)


def _small_setup(dev):
    """(config, rig, events, renderer) at the CPU tests' size: two 200x150
    cameras, 300 blobs, 6 Hz for 2.6 s (the port's own sequence)."""
    from svin_tpu_torch import sim
    from svin_tpu_torch.cameras import NCameraSystem, make_camera
    from svin_tpu_torch.kinematics import from_rq
    from svin_tpu_torch.pipeline import VioConfig, synthetic_sequence

    cam = make_camera(200, 150, 160.0, 160.0, 100.0, 75.0, model="none", device=dev)
    rig = NCameraSystem()
    rig.add_camera(from_rq([0.0, 0.0, 0.0], [0, 0, 0, 1], device=dev), cam)
    rig.add_camera(from_rq([0.2, 0.0, 0.0], [0, 0, 0, 1], device=dev), cam)
    cfg = VioConfig(num_keyframes=4, num_imu_frames=2, max_keypoints=150, max_iterations=5)
    events, renderer = synthetic_sequence(
        rig, duration=2.6, cam_rate=6.0, imu_rate=100.0, imu_params=cfg.imu, seed=3,
        n_points=300, traj=sim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0,
        depth_offset=3.0, t_first_frame=0.12)
    return cfg, rig, events, renderer


def _small_engine_run(dev, **kernels):
    """The engine's serial path on the card at the CPU tests' size."""
    from svin_tpu_torch.evaluation import ate_rmse
    from svin_tpu_torch.pipeline import VioEngine, run_events

    cfg, rig, events, renderer = _small_setup(dev)
    engine = VioEngine(cfg, rig=rig, device=dev, **kernels)
    results = run_events(engine, events)
    est = np.stack([r.T_WS.r for r in results])
    gt = np.stack([renderer.pose(r.timestamp).r.numpy() for r in results])
    return engine, results, ate_rmse(est, gt, with_scale=False)[0]


def test_engine_runs_on_the_card_with_kernels_and_plain(dev):
    """float32 on the card: the serial ``add_frame`` path tracks, stays
    within the CPU tests' ATE bound (5 cm) and launches both kernels (B1 and
    the fused matcher); with the plain versions it launches none and meets
    the same bound."""
    n_solve, n_match = tsolve.spd_solve_chol.launches, tham.match_descriptors_cuda.launches
    engine, results, ate = _small_engine_run(dev)
    assert len(results) >= 10 and np.median([r.num_tracked for r in results[1:]]) >= 20
    assert ate < 0.05, ate
    assert tsolve.spd_solve_chol.launches > n_solve and tham.match_descriptors_cuda.launches > n_match
    assert np.isfinite(engine._lm_cov).all()
    n_solve, n_match = tsolve.spd_solve_chol.launches, tham.match_descriptors_cuda.launches
    _, _, ate_plain = _small_engine_run(dev, solve=tsolve.solve_spd_plain,
                                        matcher=tham.match_descriptors_plain)
    assert ate_plain < 0.05, ate_plain
    assert (tsolve.spd_solve_chol.launches, tham.match_descriptors_cuda.launches) == (n_solve, n_match)


def test_backend_step_syncs_only_to_fetch(dev):
    """One pipelined ``backend_step`` (the window full and marginalizing)
    under ``set_sync_debug_mode("warn")``: at most 4 host synchronisations,
    its one fetch and the marginalization's three ``eigh``; uploads are
    pinned and non-blocking, and no Python value is written into a device
    tensor."""
    import warnings

    from svin_tpu_torch.pipeline import VioEngine

    cfg, rig, events, _ = _small_setup(dev)
    engine = VioEngine(cfg, rig=rig, device=dev)
    n_frame, counted = 0, None
    for ev in events:
        if ev.kind == "imu":
            engine.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "depth":
            engine.add_depth_measurement(ev.t, ev.depth)
        elif ev.kind == "sonar":
            engine.add_sonar_measurement(ev.t, *ev.sonar)
        elif engine.n_states == 0:
            engine.add_frame(ev.t, ev.images)
        else:
            t_s, fd = engine.frontend_stage(ev.t, ev.images)
            n_frame += 1
            if n_frame != 10:
                engine.backend_step(t_s, ev.images, fd)
                continue
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    engine.backend_step(t_s, ev.images, fd)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            counted = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
            assert engine._pending.victim is not None  # the solve queued marginalizes
            break
    assert counted is not None and 1 <= len(counted) <= 4, counted


def test_upload_on_the_card_equals_the_host_conversion(dev):
    """``convert.array_to_tensor`` through pinned memory and a non-blocking
    copy: the same tensors as the host conversion, for the engine's dtypes."""
    from svin_tpu_torch.convert import array_to_tensor

    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((40, 3)), rng.standard_normal(7).astype(np.float32),
              np.float64(0.25), np.arange(12, dtype=np.int64), rng.random(10) < 0.5,
              rng.integers(0, 2**32, size=(6, 8), dtype=np.uint64).astype(np.uint32),
              np.arange(255, dtype=np.uint8)]
    for dtype in (torch.float32, torch.float64):
        got = [array_to_tensor(a, dev, dtype) for a in arrays]
        torch.cuda.synchronize()
        for a, g in zip(arrays, got):
            want = array_to_tensor(a, "cpu", dtype)
            assert g.is_cuda and g.dtype == want.dtype and torch.equal(g.cpu(), want)


def test_hamming_kernel_at_the_retrieval_shape(dev):
    """The product vocabulary's word assignment: both 128-bit halves of a
    keyframe's 1012 descriptors (512 window + 500 fresh corners) against
    their own 256-word codebooks, one launch with a batch of two and a
    per-batch b; rows of b repeated so that argmin meets ties."""
    from svin_tpu_torch.loopclosure import retrieval

    rng = np.random.default_rng(7)
    desc = _desc(rng, (1012, 8)).to(dev)
    vocab = _desc(rng, (2, 256, 4)).to(dev)
    vocab[:, 200:] = vocab[:, 100:156]  # planted ties: equal codewords
    desc[:56] = torch.cat([vocab[0, 100:156], vocab[1, 100:156]], dim=1)  # exact hits on them
    a = torch.stack([desc[:, :4], desc[:, 4:]])
    n0 = tham.hamming_matrix_cuda.launches
    got = tham.hamming_matrix(a, vocab)
    torch.cuda.synchronize()
    assert tham.hamming_matrix_cuda.launches == n0 + 1
    want = tham.hamming_matrix_plain(a, vocab)
    assert torch.equal(got, want)
    w = torch.argmin(got, dim=-1)
    assert torch.equal(w, torch.argmin(want, dim=-1)) and bool((w[:, :56] < 200).all())
    words = retrieval.product_words(desc, vocab[0], vocab[1])
    assert torch.equal(words.cpu(), retrieval.product_words(desc.cpu(), vocab[0].cpu(),
                                                            vocab[1].cpu()))


def test_fused_matcher_at_the_verification_shape(dev):
    """Loop verification: the current keyframe's 512 window descriptors
    against the candidate's 500 corners, valid masks, no gate, distance 80,
    mutual; planted ties (repeated corners)."""
    rng = np.random.default_rng(8)
    a, b = _desc(rng, (512, 8)), _desc(rng, (500, 8))
    a[:200] = b[:200] ^ torch.as_tensor(rng.integers(0, 2, (200, 8)), dtype=torch.int32)  # near
    b[400:450] = b[:50]  # ties
    va = torch.as_tensor(np.arange(512) < 470)
    vb = torch.as_tensor(rng.random(500) < 0.95)
    args = tuple(x.to(dev) for x in (a, b, va, vb))
    n0 = tham.match_descriptors_cuda.launches
    got = tham.match_descriptors(*args, max_distance=80, mutual=True)
    torch.cuda.synchronize()
    assert tham.match_descriptors_cuda.launches == n0 + 1
    want = tham.match_descriptors_plain(*args, max_distance=80, mutual=True)
    assert int(want.valid.sum()) >= 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("mode", ["4dof", "6dof"])
def test_pose_graph_solve_never_waits_on_the_host(dev, mode):
    """The loop closer's dense pose-graph GN runs on the card without a host
    synchronisation (float32, the closer's precision there) and agrees with
    the same solve in float64 on the CPU."""
    from svin_tpu_torch.kinematics import quaternion as tquat
    from svin_tpu_torch.loopclosure import posegraph as tpg

    rng = np.random.default_rng(9)
    N, E = 64, 160
    p = np.cumsum(rng.normal(size=(N, 3)) * 0.3, axis=0)
    yaw = np.cumsum(rng.normal(size=N) * 0.1)
    i = np.r_[np.arange(N - 1), rng.integers(0, N // 2, E - N + 1)].astype(np.int32)
    j = np.r_[np.arange(1, N), rng.integers(N // 2, N, E - N + 1)].astype(np.int32)
    R = tpg.ypr_to_matrix_np(yaw[i], 0 * yaw[i], 0 * yaw[i]).transpose(2, 0, 1)
    t_ij = np.einsum("eba,eb->ea", R, p[j] - p[i]) + rng.normal(size=(E, 3)) * 0.05
    yaw_ij = yaw[j] - yaw[i] + rng.normal(size=E) * 0.01
    is_loop = np.arange(E) >= N - 1
    if mode == "4dof":
        nodes = tpg.PoseGraphNodes(p=p + rng.normal(size=p.shape) * 0.2, yaw=yaw, pitch=0 * yaw,
                                   roll=0 * yaw, valid=np.ones(N, bool))
        edges = tpg.PoseGraphEdges(i=i, j=j, t_ij=t_ij, yaw_ij=yaw_ij, weight=np.ones(E),
                                   is_loop=is_loop, valid=np.ones(E, bool))
        solve, iters = tpg.optimize_4dof, 30
    else:
        q = tquat.from_rotation_matrix(tpg.ypr_to_matrix(torch.as_tensor(yaw), 0.0, 0.0)).numpy()
        q_ij = tquat.from_rotation_matrix(tpg.ypr_to_matrix(torch.as_tensor(yaw_ij), 0.0, 0.0)).numpy()
        nodes = tpg.PoseGraph6Nodes(r=p + rng.normal(size=p.shape) * 0.2, q=q, valid=np.ones(N, bool))
        W = np.tile(np.diag([20.0, 20, 20, 100, 100, 57.3]), (E, 1, 1))
        edges = tpg.PoseGraph6Edges(i=i, j=j, t_ij=t_ij, q_ij=q_ij, sqrt_info=W,
                                    valid=np.ones(E, bool), is_loop=is_loop)
        solve, iters = tpg.optimize_6dof, 10
    on = lambda t, d, dt: type(t)(*(None if x is None else torch.as_tensor(  # noqa: E731
        x, device=d, dtype=dt if np.asarray(x).dtype.kind == "f" else None) for x in t))
    ref = solve(on(nodes, "cpu", torch.float64), on(edges, "cpu", torch.float64), 1, iters=iters)
    nd, ed = on(nodes, dev, torch.float32), on(edges, dev, torch.float32)
    solve(nd, ed, 1, iters=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = solve(nd, ed, 1, iters=iters)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = (out.p if mode == "4dof" else out.r).cpu().double()
    want = ref.p if mode == "4dof" else ref.r
    assert float((got - want).abs().max()) < 1e-3


def _circle_graph(mode, N, seed=7):
    """A circle of radius 20 m lapped twice whose initial guess drifts (yaw;
    and roll and pitch in 6-DoF), exact odometry edges and loop edges from the
    second lap to the first every 16 nodes, as numpy port tables."""
    from svin_tpu_torch.kinematics import npq
    from svin_tpu_torch.loopclosure import posegraph as tpg

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 4 * np.pi, N)
    p_gt = np.stack([20.0 * np.cos(th), 20.0 * np.sin(th), 0.1 * np.sin(3 * th)], 1)
    yaw_gt = th + np.pi / 2
    drift = np.cumsum(rng.normal(0, 2e-3, (N, 3)), axis=0) * ([1.0, 0.4, 0.4] if mode == "6dof"
                                                               else [1.0, 0.0, 0.0])
    R_gt = [tpg.ypr_to_matrix_np(y, 0, 0) for y in yaw_gt]
    R0 = [tpg.ypr_to_matrix_np(yaw_gt[k] + drift[k, 0], drift[k, 1], drift[k, 2]) for k in range(N)]
    p0 = np.cumsum([p_gt[0]] + [R0[k - 1] @ R_gt[k - 1].T @ (p_gt[k] - p_gt[k - 1])
                                for k in range(1, N)], axis=0)
    pairs = [(k - 1, k) for k in range(1, N)] + [(k - N // 2, k) for k in range(N // 2 + 4, N, 16)]
    i, j = (np.array(x, np.int64) for x in zip(*pairs))
    t_ij = np.stack([R_gt[a].T @ (p_gt[b] - p_gt[a]) for a, b in pairs])
    E, ones = len(pairs), np.ones(len(pairs), bool)
    if mode == "4dof":
        nodes = tpg.PoseGraphNodes(p=p0, yaw=yaw_gt + drift[:, 0], pitch=np.zeros(N),
                                   roll=np.zeros(N), valid=np.ones(N, bool))
        edges = tpg.PoseGraphEdges(i=i, j=j, t_ij=t_ij, yaw_ij=yaw_gt[j] - yaw_gt[i],
                                   weight=np.ones(E), is_loop=i < j - 1, valid=ones)
    else:
        nodes = tpg.PoseGraph6Nodes(r=p0, q=np.stack([npq.from_rotation_matrix(R) for R in R0]),
                                    valid=np.ones(N, bool))
        edges = tpg.PoseGraph6Edges(
            i=i, j=j, t_ij=t_ij, q_ij=np.stack([npq.from_rotation_matrix(R_gt[a].T @ R_gt[b])
                                                for a, b in pairs]),
            sqrt_info=np.tile(np.diag([20.0, 20, 20, 100, 100, 57.3]), (E, 1, 1)), valid=ones)
    return nodes, edges, p_gt


def _tables_on(t, dev, dtype):
    return type(t)(*(None if x is None else torch.as_tensor(
        x, device=dev, dtype=dtype if np.asarray(x).dtype.kind == "f" else None) for x in t))


@pytest.mark.parametrize("mode", ["4dof", "6dof"])
def test_scalable_pose_graph_solve_never_waits_on_the_host(dev, mode):
    """The solvers past 512 nodes (4-DoF: the banded API, which runs the
    closer's ``optimize_4dof_pcg``, 6 GN x 96 CG; 6-DoF: PCG, 5 GN x 96 CG;
    coarse groups of 32) on a 128-node circle on the card, float32: no host synchronisation under the sync debug mode,
    and the float64 CPU solve's outcome: its final cost within 10% and the
    path within 2 cm (the chain's slow yaw ramp is a quasi-null mode, along
    which float32 and float64 runs part by up to ~1 cm: chip_smoke.py's
    phase 7 prints it)."""
    from svin_tpu_torch import parallel as tpar

    nodes, edges, _ = _circle_graph(mode, 128)

    def run(d, dtype, iters):
        nd, ed = _tables_on(nodes, d, dtype), _tables_on(edges, d, dtype)
        if mode == "4dof":
            prob, meta = tpar.band_posegraph(nd, ed, block=1024, wmax=4, coarse_group=32)
            return lambda: tpar.optimize_4dof_banded(prob, meta, 1, iters=iters, cg_iters=96)
        return lambda: (tpar.optimize_6dof_pcg(nd, ed, 1, iters=iters, cg_iters=96,
                                               coarse_group=32), None)

    ref, ref_cost = run("cpu", torch.float64, 6 if mode == "4dof" else 5)()
    solve = run(dev, torch.float32, 6 if mode == "4dof" else 5)
    run(dev, torch.float32, 1)()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, cost = solve()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = (out.p if mode == "4dof" else out.r)[:128].cpu().double()
    want = (ref.p if mode == "4dof" else ref.r)[:128]
    assert float((got - want).abs().max()) < 0.02
    if cost is not None:
        assert abs(float(cost) - float(ref_cost)) <= 0.1 * float(ref_cost) + 1e-6


@pytest.mark.parametrize("K,route", [(12, "spd_solve_chol"), (64, "spd_solve_cluster")])
def test_global_ba_runs_on_the_solve_kernels(dev, K, route):
    """``ba_solve_local`` on the card (float32) solves its reduced system of
    D = 6K through B1 (the one-block kernel at D = 72, the cluster kernel at
    D = 384), once per GN iteration, with no host synchronisation; its
    poses within 1e-4 m of the same run with the plain solve on the card and
    within 1e-3 m of the truth from a 5 cm perturbation."""
    from svin_tpu_torch import parallel as tpar

    prob, rig = problems.build_global_ba_problem(np.random.default_rng(0), K=K, L=512, O=4096,
                                                 device=dev)
    dp = torch.as_tensor(np.random.default_rng(1).normal(0, 0.05, (K, 3)), dtype=torch.float32,
                         device=dev)
    start = prob._replace(pose_r=prob.pose_r + dp * (~prob.pose_fixed)[:, None])
    tpar.ba_solve_local(start, rig, iters=1)  # warm-up: builds and loads the kernels
    torch.cuda.synchronize()
    n0 = getattr(tsolve, route).launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, cost = tpar.ba_solve_local(start, rig, iters=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert getattr(tsolve, route).launches == n0 + 5
    plain, cost_p = tpar.ba_solve_local(start, rig, iters=5, solve=tsolve.solve_spd_plain)
    assert float((out.pose_r - plain.pose_r).abs().max()) < 1e-4
    assert float((out.pose_r - prob.pose_r).abs().max()) < 1e-3
    assert torch.isfinite(cost) and float(cost) < 1e-3


@pytest.mark.parametrize("revisit_frac", [0.02, 0.1])
def test_track_ba_never_waits_on_the_host(dev, revisit_frac):
    """``ba_solve_tracks`` on the card (float32, 2 GN x 32 CG, K = 64, L =
    1,024, span 8, blocks of 64; the overflow grows with the revisits): no
    host synchronisation under the sync debug mode, and the float64 CPU
    solve's outcome: poses within 2e-4 m (float32 and float64 solves of
    this budget part by ~2.5e-5 m on the CPU at K = 256 and 512) and the
    cost within 5e-3 relative (float32 rounds a 400 px projection to ~2e-5
    px, where the residuals left are ~1e-2 px: the CPU's float32 solve
    lands 2.5e-4 off)."""
    from svin_tpu_torch import parallel as tpar

    K, L = 64, 1024
    prob, rig = problems.build_global_ba_tracks(np.random.default_rng(5), K=K, L=L, span=8,
                                                revisit_frac=revisit_frac, dtype=torch.float64,
                                                device="cpu")
    rng = np.random.default_rng(6)
    start = prob._replace(
        pose_r=prob.pose_r + torch.as_tensor(rng.normal(0, 0.02, (K, 3))) * (~prob.pose_fixed)[:, None],
        lm=prob.lm + torch.as_tensor(rng.normal(0, 0.05, (L, 3))))
    tp, meta, _ = tpar.tracks_from_problem(start, span=8, block=64)
    ref, ref_cost = tpar.ba_solve_tracks(tp, rig, meta, iters=2, cg_iters=32)
    tp_d, rig_d = tree_to(tp, dev, torch.float32), tree_to(rig, dev, torch.float32)
    tpar.ba_solve_tracks(tp_d, rig_d, meta, iters=1, cg_iters=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, cost = tpar.ba_solve_tracks(tp_d, rig_d, meta, iters=2, cg_iters=32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(tp.ov_valid.any())
    assert float((out.pose_r.cpu().double() - ref.pose_r).abs().max()) < 2e-4
    assert abs(float(cost) - float(ref_cost)) <= 5e-3 * float(ref_cost)


def _sharded_ba_case(dev):
    K = 64
    prob, rig = problems.build_global_ba_problem(np.random.default_rng(3), K=K, device=dev)
    dp = torch.as_tensor(np.random.default_rng(4).normal(0, 0.05, (K, 3)), dtype=torch.float32,
                         device=dev)
    from svin_tpu_torch import parallel as tpar

    bp = tpar.bucket_problem(prob._replace(pose_r=prob.pose_r + dp * (~prob.pose_fixed)[:, None]))
    return K, prob, rig, bp


def test_sharded_ba_on_one_nccl_rank(dev, tmp_path):
    """``make_sharded_ba_bucketed`` on an NCCL group of one rank: the
    cluster kernel once per GN step, its three all_reduce per step on the
    card, the poses within 1e-4 m of ``ba_solve_bucketed``'s."""
    import torch.distributed as dist

    from svin_tpu_torch import parallel as tpar

    K, prob, rig, bp = _sharded_ba_case(dev)
    tpar.initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0)
    try:
        mesh = tpar.make_process_mesh()
        assert mesh.size == 1 and mesh.device.type == "cuda"
        step, shard = tpar.make_sharded_ba_bucketed(mesh, rig, K, bp.lm.shape[0], iters=10)
        local = shard(bp)
        n0 = tsolve.spd_solve_cluster.launches
        got, cost = step(local)
        torch.cuda.synchronize()
        assert tsolve.spd_solve_cluster.launches - n0 == 10
    finally:
        dist.destroy_process_group()
    want, wcost = tpar.ba_solve_bucketed(bp, rig, iters=10)
    assert float((got.pose_r - want.pose_r).abs().max()) < 1e-4
    assert float((got.pose_r - prob.pose_r).abs().max()) < 0.01


def test_sharded_ba_on_two_gloo_ranks_sharing_the_card(dev, tmp_path):
    """The same step on two gloo ranks (worker processes on device 0):
    the cluster kernel once per GN step on each rank, the poses within
    1e-4 m of the local solve and 1 cm of the truth."""
    from torch_dist_worker import launch

    out = launch("card", 2, tmp_path, {}, timeout=300)
    assert int(out["launches"]) == 10
    assert float(out["pose_diff"]) < 1e-4
    assert float(out["truth_err"]) < 0.01


@pytest.mark.parametrize("name", list(f32_checks.CHECKS))
def test_f32_regressions_on_the_card(dev, name):
    """``tests/test_f32_numerics.py``'s five float32 regressions on the
    port's functions on the card, with the JAX tests' inputs and bounds."""
    f32_checks.CHECKS[name](dev)
