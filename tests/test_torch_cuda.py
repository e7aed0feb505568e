"""The port's CUDA kernels on the card, held to their plain PyTorch versions.

Every test carries the ``cuda`` marker and skips without a CUDA device (the
kernels have no CPU mode). This file imports no JAX, so it runs on a machine
with the card and without JAX; there, skip the JAX-importing conftest and
the xdist options of pytest.ini:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: B2 is integer-exact. B1 (float32 Gauss–Jordan without
pivoting vs float32 Cholesky) on Jacobi-equilibrated SPD systems: relative
residual ≤ 1e-4 and relative distance to the plain solution ≤ 1e-3. The
backend step with kernels vs with plain versions: identical matches (the
distance matrix is exact), cost within 1% and positions within 1 mm (the
two solvers round differently and the LM loop carries that forward). The
engine's serial path at the CPU tests' size: the CPU tests' tracking and
5 cm ATE bounds, with the kernels and with the plain versions.
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
    n0 = tsolve.spd_solve_gj.launches
    x = tsolve.solve_spd(H, b)
    torch.cuda.synchronize()
    assert tsolve.spd_solve_gj.launches == n0 + 1
    ref = tsolve.solve_spd_plain(H, b)
    assert float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b)) <= 1e-4
    assert float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)) <= 1e-3


def test_solve_kernel_batched_and_refusals(dev):
    rng = np.random.default_rng(1)
    H, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in _equilibrated_spd(rng, 40, batch=(3,)))
    x = tsolve.spd_solve_gj(H, b)
    ref = tsolve.solve_spd_plain(H, b)
    assert float((x - ref).abs().max() / ref.abs().max()) <= 1e-3
    with pytest.raises(TypeError):
        tsolve.solve_spd(H.double(), b.double())  # float32 only: no silent demotion
    big = torch.eye(240, device=dev)
    with pytest.raises(ValueError):
        tsolve.solve_spd(big, torch.ones(240, device=dev))
    with pytest.raises(TypeError):
        tham.hamming_matrix(torch.zeros((4, 8), device=dev), torch.zeros((4, 8), device=dev))


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
    n_solve, n_ham = tsolve.spd_solve_gj.launches, tham.hamming_matrix_cuda.launches
    kern = BackendStep(rig, problems.IMU_PARAMS, cfg).to(dev)(w, f, frame, cfg.max_iterations, 0)
    torch.cuda.synchronize()
    assert tsolve.spd_solve_gj.launches == n_solve + cfg.max_iterations
    assert tham.hamming_matrix_cuda.launches == n_ham + 1
    plain = BackendStep(rig, problems.IMU_PARAMS, cfg, solve=tsolve.solve_spd_plain,
                        hamming=tham.hamming_matrix_plain).to(dev)(w, f, frame, cfg.max_iterations, 0)
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


def _small_engine_run(dev, **kernels):
    """The engine's serial path on the card at the CPU tests' size: two
    200x150 cameras, 300 blobs, 6 Hz for 2.6 s (the port's own sequence)."""
    from svin_tpu_torch import sim
    from svin_tpu_torch.cameras import NCameraSystem, make_camera
    from svin_tpu_torch.evaluation import ate_rmse
    from svin_tpu_torch.kinematics import from_rq
    from svin_tpu_torch.pipeline import VioConfig, VioEngine, run_events, synthetic_sequence

    cam = make_camera(200, 150, 160.0, 160.0, 100.0, 75.0, model="none", device=dev)
    rig = NCameraSystem()
    rig.add_camera(from_rq([0.0, 0.0, 0.0], [0, 0, 0, 1], device=dev), cam)
    rig.add_camera(from_rq([0.2, 0.0, 0.0], [0, 0, 0, 1], device=dev), cam)
    cfg = VioConfig(num_keyframes=4, num_imu_frames=2, max_keypoints=150, max_iterations=5)
    events, renderer = synthetic_sequence(
        rig, duration=2.6, cam_rate=6.0, imu_rate=100.0, imu_params=cfg.imu, seed=3,
        n_points=300, traj=sim.default_trajectory(scale=0.4, ramp_tau=0.8), spread=6.0,
        depth_offset=3.0, t_first_frame=0.12)
    engine = VioEngine(cfg, rig=rig, device=dev, **kernels)
    results = run_events(engine, events)
    est = np.stack([r.T_WS.r for r in results])
    gt = np.stack([renderer.pose(r.timestamp).r.numpy() for r in results])
    return engine, results, ate_rmse(est, gt, with_scale=False)[0]


def test_engine_runs_on_the_card_with_kernels_and_plain(dev):
    """float32 on the card: the serial ``add_frame`` path tracks, stays
    within the CPU tests' ATE bound (5 cm) and launches both kernels; with
    the plain versions it launches none and meets the same bound."""
    n_solve, n_ham = tsolve.spd_solve_gj.launches, tham.hamming_matrix_cuda.launches
    engine, results, ate = _small_engine_run(dev)
    assert len(results) >= 10 and np.median([r.num_tracked for r in results[1:]]) >= 20
    assert ate < 0.05, ate
    assert tsolve.spd_solve_gj.launches > n_solve and tham.hamming_matrix_cuda.launches > n_ham
    assert np.isfinite(engine._lm_cov).all()
    n_solve, n_ham = tsolve.spd_solve_gj.launches, tham.hamming_matrix_cuda.launches
    _, _, ate_plain = _small_engine_run(dev, solve=tsolve.solve_spd_plain,
                                        hamming=tham.hamming_matrix_plain)
    assert ate_plain < 0.05, ate_plain
    assert (tsolve.spd_solve_gj.launches, tham.hamming_matrix_cuda.launches) == (n_solve, n_ham)
