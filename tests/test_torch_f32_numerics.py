"""The f32 numeric regressions of ``tests/test_f32_numerics.py`` on the port.

The JAX package pinned three float32 failure modes that made its engine
diverge on the 30 s gauntlet: the preintegration whitener's raw Cholesky of
an ill-conditioned covariance, the marginal prior's pseudo-inverse and
range projection, and the pose-graph solve at Cave-scale coordinates. The
port ships float32 on the card, so the same five checks run here in
explicit float32 on the port's functions, with the JAX tests' inputs
(``np.random.RandomState`` seeds 0-3) and bounds:

- ``imu.preintegration.sqrt_information``: WᵀW·P within 1e-2 of I;
- ``estimator.marginalization._pinv_sym``: A·A⁺ − I within 1e-2 in the
  equilibrated metric at 1e11 dynamic range, the small-scale rows live;
  empty rows zero and finite;
- ``estimator.marginalization._project_to_range``: the negative curvature
  and the null-space gradient removed, the range part of b kept;
- ``loopclosure.posegraph.optimize_4dof``: 30 GN steps at |p| ~ 200 m stay
  finite and within 5 m of the truth.

Each check takes a device; ``tests/test_torch_cuda.py`` runs the same five
on the card. This file imports no JAX.
"""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode


def _scaled_spd(rng, scales):
    """SPD with a per-coordinate scale spread and a well-conditioned
    correlation core (the JAX test's helper)."""
    n = len(scales)
    C = np.eye(n) + 0.3 * rng.rand(n, n)
    C = 0.5 * (C + C.T) + n * np.eye(n)
    Cn = C / np.sqrt(np.outer(np.diag(C), np.diag(C)))
    d = np.asarray(scales)
    return np.sqrt(np.outer(d, d)) * Cn


def _f32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def check_sqrt_information(device):
    from svin_tpu_torch.imu.preintegration import Preintegral, sqrt_information

    rng = np.random.RandomState(0)
    d = np.concatenate([
        1e-8 * (1 + rng.rand(3)), 1e-6 * (1 + rng.rand(3)),
        1e-8 * (1 + rng.rand(3)), 1e-13 * (1 + rng.rand(3)),
        1e-11 * (1 + rng.rand(3)),
    ])
    P = _scaled_spd(rng, d).astype(np.float32)
    eye3 = np.eye(3)
    pre = Preintegral(
        Delta_q=_f32([0.0, 0, 0, 1], device), C_integral=_f32(eye3, device),
        C_doubleintegral=_f32(eye3, device), acc_integral=_f32(np.zeros(3), device),
        acc_doubleintegral=_f32(np.zeros(3), device), dalpha_db_g=_f32(np.zeros((3, 3)), device),
        dv_db_g=_f32(np.zeros((3, 3)), device), dp_db_g=_f32(np.zeros((3, 3)), device),
        P_delta=_f32(P, device), Delta_t=_f32(0.3, device), bias_ref=_f32(np.zeros(6), device),
    )
    W = sqrt_information(pre)
    assert W.dtype == torch.float32
    W = W.cpu().numpy()
    err = np.abs(W.T @ W @ P.astype(np.float64) - np.eye(15)).max()
    assert err < 1e-2, f"whitener error {err} (f32 Cholesky lost the factor)"


def check_pinv_sym_wide_dynamic_range(device):
    from svin_tpu_torch.estimator.marginalization import _pinv_sym

    rng = np.random.RandomState(1)
    scales = np.asarray([1e11, 1e9, 1e7, 1e5, 1e3, 1e2, 1e2, 1e1, 1e1, 1.0, 1.0, 1.0,
                         1e-1, 1e-1, 1e-1])
    A = _scaled_spd(rng, scales).astype(np.float32)
    Ainv = _pinv_sym(_f32(A, device))
    assert Ainv.dtype == torch.float32
    Ainv = Ainv.cpu().numpy()
    R = np.asarray(A, np.float64) @ Ainv - np.eye(15)
    d = np.sqrt(np.diag(A).astype(np.float64))
    err = np.abs(R / d[:, None] * d[None, :]).max()
    assert err < 1e-2, f"pinv error {err}"
    assert np.abs(Ainv[-1]).max() > 0.1, "small-scale row dropped"


def check_pinv_sym_empty_rows(device):
    from svin_tpu_torch.estimator.marginalization import _pinv_sym

    A = np.diag([4.0, 1.0, 0.0, -1e-7]).astype(np.float32)
    A[0, 2] = A[2, 0] = 1e-5  # off-diagonal residue on an empty row
    P = _pinv_sym(_f32(A, device)).cpu().numpy()
    assert np.isfinite(P).all()
    assert np.allclose(P[2], 0) and np.allclose(P[3], 0)
    assert abs(P[0, 0] - 0.25) < 1e-6 and abs(P[1, 1] - 1.0) < 1e-6


def check_project_to_range(device):
    from svin_tpu_torch.estimator.marginalization import _project_to_range

    rng = np.random.RandomState(2)
    n = 24
    Q, _ = np.linalg.qr(rng.randn(n, n))
    w = np.concatenate([1e8 * (1 + rng.rand(n - 6)), np.zeros(5), [-1e3]])
    H = (Q * w[None, :]) @ Q.T
    b_range = H @ (1e-3 * rng.randn(n))
    v_null, v_neg = Q[:, -3], Q[:, -1]
    b_null = v_null * 50.0  # contamination in a null direction
    Hp, bp = _project_to_range(_f32(H, device), _f32(b_range + b_null, device))
    assert Hp.dtype == bp.dtype == torch.float32
    Hp, bp = Hp.cpu().numpy().astype(np.float64), bp.cpu().numpy().astype(np.float64)
    wmin = np.linalg.eigvalsh(Hp).min()
    noise = np.finfo(np.float32).eps * np.abs(w).max() * n
    assert wmin > -noise, (wmin, noise)
    assert v_neg @ Hp @ v_neg > -noise, v_neg @ Hp @ v_neg
    assert abs(bp @ v_null) < 5.0, bp @ v_null
    assert np.linalg.norm(bp) > 0.1 * np.linalg.norm(b_range)


def check_optimize_4dof_large_coordinates(device):
    from svin_tpu_torch.loopclosure.posegraph import PoseGraphEdges, PoseGraphNodes, optimize_4dof

    rng = np.random.RandomState(3)
    N = 64
    th = np.linspace(0, 4 * np.pi, N)
    p = np.stack([200 * np.cos(th), 200 * np.sin(th), 0.1 * th], 1)
    yaw = th + np.pi / 2
    p_n = p + 0.5 * rng.randn(N, 3)
    yaw_n = yaw + 0.02 * rng.randn(N)
    i = np.arange(N - 1)
    j = i + 1
    cy, sy = np.cos(yaw[i]), np.sin(yaw[i])
    d = p[j] - p[i]
    t_ij = np.stack([cy * d[:, 0] + sy * d[:, 1], -sy * d[:, 0] + cy * d[:, 1], d[:, 2]], 1)
    il = np.array([5, 20])
    jl = il + 30
    cyl, syl = np.cos(yaw[il]), np.sin(yaw[il])
    dl = p[jl] - p[il]
    t_l = np.stack([cyl * dl[:, 0] + syl * dl[:, 1], -syl * dl[:, 0] + cyl * dl[:, 1], dl[:, 2]], 1)
    E = N - 1 + 2
    dev = torch.device(device)
    nodes = PoseGraphNodes(
        p=_f32(p_n, dev), yaw=_f32(yaw_n, dev), pitch=torch.zeros(N, device=dev),
        roll=torch.zeros(N, device=dev), valid=torch.ones(N, dtype=torch.bool, device=dev),
    )
    edges = PoseGraphEdges(
        i=torch.as_tensor(np.concatenate([i, il]), dtype=torch.int32, device=dev),
        j=torch.as_tensor(np.concatenate([j, jl]), dtype=torch.int32, device=dev),
        t_ij=_f32(np.concatenate([t_ij, t_l]), dev),
        yaw_ij=_f32(np.concatenate([yaw[j] - yaw[i], yaw[jl] - yaw[il]]), dev),
        weight=_f32(np.concatenate([np.ones(N - 1), [5.0, 5.0]]), dev),
        is_loop=torch.as_tensor(np.concatenate([np.zeros(N - 1, bool), [True, True]]), device=dev),
        valid=torch.ones(E, dtype=torch.bool, device=dev),
    )
    out = optimize_4dof(nodes, edges, 1, iters=30)
    assert out.p.dtype == torch.float32
    p_out = out.p.cpu().numpy()
    assert np.isfinite(p_out).all()
    assert np.abs(p_out - p).max() < 5.0, np.abs(p_out - p).max()


CHECKS = {
    "sqrt_information": check_sqrt_information,
    "pinv_sym_wide_dynamic_range": check_pinv_sym_wide_dynamic_range,
    "pinv_sym_empty_rows": check_pinv_sym_empty_rows,
    "project_to_range": check_project_to_range,
    "optimize_4dof_large_coordinates": check_optimize_4dof_large_coordinates,
}


def test_sqrt_information_f32_ill_conditioned():
    check_sqrt_information("cpu")


def test_pinv_sym_f32_wide_dynamic_range():
    check_pinv_sym_wide_dynamic_range("cpu")


def test_pinv_sym_empty_rows_masked():
    check_pinv_sym_empty_rows("cpu")


def test_project_to_range_bounds_prior_cost():
    check_project_to_range("cpu")


def test_optimize_4dof_f32_large_coordinates():
    check_optimize_4dof_large_coordinates("cpu")


@pytest.mark.parametrize("name", list(CHECKS))
def test_f32_check_stays_in_float32(name):
    """No check passes by computing in float64 behind the caller's back:
    every floating tensor a torch function returns during the check is
    float32 (the checks' own float64 reference algebra runs in numpy)."""
    made = set()

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    made.add(t.dtype)
            return out

    with Spy():
        CHECKS[name]("cpu")
    assert made == {torch.float32}, made
