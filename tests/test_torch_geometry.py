"""Parity of the PyTorch port's geometry layers with the JAX package.

Kinematics, distortion, pinhole projection, IMU preintegration /
propagation / factor, and the analytic trajectory simulator: the same
numpy-seeded inputs go through both packages in float64.

Tolerances: elementwise closed forms agree to 1e-12 (rounding order only);
the port's analytic distortion and trajectory derivatives against the JAX
package's forward-mode autodiff to 1e-10 relative (same expressions,
different association); the preintegral, a recursion over ~100 segments,
to 1e-9 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu import sim as jsim
from svin_tpu.cameras import distortion as jdist
from svin_tpu.cameras import pinhole as jpin
from svin_tpu.imu import preintegration as jpre
from svin_tpu.kinematics import quaternion as jquat
from svin_tpu.kinematics import transformation as jtf
from svin_tpu_torch import sim as tsim
from svin_tpu_torch.cameras import distortion as tdist
from svin_tpu_torch.cameras import pinhole as tpin
from svin_tpu_torch.convert import from_numpy_tree
from svin_tpu_torch.imu import preintegration as tpre
from svin_tpu_torch.kinematics import quaternion as tquat
from svin_tpu_torch.kinematics import transformation as ttf

torch.set_num_threads(1)


def T(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[: n // 4, 3] *= -1.0  # some negative scalar parts
    return q


def _rotvecs(rng, n):
    v = rng.standard_normal((n, 3))
    v[:3] *= 1e-7  # Taylor branch
    v[3] = 0.0
    return v


QUAT_OPS = {
    "multiply": lambda m, a, b, v: m.multiply(a, b),
    "rotate": lambda m, a, b, v: m.rotate(a, v),
    "to_rotation_matrix": lambda m, a, b, v: m.to_rotation_matrix(a),
    "exp": lambda m, a, b, v: m.exp(v),
    "log": lambda m, a, b, v: m.log(a),
    "log_near_identity": lambda m, a, b, v: m.log(m.exp(v * 1e-8)),
    "right_jacobian": lambda m, a, b, v: m.right_jacobian(v),
    "plus_matrix": lambda m, a, b, v: m.plus_matrix(a),
    "oplus_matrix": lambda m, a, b, v: m.oplus_matrix(a),
    "cross_mx": lambda m, a, b, v: m.cross_mx(v),
    "conjugate": lambda m, a, b, v: m.conjugate(a),
}


@pytest.mark.parametrize("op", sorted(QUAT_OPS))
def test_quaternion_op_matches_jax(op):
    rng = np.random.default_rng(1)
    a, b, v = _quats(rng, 16), _quats(rng, 16), _rotvecs(rng, 16)
    fn = QUAT_OPS[op]
    want = fn(jquat, jnp.asarray(a), jnp.asarray(b), jnp.asarray(v))
    got = fn(tquat, T(a), T(b), T(v))
    close(got, want)


TF_OPS = {
    "compose": lambda m, A, B, p, d: m.compose(A, B),
    "inverse": lambda m, A, B, p, d: m.inverse(A),
    "transform_point": lambda m, A, B, p, d: m.transform_point(A, p),
    "oplus": lambda m, A, B, p, d: m.oplus(A, d),
    "ominus": lambda m, A, B, p, d: m.ominus(A, B),
}


@pytest.mark.parametrize("op", sorted(TF_OPS))
def test_transformation_op_matches_jax(op):
    rng = np.random.default_rng(2)
    ra, rb, p, d = (rng.standard_normal((8, k)) for k in (3, 3, 3, 6))
    qa, qb = _quats(rng, 8), _quats(rng, 8)
    want = TF_OPS[op](
        jtf, jtf.Transformation(jnp.asarray(ra), jnp.asarray(qa)),
        jtf.Transformation(jnp.asarray(rb), jnp.asarray(qb)), jnp.asarray(p), jnp.asarray(d),
    )
    got = TF_OPS[op](
        ttf, ttf.Transformation(T(ra), T(qa)), ttf.Transformation(T(rb), T(qb)), T(p), T(d),
    )
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        close(g, w)


DIST_PARAMS = {
    "none": [0.0],
    "radialtangential": [-0.2834, 0.0739, 0.00019, 1.76e-05],
    "radialtangential8": [-0.28, 0.07, 0.0002, 1.7e-05, 0.01, 0.02, -0.01, 0.005],
    "equidistant": [-0.01, 0.02, -0.003, 0.001],
}


def _norm_points(rng):
    p = rng.uniform(-0.8, 0.8, size=(40, 2))
    p[0] = 0.0  # the equidistant model's r → 0 floor
    return p


@pytest.mark.parametrize("what", ["distort", "jacobian", "undistort"])
@pytest.mark.parametrize("model", sorted(DIST_PARAMS))
def test_distortion_matches_jax(model, what):
    rng = np.random.default_rng(3)
    p = _norm_points(rng)
    k = DIST_PARAMS[model]
    fj = {"distort": jdist.distort, "jacobian": jdist.distort_jacobian, "undistort": jdist.undistort}[what]
    ft = {"distort": tdist.distort, "jacobian": tdist.distort_jacobian, "undistort": tdist.undistort}[what]
    close(ft(model, T(p), T(k)), fj(model, jnp.asarray(p), jnp.asarray(k)), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("model", sorted(DIST_PARAMS))
def test_pinhole_matches_jax(model):
    rng = np.random.default_rng(4)
    args = (752, 480, 458.654, 457.296, 367.215, 248.375, DIST_PARAMS[model], model)
    jcam, tcam = jpin.make_camera(*args), tpin.make_camera(*args)
    p = np.concatenate([
        rng.uniform([-2, -2, 0.5], [2, 2, 6], size=(30, 3)),
        [[0.1, 0.2, -1.0], [0.0, 0.0, 0.0], [5.0, 0.0, 0.1]],  # behind, at, off-image
    ])
    uv_j, ok_j = jpin.project(jcam, jnp.asarray(p))
    uv_t, ok_t = tpin.project(tcam, T(p))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert bool(torch.isfinite(uv_t).all()) and not bool(ok_t[-3])
    close(uv_t, uv_j, rtol=1e-12, atol=1e-9)
    close(tpin.project_jacobian(tcam, T(p)), jpin.project_jacobian(jcam, jnp.asarray(p)),
          rtol=1e-10, atol=1e-9)
    px = rng.uniform([0, 0], [751, 479], size=(20, 2))
    close(tpin.back_project(tcam, T(px)), jpin.back_project(jcam, jnp.asarray(px)), atol=1e-11)


@pytest.mark.parametrize("ramp_tau", [0.0, 0.7])
def test_sim_trajectory_matches_jax(ramp_tau):
    ts = np.array([0.0, 0.05, 0.3, 0.69, 1.3, 2.7])
    jtraj = jsim.default_trajectory(ramp_tau=ramp_tau)
    ttraj = tsim.default_trajectory(ramp_tau=ramp_tau)
    params = jpre.ImuParameters()
    for t in ts:
        tt = torch.tensor(t, dtype=torch.float64)
        close(tsim.position(ttraj, tt), jsim.position(jtraj, t))
        close(tsim.velocity(ttraj, tt), jsim.velocity(jtraj, t), rtol=1e-10)
        close(tsim.angular_velocity_body(ttraj, tt), jsim.angular_velocity_body(jtraj, t), rtol=1e-10, atol=1e-12)
        close(tsim.specific_force_body(ttraj, tt, tpre.ImuParameters()),
              jsim.specific_force_body(jtraj, t, params), rtol=1e-10, atol=1e-11)
        close(tsim.pose(ttraj, tt).q, jsim.pose(jtraj, t).q)


@pytest.fixture(scope="module")
def imu_case():
    """A 0.5 s noisy 200 Hz series bracketing [t0, t1], with a gyro
    saturation burst and padded invalid tail samples."""
    rng = np.random.default_rng(5)
    traj = jsim.default_trajectory()
    params = jpre.ImuParameters()
    series = jsim.simulate_imu(traj, 0.25, 0.75, 200.0, params)
    t = np.asarray(series.t)
    gyro = np.asarray(series.gyro) + 0.01 * rng.standard_normal((t.size, 3))
    acc = np.asarray(series.acc) + 0.05 * rng.standard_normal((t.size, 3))
    gyro[40:43] *= 50.0  # saturation → noise inflation
    valid = np.ones(t.size, bool)
    valid[-5:] = False
    bias = np.concatenate([0.01 * rng.standard_normal(3), 0.05 * rng.standard_normal(3)])
    args = (t, gyro, acc, valid, 0.3, 0.7, bias)
    pre_j = jpre.preintegrate(*(jnp.asarray(a) for a in args), params)
    pre_j = jax.tree_util.tree_map(np.asarray, pre_j)
    pre_t = tpre.preintegrate(*(torch.as_tensor(np.array(a)) for a in args), tpre.ImuParameters())
    return pre_j, pre_t, params


def test_preintegrate_matches_jax(imu_case):
    pre_j, pre_t, _ = imu_case
    for name, g, w in zip(pre_t._fields, pre_t, pre_j):
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-9 * scale, err_msg=name)


def test_sqrt_information_matches_jax(imu_case):
    pre_j, pre_t, _ = imu_case
    Wj = np.asarray(jpre.sqrt_information(jpre.Preintegral(*map(jnp.asarray, pre_j))))
    Wt = tpre.sqrt_information(pre_t).numpy()
    np.testing.assert_allclose(Wt, Wj, rtol=1e-8, atol=1e-8 * np.abs(Wj).max())
    # degenerate segment (P = 0): a zero whitener, not NaN
    zero = tpre.sqrt_information(pre_t._replace(P_delta=torch.zeros(15, 15, dtype=torch.float64)))
    assert bool((zero == 0).all())


def test_propagate_and_imu_factor_match_jax(imu_case):
    pre_j, pre_t, params = imu_case
    rng = np.random.default_rng(6)
    r0, r1 = rng.standard_normal(3), rng.standard_normal(3)
    q0, q1 = _quats(rng, 2)
    sb0, sb1 = 0.1 * rng.standard_normal(9), 0.1 * rng.standard_normal(9)
    pj = jpre.Preintegral(*map(jnp.asarray, pre_j))
    Tj0 = jtf.Transformation(jnp.asarray(r0), jnp.asarray(q0))
    Tj1 = jtf.Transformation(jnp.asarray(r1), jnp.asarray(q1))
    Tt0, Tt1 = ttf.Transformation(T(r0), T(q0)), ttf.Transformation(T(r1), T(q1))
    tparams = tpre.ImuParameters()

    Tp_j, sbp_j = jpre.propagate(Tj0, jnp.asarray(sb0), pj, params)
    Tp_t, sbp_t = tpre.propagate(Tt0, T(sb0), pre_t, tparams)
    close(Tp_t.r, Tp_j.r, rtol=1e-10)
    close(Tp_t.q, Tp_j.q, rtol=1e-10)
    close(sbp_t, sbp_j, rtol=1e-10)

    got = tpre.error_and_jacobians(Tt0, T(sb0), Tt1, T(sb1), pre_t, tparams)
    want = jpre.error_and_jacobians(Tj0, jnp.asarray(sb0), Tj1, jnp.asarray(sb1), pj, params)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-10, atol=1e-10)
    # batched over leading dims, as the factor table evaluates it
    pre_b = from_numpy_tree(jax.tree_util.tree_map(lambda a: np.stack([a, a]), pre_j))
    e_b, _, F1_b = tpre.error_and_jacobians(
        ttf.Transformation(T([r0, r1]), T([q0, q1])), T([sb0, sb1]),
        ttf.Transformation(T([r1, r0]), T([q1, q0])), T([sb1, sb0]), pre_b, tparams,
    )
    close(e_b[0], got[0], rtol=1e-12)
    close(F1_b[0], got[2], rtol=1e-12)
