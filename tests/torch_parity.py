"""Shared set-up for the PyTorch-port parity tests: a synthetic window
problem from the JAX package's builder, with water-depth, sonar-range and
landmark-prior factors attached, handed to both packages; and the JAX
package's RANSAC draws, rebuilt from a PRNG key for the port."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from svin_tpu.estimator import WindowConfig as JaxWindowConfig
from svin_tpu.estimator import rig as jrig
from svin_tpu.estimator import window as jwin
from svin_tpu.imu import Preintegral as JaxPreintegral
from svin_tpu.problems import build_window_problem
from svin_tpu_torch import problems as tproblems
from svin_tpu_torch.cameras import NCameraSystem, make_camera
from svin_tpu_torch.convert import from_numpy_tree
from svin_tpu_torch.estimator import WindowConfig
from svin_tpu_torch.kinematics import from_rq

JAX_TYPES = {
    cls.__name__: cls
    for cls in (
        jwin.WindowState, jwin.Factors, jwin.ReprojectionFactors, jwin.ImuFactors,
        jwin.DepthFactors, jwin.SonarFactors, jwin.PriorFactors, jwin.ExtrinsicsPrior,
        jwin.MarginalPrior, jwin.LandmarkPrior, jrig.RigParams, JaxPreintegral,
    )
}


def jax_problem(S=4, L=64, O=512, n_landmarks=48, max_iterations=6,
                estimate_extrinsics=False, seed=0):
    """(jax cfg, port cfg, window, factors, rig_p, truth) as JAX pytrees,
    with a depth factor on every state, sonar-range factors on two states,
    a prior on two landmarks and (with extrinsics estimation) an absolute
    extrinsics prior."""
    jcfg = JaxWindowConfig(num_states=S, num_landmarks=L, num_obs=O,
                           max_iterations=max_iterations,
                           estimate_extrinsics=estimate_extrinsics)
    tcfg = WindowConfig(num_states=S, num_landmarks=L, num_obs=O,
                        max_iterations=max_iterations,
                        estimate_extrinsics=estimate_extrinsics)
    w, f, rig_p, truth = build_window_problem(jax.random.PRNGKey(seed), jcfg,
                                              n_landmarks=n_landmarks)
    rng = np.random.default_rng(seed)
    r_true = np.asarray(truth["r"])
    lms = np.asarray(truth["lms"])
    hp = np.asarray(w.hp_W)
    depth = f.depth._replace(
        depth=jnp.asarray(-r_true[:, 2] + 0.01 * rng.standard_normal(S)),
        valid=jnp.ones(S, bool),
    )
    rng_v = np.zeros(S)
    tgt = np.zeros((S, 3))
    valid = np.zeros(S, bool)
    for s in (1, S - 2):
        d = np.linalg.norm(lms - r_true[s], axis=1)
        l = int(np.argmin(d))
        rng_v[s], tgt[s], valid[s] = d[l] + 0.02 * rng.standard_normal(), hp[l, :3], True
    sonar = f.sonar._replace(range=jnp.asarray(rng_v), target_W=jnp.asarray(tgt),
                             valid=jnp.asarray(valid))
    lp_valid = np.zeros(L, bool)
    lp_valid[:2] = True
    lp_si = np.zeros((L, 3, 3))
    lp_si[:2] = 20.0 * np.eye(3)
    lm_prior = f.lm_prior._replace(mean=jnp.asarray(np.pad(lms[:2], ((0, L - 2), (0, 0)))),
                                   sqrt_info=jnp.asarray(lp_si), valid=jnp.asarray(lp_valid))
    f = f._replace(depth=depth, sonar=sonar, lm_prior=lm_prior)
    if estimate_extrinsics:
        C = jcfg.num_cameras
        f = f._replace(ext_prior=f.ext_prior._replace(
            mean_r=w.ext_r, mean_q=w.ext_q,
            sqrt_info=jnp.tile(jnp.diag(jnp.asarray([100.0] * 3 + [50.0] * 3)), (C, 1, 1)),
            valid=jnp.ones(C, bool),
        ))
    return jcfg, tcfg, w, f, rig_p, truth


def port(tree):
    """JAX pytree → the port's NamedTuples (float64, CPU)."""
    return from_numpy_tree(tree)


def to_jax(tree):
    """The port's NamedTuples → the JAX package's (float64 arrays)."""
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    if hasattr(tree, "_fields"):
        cls = JAX_TYPES.get(type(tree).__name__, type(tree))
        return cls(*(to_jax(x) for x in tree))
    return tree


def port_problem(S=4, L=64, O=512, n_landmarks=48, max_iterations=6,
                 estimate_extrinsics=False, seed=0):
    """The same kind of problem as ``jax_problem``, built by the port's
    builder (much cheaper than the JAX builder's eager tracing) and handed
    to the JAX package through ``to_jax``: (jax cfg, port cfg, JAX
    (window, factors, rig_p), port (window, factors, rig_p))."""
    jcfg = JaxWindowConfig(num_states=S, num_landmarks=L, num_obs=O,
                           max_iterations=max_iterations,
                           estimate_extrinsics=estimate_extrinsics)
    tcfg = WindowConfig(num_states=S, num_landmarks=L, num_obs=O,
                        max_iterations=max_iterations,
                        estimate_extrinsics=estimate_extrinsics)
    rng = np.random.default_rng(seed)
    w, f, rig_p, truth = tproblems.build_window_problem(rng, tcfg, n_landmarks=n_landmarks)
    f = tproblems.attach_depth_and_sonar(f, truth, w, [1, S - 2], rng)
    lp = f.lm_prior
    mean, si, valid = lp.mean.clone(), lp.sqrt_info.clone(), lp.valid.clone()
    mean[:2] = truth["lms"][:2]
    si[:2] = 20.0 * torch.eye(3, dtype=torch.float64)
    valid[:2] = True
    f = f._replace(lm_prior=lp._replace(mean=mean, sqrt_info=si, valid=valid))
    if estimate_extrinsics:
        C = tcfg.num_cameras
        ep = f.ext_prior
        f = f._replace(ext_prior=ep._replace(
            mean_r=w.ext_r.clone(), mean_q=w.ext_q.clone(),
            sqrt_info=torch.diag(torch.tensor([100.0] * 3 + [50.0] * 3,
                                              dtype=torch.float64)).repeat(C, 1, 1),
            valid=torch.ones(C, dtype=torch.bool),
        ))
    return jcfg, tcfg, (to_jax(w), to_jax(f), to_jax(rig_p)), (w, f, rig_p)


def assert_close(got, want, rtol, atol_rel=0.0, name="", atol=1e-12):
    """Elementwise |got − want| ≤ rtol·|want| + atol_rel·max|want| + atol
    (the absolute floor covers float64 rounding residue of zero values)."""
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if w.dtype == np.uint32:
        w = w.view(np.int32)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=name)
        return
    scale = float(np.max(np.abs(w))) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * scale + atol, err_msg=name)


def assert_prior_close(got, want, rtol, name="marg"):
    """A marginal prior: H entrywise within rtol·sqrt(H_ii·H_jj) (the scale
    its eigenvalue clipping works at) plus 1e-9 of its largest entry (rows
    of gauge-free coordinates hold only cancellation residue of the Schur
    complement, ~eps x its largest intermediate), b within rtol of its
    largest entry, linearization points to 1e-12."""
    H, Hw = got.H.numpy(), np.asarray(want.H)
    dg = np.sqrt(np.abs(np.diag(Hw)))
    bound = rtol * np.outer(dg, dg) + 1e-9 * np.abs(Hw).max()
    assert np.all(np.abs(H - Hw) <= bound), f"{name}.H: {np.max(np.abs(H - Hw) - bound)}"
    assert_close(got.b, want.b, rtol=0.0, atol_rel=rtol, name=f"{name}.b")
    assert_tree_close(got._replace(H=None, b=None), want._replace(H=None, b=None),
                      rtol=1e-12, name=name)


def assert_tree_close(got, want, rtol, atol_rel=0.0, name=""):
    """Field-by-field assert_close over matching NamedTuples."""
    if hasattr(want, "_fields"):
        for field, g, w in zip(want._fields, got, want):
            assert_tree_close(g, w, rtol, atol_rel, f"{name}.{field}")
    elif want is None or isinstance(want, (int, str, float)):
        assert got == want, name
    else:
        assert_close(got, want, rtol, atol_rel, name)


def jax_draws(key, valid, num_hypotheses, sample_size):
    """The (H, s) sample indices the JAX package's RANSACs draw from ``key``
    (``jax.random.split`` + ``jax.random.choice`` with probabilities ∝
    valid + 1e-9), as an int64 tensor."""
    valid = jnp.asarray(np.asarray(valid))
    N = valid.shape[0]
    probs = jnp.where(valid, 1.0, 1e-9)
    keys = jax.random.split(key, num_hypotheses)
    idx = jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(sample_size,), replace=False, p=probs / jnp.sum(probs)))(keys)
    return torch.as_tensor(np.array(idx), dtype=torch.int64)


def jax_engine_draw(seed, sub, valid, num_hypotheses, sample_size):
    """The JAX engine's draws, in the port engine's ``draw_hypotheses``
    form: key ``PRNGKey(seed)``, or half ``sub`` of its split."""
    key = jax.random.PRNGKey(seed)
    if sub is not None:
        key = jax.random.split(key)[sub]
    return jax_draws(key, valid.cpu().numpy(), num_hypotheses, sample_size).to(valid.device)


def port_rig() -> NCameraSystem:
    """The port's copy of ``vio_fixtures.small_rig``: two 200x150 pinhole
    cameras, 20 cm baseline."""
    cam = make_camera(200, 150, 160.0, 160.0, 100.0, 75.0, model="none")
    rig = NCameraSystem()
    rig.add_camera(from_rq([0.0, 0.0, 0.0], [0, 0, 0, 1]), cam)
    rig.add_camera(from_rq([0.2, 0.0, 0.0], [0, 0, 0, 1]), cam)
    return rig


def revisit_exports(drift_step=(0.03, -0.02, 0.01), n_traverse=8, revisits=(0.0, 0.25, 0.5)):
    """The JAX loop-closure tests' rendered revisit (``test_loopclosure.py``,
    ``test_loop_closure_reduces_trajectory_error_e2e``) as keyframe exports:
    one 200x150 camera, a traverse of ``n_traverse`` keyframes 0.25 s apart
    and revisits of the first ones (offset by a few cm), VIO poses and
    landmark maps carrying an accumulating translation drift. Returns
    (camera (JAX), exports, true positions)."""
    from svin_tpu import sim as jsim
    from svin_tpu.cameras import project
    from svin_tpu.kinematics import Transformation as JT
    from svin_tpu.kinematics import inverse, transform_point
    from test_loopclosure import _describe_frame, _render_setup

    cam, _, renderer = _render_setup()
    times = [0.25 * k for k in range(n_traverse)] + list(revisits)
    lms = np.asarray(renderer.points_W, float)
    drift_step = np.asarray(drift_step)
    exports, gt = [], []
    for k, t in enumerate(times):
        T_gt = jsim.pose(renderer.traj, jnp.float64(t))
        if k >= n_traverse:
            T_gt = JT(r=T_gt.r + jnp.array([0.04, -0.02, 0.01]), q=T_gt.q)
        d_k = k * drift_step
        img = np.asarray(renderer._render_jit(T_gt, 0))
        kp, _ = _describe_frame(jnp.asarray(img))
        uv, ok = project(cam, transform_point(inverse(T_gt), jnp.asarray(lms)))
        okn, uvn, kuv = np.asarray(ok), np.asarray(uv), np.asarray(kp.uv)
        ids, pts3, uv2 = [], [], []
        for q in np.nonzero(np.asarray(kp.valid))[0]:
            d2 = np.sum((uvn - kuv[q]) ** 2, axis=1)
            d2[~okn] = 1e9
            j = int(np.argmin(d2))
            if d2[j] < 4.0:
                ids.append(j)
                pts3.append(lms[j] + d_k)  # the VIO's drifted map
                uv2.append(kuv[q])
        exports.append({
            "kf_index": k, "timestamp": t + (10.0 if k >= n_traverse else 0.0), "image": img,
            "T_WC_r": np.asarray(T_gt.r) + d_k, "T_WC_q": np.asarray(T_gt.q),
            "points_W": np.stack(pts3), "landmark_ids": np.asarray(ids),
            "keypoints_uv": np.stack(uv2), "quality": np.full(len(ids), 0.5),
            "num_tracked": len(ids), "quadrant_counts": np.array([5, 5, 5, 5]),
            "response_strengths": np.ones(len(ids)),
        })
        gt.append(np.asarray(T_gt.r))
    return cam, exports, np.stack(gt)


def jax_p3p_draws(cur_index, old_index, valid, num_hypotheses):
    """The JAX loop closer's P3P draws (key ``PRNGKey(cur * 7919 + old)``),
    in the port closer's ``draw_p3p`` form."""
    key = jax.random.PRNGKey(cur_index * 7919 + old_index)
    return jax_draws(key, valid.cpu().numpy(), num_hypotheses, 3).to(valid.device)
