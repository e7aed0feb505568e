"""The port's engine programs (``pipeline/programs.py``) against the JAX
engine's, one program at a time, chained on rendered images.

Input: two frames (t = 0.9 s and 1.05 s) of the JAX package's synthetic
renderer on the shared test rig (two 200x150 cameras, 300 blobs, start-from-
rest trajectory), quantized to uint8. Frame A's stereo landmarks form the
map that frame B is matched against, and frame B is matched to frame A by
the temporal bootstrap. Poses: the renderer's truth, the one handed to
matching perturbed by a few cm and a degree. The RANSAC stages get the JAX
engine's draws from the same keys.

Tolerances: ``frontend_batch`` (float32 in both) with identical keypoint
``uv``/``valid``/``octave``, bit-identical descriptors, scores to 1e-5
relative, and the processed uint8 image within one grey level on < 0.1% of
its pixels (its float CLAHE values agree to 2e-6, and truncation to uint8
can split them at a level boundary). Geometry in float64: match flags and indices,
``good`` masks and the RANSAC success flags exact; triangulated points to
1e-9 m; covariances to 1e-8 of their largest entry; fitted poses to 1e-9;
the IMU programs to 1e-10 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu import sim as jsim
from svin_tpu.kinematics import Transformation as JT
from svin_tpu.kinematics import compose as jcompose
from svin_tpu.kinematics import oplus as joplus
from svin_tpu.pipeline import VioEngine as JaxEngine
from svin_tpu.pipeline.dataset import SyntheticRenderer
from svin_tpu.pipeline import vio as jvio
from svin_tpu_torch.convert import config_from_numpy
from svin_tpu_torch.estimator import rig_params
from svin_tpu_torch.kinematics import npq
from svin_tpu_torch.pipeline import VioEngine, programs
from torch_parity import assert_close, jax_draws, port_rig
from vio_fixtures import small_config, small_rig

torch.set_num_threads(1)

K = 150
OCTAVES = 2
RAY = jvio.VioEngine._RAY_SIGMA_BASE
POSE_VAR_STEREO = jvio.VioEngine._POSE_VAR_STEREO
STATIC = dict(max_keypoints=K, octaves=OCTAVES, histogram_method="CLAHE", clahe_clip_limit=2.0,
              resize_factor=1.0, clahe_tiles=8)


def t64(a):
    return torch.as_tensor(np.array(a, np.float64))


@pytest.fixture(scope="module")
def scene():
    rig = small_rig()
    renderer = SyntheticRenderer(rig, n_points=300, seed=3,
                                 traj=jsim.default_trajectory(scale=0.4, ramp_tau=0.8),
                                 spread=6.0, depth_offset=3.0)
    jeng = JaxEngine(small_config(), rig=rig)
    teng = VioEngine(config_from_numpy(small_config()), rig=port_rig(), device="cpu")
    frames = {}
    for name, t in (("A", 0.9), ("B", 1.05)):
        imgs = np.stack([np.clip(im * 255.0 + 0.5, 0, 255).astype(np.uint8)
                         for im in renderer.render_frame(t)])
        T = renderer.pose(t)
        frames[name] = dict(imgs=imgs, T=JT(r=np.asarray(T.r), q=np.asarray(T.q)))
    return dict(jeng=jeng, teng=teng, rig_p=rig_params(port_rig()), frames=frames,
                ext_r=np.asarray(jeng.window.ext_r), ext_q=np.asarray(jeng.window.ext_q))


def _gravity(T, ext_q):
    """(C,3) float32 world down in each camera (the engine's host path)."""
    return np.stack([npq.rotate(npq.conjugate(npq.multiply(T.q, qe)), np.array([0.0, 0.0, -1.0]))
                     for qe in ext_q]).astype(np.float32)


@pytest.fixture(scope="module")
def detections(scene):
    thr = np.float32(40.0 * jvio.detection.BRISK_THRESHOLD_SCALE)
    out = {}
    for name, fr in scene["frames"].items():
        g = _gravity(fr["T"], scene["ext_q"])
        want = jax.device_get(jvio._frontend_batch(jnp.asarray(fr["imgs"]), jnp.asarray(g),
                                                   jnp.asarray(thr), **STATIC))
        got = programs.frontend_batch(torch.as_tensor(fr["imgs"]), torch.as_tensor(g),
                                      float(thr), **STATIC)
        out[name] = (got, want)
    return out


def test_frontend_batch_matches_jax(detections):
    for name, (got, want) in detections.items():
        uv, d, valid, score, octv, im8 = got
        assert int(valid.sum()) > 100, name
        np.testing.assert_array_equal(valid.numpy(), want[2])
        np.testing.assert_array_equal(uv.numpy(), want[0])
        np.testing.assert_array_equal(octv.numpy(), want[4])
        np.testing.assert_array_equal(d.numpy(), np.asarray(want[1]).view(np.int32))
        np.testing.assert_allclose(score.numpy(), want[3], rtol=1e-5, atol=0)
        diff = np.abs(im8.numpy().astype(int) - want[5].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def _kp(detections, name):
    uv, d, valid, score, octv, _ = detections[name][0]
    return uv.double(), d, valid, octv


@pytest.fixture(scope="module")
def stereo(scene, detections):
    """Frame A's stereo program in both packages, with a few live map
    landmarks near true blob positions to exercise the dedup."""
    uv, d, valid, octv = _kp(detections, "A")
    T = scene["frames"]["A"]["T"]
    L = 64
    hp = np.zeros((L, 4))
    hp[:, 3] = 1.0
    lm_valid = np.zeros(L, bool)
    jeng = scene["jeng"]
    fn = jvio._make_stereo_match_tri(jeng.rig.cameras[0], jeng.rig.cameras[1], RAY, POSE_VAR_STEREO)
    er, eq = scene["ext_r"], scene["ext_q"]
    j = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731
    u32 = lambda t: jnp.asarray(t.numpy().view(np.uint32))  # noqa: E731
    want0 = jax.device_get(fn(u32(d[0]), u32(d[1]), j(valid[0]), j(valid[1]), j(uv[0]), j(uv[1]),
                              j(octv[0]), j(octv[1]), j(T.r), j(T.q), j(er[0]), j(eq[0]), j(er[1]),
                              j(eq[1]), j(hp), j(lm_valid)))
    # seed the map with 8 of the triangulated points: their pairs must dedup
    good0 = np.nonzero(want0[2])[0][:8]
    hp[:8, :3] = want0[1][good0] + 0.01
    lm_valid[:8] = True
    want = jax.device_get(fn(u32(d[0]), u32(d[1]), j(valid[0]), j(valid[1]), j(uv[0]), j(uv[1]),
                             j(octv[0]), j(octv[1]), j(T.r), j(T.q), j(er[0]), j(eq[0]), j(er[1]),
                             j(eq[1]), j(hp), j(lm_valid)))
    rig_p = scene["rig_p"]
    got = programs.stereo_match_tri(
        rig_p.camera(0), rig_p.camera(1), RAY, POSE_VAR_STEREO, d[0], d[1], valid[0], valid[1],
        uv[0], uv[1], octv[0], octv[1], t64(T.r), t64(T.q), t64(er[0]), t64(eq[0]), t64(er[1]),
        t64(eq[1]), t64(hp), torch.as_tensor(lm_valid))
    return got, want, good0


def test_stereo_match_tri_matches_jax(stereo):
    (ib, pts, good, cov), want, seeded = stereo
    np.testing.assert_array_equal(ib.numpy(), want[0])
    np.testing.assert_array_equal(good.numpy(), want[2])
    assert int(good.sum()) >= 30 and not good.numpy()[seeded].any()
    m = ib.numpy() >= 0
    assert_close(pts[m], want[1][m], rtol=0, atol=1e-9)
    g = good.numpy()
    assert_close(cov[g], want[3][g], rtol=0, atol_rel=1e-8)


@pytest.fixture(scope="module")
def map_B(scene, detections, stereo):
    """Frame B's matching inputs: frame A's good stereo points as the map."""
    (ib, pts, good, cov), _, _ = stereo
    L = 512
    g = np.nonzero(good.numpy())[0]
    hp = np.zeros((L, 4))
    hp[:, 3] = 1.0
    hp[:len(g), :3] = pts.numpy()[g]
    lm_valid = np.zeros(L, bool)
    lm_valid[:len(g)] = True
    lm_desc = np.zeros((L, 8), np.int32)
    lm_desc[:len(g)] = detections["A"][0][1][0].numpy()[g]
    lm_cov = np.tile(np.eye(3) * 0.25, (L, 1, 1))
    lm_cov[:len(g)] = cov.numpy()[g]
    uv, d, valid, octv = _kp(detections, "B")
    T = scene["frames"]["B"]["T"]
    T_pred = joplus(JT(r=jnp.asarray(T.r), q=jnp.asarray(T.q)),
                    jnp.asarray([0.03, -0.02, 0.02, 0.01, -0.015, 0.01]))
    free = np.ones(valid.shape, bool)
    free[0, :5] = False
    kp_sigma = 0.8 * np.ldexp(1.0, octv.numpy())
    return dict(hp=hp, lm_valid=lm_valid, lm_desc=lm_desc, lm_cov=lm_cov, uv=uv, d=d,
                valid=valid, octv=octv, free=free, kp_sigma=kp_sigma,
                T_pred=(np.asarray(T_pred.r), np.asarray(T_pred.q)))


@pytest.mark.parametrize("seed", [11, 12])
def test_match_stage_matches_jax(scene, map_B, seed):
    m = map_B
    er, eq = scene["ext_r"], scene["ext_q"]
    key = jax.random.PRNGKey(seed)
    want = jax.device_get(scene["jeng"]._match_stage_fn(
        m["uv"].numpy(), m["d"].numpy().view(np.uint32), m["valid"].numpy(), m["free"], m["hp"],
        m["lm_valid"], m["lm_desc"].view(np.uint32), jnp.asarray(m["lm_cov"]),
        jnp.asarray(m["T_pred"][0]), jnp.asarray(m["T_pred"][1]), jnp.asarray(er), jnp.asarray(eq),
        jnp.asarray(m["kp_sigma"]), jnp.asarray(0.01), key))
    got = programs.match_stage(
        scene["rig_p"], float(scene["jeng"].rig.cameras[0].fu), m["uv"], m["d"], m["valid"],
        torch.as_tensor(m["free"]), t64(m["hp"]), torch.as_tensor(m["lm_valid"]),
        torch.as_tensor(m["lm_desc"]), t64(m["lm_cov"]), t64(m["T_pred"][0]), t64(m["T_pred"][1]),
        t64(er), t64(eq), t64(m["kp_sigma"]), t64(0.01),
        lambda v, H, s: jax_draws(key, v.numpy(), H, s))
    accept, midx, n_cand, success, fit_r, fit_q = got
    np.testing.assert_array_equal(midx.numpy(), want[1])
    np.testing.assert_array_equal(accept.numpy(), want[0])
    assert int(n_cand) == int(want[2]) and bool(success) == bool(want[3]) is True
    assert int(accept.sum()) >= 30
    assert_close(fit_r, want[4], rtol=0, atol=1e-9)
    assert_close(fit_q, want[5], rtol=0, atol=1e-9)
    # the fitted pose is closer to the truth than the perturbed prediction
    T = scene["frames"]["B"]["T"]
    assert np.linalg.norm(fit_r.numpy() - T.r) < np.linalg.norm(m["T_pred"][0] - T.r)


def test_temporal_match_tri_matches_jax(scene, detections):
    jeng = scene["jeng"]
    fn = jvio._make_temporal_match_tri(jeng.rig.cameras[0], RAY, float(np.hypot(200, 150)))
    uvC, dC, vC, oC = _kp(detections, "B")
    uvP, dP, vP, oP = _kp(detections, "A")
    er, eq = scene["ext_r"], scene["ext_q"]
    TA = jcompose(JT(r=jnp.asarray(scene["frames"]["B"]["T"].r), q=jnp.asarray(scene["frames"]["B"]["T"].q)),
                  JT(r=jnp.asarray(er[0]), q=jnp.asarray(eq[0])))
    TB = jcompose(JT(r=jnp.asarray(scene["frames"]["A"]["T"].r), q=jnp.asarray(scene["frames"]["A"]["T"].q)),
                  JT(r=jnp.asarray(er[0]), q=jnp.asarray(eq[0])))
    hp = np.zeros((64, 4))
    hp[:, 3] = 1.0
    lm_valid = np.zeros(64, bool)
    kk = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(kk)
    u32 = lambda t: jnp.asarray(t.numpy().view(np.uint32))  # noqa: E731
    j = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731
    want = jax.device_get(fn(k1, k2, u32(dC[0]), u32(dP[0]), j(vC[0]), j(vP[0]), j(uvC[0]),
                             j(uvP[0]), j(oC[0]), j(oP[0]), TA.r, TA.q, TB.r, TB.q,
                             jnp.asarray(0.01), j(hp), j(lm_valid)))
    got = programs.temporal_match_tri(
        scene["rig_p"].camera(0), RAY, float(np.hypot(200, 150)), float(jeng.rig.cameras[0].fu),
        lambda v, H, s: jax_draws(k1, v.numpy(), H, s),
        lambda v, H, s: jax_draws(k2, v.numpy(), H, s),
        dC[0], dP[0], vC[0], vP[0], uvC[0], uvP[0], oC[0], oP[0], t64(TA.r), t64(TA.q), t64(TB.r),
        t64(TB.q), t64(0.01), t64(hp), torch.as_tensor(lm_valid))
    ib, pts, good, cov, rot_only = got
    np.testing.assert_array_equal(ib.numpy(), want[0])
    np.testing.assert_array_equal(good.numpy(), want[2])
    assert bool(rot_only) == bool(want[4])
    assert int((ib >= 0).sum()) >= 10 and int(good.sum()) >= 5
    mm = ib.numpy() >= 0
    assert_close(pts[mm], want[1][mm], rtol=1e-9, atol=1e-9)
    g = good.numpy()
    assert_close(cov[g], want[3][g], rtol=0, atol_rel=1e-8)


def test_preint_prop_and_gravity_match_jax(scene):
    jeng = scene["jeng"]
    rng = np.random.default_rng(0)
    n = 64
    ts = np.concatenate([0.5 + np.arange(18) * 0.01, np.full(n - 18, 0.5 + 17 * 0.01)])
    mask = np.arange(n) < 18
    gy = rng.normal(size=(n, 3)) * 0.3
    ac = rng.normal(size=(n, 3)) + np.array([0, 0, 9.81])
    T = scene["frames"]["A"]["T"]
    sb = np.concatenate([[0.2, -0.1, 0.05], rng.normal(size=6) * 0.01])
    want = jax.device_get(jeng._preint_prop_fn(ts, gy, ac, mask, 0.505, 0.66, T.r, T.q, sb))
    got = programs.preint_prop(t64(ts), t64(gy), t64(ac), torch.as_tensor(mask), t64(0.505),
                               t64(0.66), t64(T.r), t64(T.q), t64(sb), jeng.cfg.imu)
    pre, T_pred, sb_pred, W = got
    jpre, jT, jsb, jW = want
    for a, b in zip(pre, jpre):
        assert_close(a, b, rtol=1e-10, atol_rel=1e-12)
    assert_close(T_pred.r, jT.r, rtol=1e-10)
    assert_close(T_pred.q, jT.q, rtol=1e-10)
    assert_close(sb_pred, jsb, rtol=1e-10)
    assert_close(W, jW, rtol=1e-8, atol_rel=1e-10)
    g = programs.gravity_dirs(t64(T.q), t64(scene["ext_q"]))
    assert_close(g, jax.device_get(jeng._gravity_fn(jnp.asarray(T.q), jnp.asarray(scene["ext_q"]))),
                 rtol=1e-12)


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    """``VioEngine`` without a device runs on ``cuda``: where there is no
    card it raises rather than falling back to the CPU; ``device="cpu"``
    is the explicit way to run there."""
    cfg = config_from_numpy(small_config())
    if torch.cuda.is_available():
        assert VioEngine(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            VioEngine(cfg, rig=port_rig())
        with pytest.raises(RuntimeError, match="CUDA"):
            VioEngine(cfg, device="cuda")
    eng = VioEngine(cfg, rig=port_rig(), device="cpu")
    assert eng.device.type == "cpu" and eng.dtype == torch.float64
