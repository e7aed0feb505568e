"""Synthetic window problems for tests and the chip check.

Counterpart of the JAX package's ``problems.py`` (``euroc_like_rig``,
``build_window_problem``), with random draws from an explicit
``numpy.random.Generator`` (the JAX package draws from ``jax.random``, so the
two builders give different noise for the same seed; the parity tests feed
both packages the JAX builder's problem through ``convert``). Beyond the JAX
builder, ``attach_depth_and_sonar`` adds the water-depth and sonar-range
factors the engine attaches from its sensor buffers, and ``make_frame``
synthesises one frame of keypoints for the map matcher. For the scalable
solvers: ``build_global_ba_problem`` (the global BA problem of the JAX
builder, numpy-seeded) and ``closer_drive`` (a long loop-closing session as
image-free keyframe exports, the JAX loop-closer scale test's drive).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import sim
from .cameras import NCameraSystem, make_camera, project
from .convert import tree_to
from .estimator import WindowConfig, empty_factors, empty_window, rig_params
from .imu import ImuParameters, preintegrate, sqrt_information
from .kinematics import Transformation, compose, from_rq, inverse, transform_point, quaternion as quat

IMU_PARAMS = ImuParameters()


def euroc_like_rig(dtype=torch.float64, device=None) -> NCameraSystem:
    """Two 752x480 radial-tangential cameras, 11 cm stereo baseline."""
    cam = make_camera(
        752, 480, 458.654, 457.296, 367.215, 248.375,
        dist_params=[-0.2834, 0.0739, 0.00019, 1.76e-05], dtype=dtype, device=device,
    )
    rig = NCameraSystem()
    rig.add_camera(from_rq([0.0, 0.0, 0.0], [0, 0, 0, 1], dtype, device), cam)
    rig.add_camera(from_rq([0.11, 0.0, 0.0], [0, 0, 0, 1], dtype, device), cam)
    return rig


def _imu_slice(ts: np.ndarray, t0: float, t1: float) -> slice:
    """Samples whose segments overlap (t0, t1): every other segment leaves
    the preintegral unchanged, so integrating the slice is exact."""
    first = max(int(np.searchsorted(ts, t0, side="right")) - 1, 0)
    last = int(np.searchsorted(ts, t1, side="left")) - 1
    return slice(first, max(last + 2, first + 1))


def build_window_problem(
    rng: np.random.Generator,
    cfg: WindowConfig,
    n_landmarks: int = 64,
    dt_state: float = 0.4,
    pix_noise: float = 0.4,
    lm_perturb: float = 0.05,
    state_perturb: float = 0.02,
    imu_rate: float = 200.0,
    imu_noisy: bool = True,
    dtype=torch.float64,
    device=None,
):
    """Synthetic filled (window, factors, rig_params, truth): S states along
    the analytic trajectory, a landmark box ahead of the middle state,
    every in-image projection observed with pixel noise, IMU factors from a
    simulated (noisy) series, and a gauge prior on the first state."""
    S = cfg.num_states
    kw = dict(dtype=dtype, device=device)
    traj = sim.default_trajectory(**kw)
    rig = euroc_like_rig(**kw)
    rig_p = rig_params(rig, **kw)

    times = torch.arange(S, **kw) * dt_state + 0.3
    T_gt = sim.pose(traj, times)  # batched (S,...)
    v_gt = sim.velocity(traj, times)

    T_mid = Transformation(r=T_gt.r[S // 2], q=T_gt.q[S // 2])
    center = transform_point(T_mid, torch.tensor([0.0, 0.0, 4.0], **kw))
    lms = sim.landmark_grid(rng, n_landmarks, center, torch.tensor([8.0, 8.0, 4.0], **kw))

    window = empty_window(cfg, dtype, rig=rig_p, device=device)
    factors = empty_factors(cfg, dtype, device=device)

    r0, q0 = T_gt.r, T_gt.q
    sb0 = torch.cat([v_gt, torch.zeros((S, 6), **kw)], dim=1)
    dp = state_perturb * torch.as_tensor(rng.standard_normal((S, 3)), **kw)
    da = state_perturb * torch.as_tensor(rng.standard_normal((S, 3)), **kw)
    dp[0] = 0.0
    da[0] = 0.0
    window = window._replace(
        r=r0 + dp,
        q=quat.normalize(quat.multiply(quat.exp(da), q0)),
        speed_bias=sb0.clone(),
        state_valid=torch.ones(S, dtype=torch.bool, device=device),
        is_keyframe=torch.ones(S, dtype=torch.bool, device=device),
        timestamp=times.clone(),
        state_id=torch.arange(S, dtype=torch.int32, device=device),
    )

    L = cfg.num_landmarks
    n_lm = min(n_landmarks, L)
    lm_noise = lm_perturb * torch.as_tensor(rng.standard_normal((n_lm, 3)), **kw)
    hp = window.hp_W.clone()
    hp[:n_lm, :3] = lms[:n_lm] + lm_noise
    lm_valid = window.lm_valid.clone()
    lm_valid[:n_lm] = True
    lm_id = window.lm_id.clone()
    lm_id[:n_lm] = torch.arange(n_lm, dtype=torch.int32, device=device)
    window = window._replace(hp_W=hp, lm_valid=lm_valid, lm_id=lm_id)

    obs_s, obs_l, obs_c, obs_uv = [], [], [], []
    for s in range(S):
        T_WS = Transformation(r=r0[s], q=q0[s])
        for c in range(rig.num_cameras):
            p_C = transform_point(inverse(compose(T_WS, rig.T_SC[c])), lms[:n_lm])
            uv, valid = project(rig.cameras[c], p_C)
            idx = torch.nonzero(valid).reshape(-1)
            obs_s += [s] * len(idx)
            obs_c += [c] * len(idx)
            obs_l.append(idx)
            obs_uv.append(uv[idx])
    obs_l = torch.cat(obs_l)
    obs_uv = torch.cat(obs_uv)
    noise = pix_noise * torch.as_tensor(rng.standard_normal((len(obs_s), 2)), **kw)
    n_obs = min(len(obs_s), cfg.num_obs)
    f = factors.reproj
    uv_t, si, li, ci = f.uv.clone(), f.state_idx.clone(), f.lm_idx.clone(), f.cam_idx.clone()
    sq, ok = f.sqrt_info.clone(), f.valid.clone()
    uv_t[:n_obs] = obs_uv[:n_obs] + noise[:n_obs]
    si[:n_obs] = torch.tensor(obs_s[:n_obs], dtype=torch.int32, device=device)
    li[:n_obs] = obs_l[:n_obs].to(torch.int32)
    ci[:n_obs] = torch.tensor(obs_c[:n_obs], dtype=torch.int32, device=device)
    sq[:n_obs] = 1.0 / max(pix_noise, 0.3)
    ok[:n_obs] = True
    f = f._replace(uv=uv_t, state_idx=si, lm_idx=li, cam_idx=ci, sqrt_info=sq, valid=ok)

    series = sim.simulate_imu(
        traj, float(times[0]) - 0.05, float(times[-1]) + 0.05, imu_rate,
        IMU_PARAMS, rng=rng, noisy=imu_noisy,
    )
    ts_np = series.t.cpu().numpy()
    pres = []
    for k in range(S - 1):
        t0, t1 = times[k], times[k + 1]
        sl = _imu_slice(ts_np, float(t0), float(t1))
        pres.append(preintegrate(
            series.t[sl], series.gyro[sl], series.acc[sl],
            torch.ones(series.t[sl].shape, dtype=torch.bool, device=device),
            t0, t1, torch.zeros(6, **kw), IMU_PARAMS,
        ))
    pre_b = type(pres[0])(*(torch.stack(xs) for xs in zip(*pres)))
    imu = factors.imu._replace(
        pre=pre_b, sqrt_info=sqrt_information(pre_b),
        valid=torch.ones(S - 1, dtype=torch.bool, device=device),
    )

    pr = factors.priors
    pose_si = pr.pose_sqrt_info.clone()
    pose_si[0] = torch.diag(torch.tensor([1e4, 1e4, 1e4, 5.0, 5.0, 1e4], **kw))
    sb_si = pr.sb_sqrt_info.clone()
    sb_si[0] = torch.diag(torch.tensor(
        [10.0] * 3 + [1.0 / IMU_PARAMS.sigma_bg] * 3 + [1.0 / IMU_PARAMS.sigma_ba] * 3, **kw))
    first = (torch.arange(S, device=device) == 0)
    pr = pr._replace(
        pose_mean_r=torch.where(first[:, None], r0, pr.pose_mean_r),
        pose_mean_q=torch.where(first[:, None], q0, pr.pose_mean_q),
        pose_sqrt_info=pose_si,
        pose_valid=first.clone(),
        sb_mean=torch.where(first[:, None], sb0, pr.sb_mean),
        sb_sqrt_info=sb_si,
        sb_valid=first.clone(),
    )

    factors = factors._replace(reproj=f, imu=imu, priors=pr)
    truth = {"r": r0, "q": q0, "sb": sb0, "lms": lms[:n_lm], "times": times, "rig": rig}
    return window, factors, rig_p, truth


def attach_depth_and_sonar(factors, truth: dict, window, sonar_slots: Sequence[int],
                           rng: np.random.Generator, depth_noise: float = 0.01,
                           range_noise: float = 0.02):
    """Depth factor on every state and sonar-range factors on
    ``sonar_slots``, from the synthetic truth — what the engine attaches
    from its pressure and sonar buffers: depth = first_depth − z_WS with
    first_depth = 0, and the range from the true position to the landmark
    nearest it, with that landmark's window estimate as the target."""
    r_true = truth["r"]
    S = r_true.shape[0]
    kw = dict(dtype=r_true.dtype, device=r_true.device)
    dep = factors.depth
    depth = -r_true[:, 2] + depth_noise * torch.as_tensor(rng.standard_normal(S), **kw)
    dep = dep._replace(
        depth=depth,
        first_depth=torch.zeros((), **kw),
        valid=window.state_valid.clone(),
    )
    so = factors.sonar
    rng_t, tgt, val = so.range.clone(), so.target_W.clone(), so.valid.clone()
    for s in sonar_slots:
        d = torch.linalg.norm(truth["lms"] - r_true[s], dim=-1)
        l = int(torch.argmin(d))
        tgt[s] = window.hp_W[l, :3]
        rng_t[s] = d[l] + range_noise * float(rng.standard_normal())
        val[s] = True
    so = so._replace(range=rng_t, target_W=tgt, valid=val)
    return factors._replace(depth=dep, sonar=so)


def build_global_ba_problem(rng: np.random.Generator = None, K: int = 64, L: int = 4096,
                            O: int = 16384, dtype=torch.float32, device=None):
    """Synthetic global bundle-adjustment problem (fixed shapes): K poses
    along the analytic trajectory over 4 s, L landmarks in a box, O
    observation slots (slot o: pose o % K, camera (o // K) % C, a random
    landmark; invalid where the projection misses). The poses and landmarks
    are the truth. Returns (``parallel.GlobalMapProblem``, rig params), on
    ``cuda`` unless another device is named (raises without a card)."""
    from .parallel import GlobalMapProblem

    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_global_ba_problem: no CUDA device; pass device='cpu'")
    rng = np.random.default_rng(0) if rng is None else rng
    rig = euroc_like_rig(device=dev)
    rig_p = rig_params(rig, dtype, dev)
    C = rig.num_cameras
    T = sim.pose(sim.default_trajectory(device=dev),
                 torch.arange(K, dtype=torch.float64, device=dev) * (4.0 / K) + 0.1)
    pose_r, pose_q = T.r.to(dtype), T.q.to(dtype)
    lms = sim.landmark_grid(rng, L, torch.tensor([0.5, 0.5, 5.0], device=dev),
                            torch.tensor([10.0, 10.0, 4.0], device=dev)).to(dtype)
    o = torch.arange(O, device=dev)
    obs_pose, obs_cam = o % K, (o // K) % C
    obs_lm = torch.as_tensor(rng.integers(0, L, O), device=dev)
    T_WC = compose(Transformation(r=pose_r[obs_pose], q=pose_q[obs_pose]),
                   Transformation(r=rig_p.T_SC_r[obs_cam], q=rig_p.T_SC_q[obs_cam]))
    p_C = transform_point(inverse(T_WC), lms[obs_lm])
    uv, ok = project(tree_to(rig.cameras[0], dev, dtype), p_C)  # both cameras share intrinsics
    ok = ok & (p_C[:, 2] > 0.5)
    prob = GlobalMapProblem(
        pose_r=pose_r, pose_q=pose_q, pose_fixed=torch.arange(K, device=dev) < 2,
        lm=lms, lm_valid=torch.ones(L, dtype=torch.bool, device=dev),
        obs_uv=torch.where(ok[:, None], uv, torch.zeros_like(uv)), obs_pose=obs_pose,
        obs_lm=obs_lm, obs_cam=obs_cam, obs_valid=ok)
    return prob, rig_p


class Frame(NamedTuple):
    """One frame's matcher inputs (C cameras x K keypoints) plus the map-side
    tables the matcher reads beside the window."""

    uv: torch.Tensor  # (C,K,2) keypoint pixels
    desc: torch.Tensor  # (C,K,W) int32 packed descriptors
    valid: torch.Tensor  # (C,K) bool
    sigma: torch.Tensor  # (C,K) per-keypoint pixel std
    pos_var: torch.Tensor  # () pose translation variance [m²]
    T_WS_r: torch.Tensor  # (3,) predicted pose
    T_WS_q: torch.Tensor  # (4,)
    lm_desc: torch.Tensor  # (L,W) int32 landmark descriptors
    lm_cov: torch.Tensor  # (L,3,3) landmark position covariance [m²]


def random_descriptors(rng: np.random.Generator, n: int, words: int = 8) -> np.ndarray:
    """(n, words) int32 views of uniformly random 32-bit words."""
    return rng.integers(0, 2**32, size=(n, words), dtype=np.uint64).astype(np.uint32).view(np.int32)


def _flip_bits(rng: np.random.Generator, d: np.ndarray, nbits: int) -> np.ndarray:
    """The 8-word descriptor ``d`` (uint32) with ``nbits`` distinct random bits flipped."""
    out = d.copy()
    for bit in rng.choice(256, size=nbits, replace=False):
        out[bit // 32] ^= np.uint32(1 << (bit % 32))
    return out


def matcher_case(rng: np.random.Generator, cams: int = 2, na: int = 40, nb: int = 50,
                 keep: float = 0.8):
    """Inputs for the descriptor matcher with every rule planted: a batch of
    ``cams`` cameras' keypoints (cams, na, 8) against a shared table (nb, 8)
    (int32 words), valid flags (cams, na) and (nb,), and a pair mask (cams,
    na, nb) keeping a ``keep`` share of pairs. Half the keypoints are noisy
    copies of table rows (0-69 bits flipped, around the threshold of 60);
    table rows 5 and 6 are identical, and keypoint 0 is near them (a row
    tie: the lowest column wins); keypoints 1 and 2 are both exact copies
    of table row 9 (a column tie: the lowest row wins); about 10% of
    keypoints and table rows are invalid; keypoint 7's row and table column
    11 are fully masked. Needs na >= 8 and nb >= 12."""
    u32 = lambda n: rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)  # noqa: E731
    b = u32(nb)
    b[6] = b[5]
    a = np.stack([np.concatenate([
        np.stack([_flip_bits(rng, b[j], int(rng.integers(0, 70)))
                  for j in rng.choice(nb, size=na // 2, replace=na // 2 > nb)]).reshape(-1, 8),
        u32(na - na // 2)]) for _ in range(cams)])
    a[:, 0] = _flip_bits(rng, b[5], 4)
    a[:, 1] = a[:, 2] = b[9]
    va = rng.uniform(size=(cams, na)) < 0.9
    vb = rng.uniform(size=nb) < 0.9
    va[:, :3] = True
    vb[[5, 6, 9]] = True
    mask = rng.uniform(size=(cams, na, nb)) < keep
    mask[:, :3] = True
    mask[:, 7] = False
    mask[:, :, 11] = False
    return a.view(np.int32), b.view(np.int32), va, vb, mask


# the engine's three matchers at the shipped shapes (400 keypoints per
# camera): (cameras, keypoints, table rows, share of pairs the mask keeps or
# None for no mask). map: both cameras' keypoints against the landmark
# table, gated; stereo: camera 0 against camera 1, no mask; temporal:
# against the last keyframe under the optical-flow mask
MATCHER_SHAPES = {"map": (2, 400, 512, 0.3), "stereo": (1, 400, 400, None),
                  "temporal": (1, 400, 400, 0.5)}


def matcher_inputs(kind: str, rng: np.random.Generator, device=None) -> tuple:
    """``matcher_case`` at one matcher's shape (``MATCHER_SHAPES``) as
    tensors on ``device``, in the form the engine passes them: (a, b,
    valid_a, valid_b, mask), 2-D for the stereo and temporal matchers, and
    mask None where the matcher has none."""
    cams, na, nb, keep = MATCHER_SHAPES[kind]
    a, b, va, vb, mask = (torch.as_tensor(x, device=device)
                          for x in matcher_case(rng, cams=cams, na=na, nb=nb, keep=keep or 1.0))
    if cams == 1:
        a, va, mask = a[0], va[0], mask[0].contiguous()
    return a, b, va, vb, None if keep is None else mask


def make_frame(rng: np.random.Generator, window, truth: dict, rig_p, lm_desc: np.ndarray,
               slot: int, K: int = 400, pix_noise: float = 0.5, flip_bits: int = 4,
               pos_var: float = 1e-2, lm_cov_var: float = 0.25):
    """Keypoints of state ``slot``: the in-image projections of the valid
    landmarks (true positions, true pose) with pixel noise and descriptors
    equal to the landmark's with ``flip_bits`` random bits flipped, padded to
    K per camera with random distractors. Returns (Frame, truth_idx (C,K)
    int64: the landmark slot behind each keypoint, -1 for distractors).
    The predicted pose is the window's estimate of the slot."""
    dtype, device = window.r.dtype, window.r.device
    C = rig_p.num_cameras
    L, W = lm_desc.shape
    lms = truth["lms"]
    n_lm = lms.shape[0]
    T_WS = Transformation(r=truth["r"][slot], q=truth["q"][slot])
    uv_all = np.zeros((C, K, 2))
    desc_all = np.zeros((C, K, W), np.int32)
    tidx = np.full((C, K), -1, np.int64)
    lm_valid = window.lm_valid[:n_lm].cpu().numpy()
    for c in range(C):
        T_SC = Transformation(r=rig_p.T_SC_r[c], q=rig_p.T_SC_q[c])
        p_C = transform_point(inverse(compose(T_WS, T_SC)), lms)
        uv, ok = project(rig_p.camera(c), p_C)
        ok = ok.cpu().numpy() & lm_valid
        idx = np.nonzero(ok)[0][:K]
        n = len(idx)
        uv_all[c, :n] = uv.cpu().numpy()[idx] + pix_noise * rng.standard_normal((n, 2))
        d = lm_desc[idx].view(np.uint32).copy()
        for j in range(n):
            for bit in rng.choice(W * 32, size=flip_bits, replace=False):
                d[j, bit // 32] ^= np.uint32(1 << int(bit % 32))
        desc_all[c, :n] = d.view(np.int32)
        tidx[c, :n] = idx
        m = K - n
        uv_all[c, n:] = rng.uniform(size=(m, 2)) * [rig_p.width - 1, rig_p.height - 1]
        desc_all[c, n:] = random_descriptors(rng, m, W)
    kw = dict(dtype=dtype, device=device)
    frame = Frame(
        uv=torch.as_tensor(uv_all, **kw),
        desc=torch.as_tensor(desc_all, device=device),
        valid=torch.ones((C, K), dtype=torch.bool, device=device),
        sigma=torch.full((C, K), 0.8, **kw),
        pos_var=torch.tensor(pos_var, **kw),
        T_WS_r=window.r[slot].clone(),
        T_WS_q=window.q[slot].clone(),
        lm_desc=torch.as_tensor(lm_desc, device=device),
        lm_cov=(lm_cov_var * torch.eye(3, **kw)).repeat(L, 1, 1),
    )
    return frame, tidx


def _random_desc(rng: np.random.RandomState, n: int) -> np.ndarray:
    return rng.randint(0, 2**32, size=(n, 8)).astype(np.uint32)


def keyframe_export(i, t, r, q, *, points_W=None, uv=None, window_desc=None, extra_desc=None,
                    extra_uv=None, covis=None, sequence=0, rng=None) -> dict:
    """An image-free keyframe export for ``LoopCloser.add_keyframe`` (the
    precomputed-descriptor payload): 30 window landmarks in a box ahead of
    the camera and 120 fresh corners, random descriptors from ``rng``
    (``RandomState(i)`` by default) unless given."""
    rng = rng if rng is not None else np.random.RandomState(i)
    n_pts = 30 if points_W is None else len(points_W)
    if points_W is None:
        points_W = rng.rand(n_pts, 3) * 4 + np.array([0, 0, 3.0])
    if uv is None:
        uv = rng.rand(n_pts, 2) * np.array([200.0, 150.0])
    if window_desc is None:
        window_desc = _random_desc(rng, n_pts)
    if extra_desc is None:
        extra_desc = _random_desc(rng, 120)
    if extra_uv is None:
        extra_uv = rng.rand(len(extra_desc), 2) * np.array([200.0, 150.0])
    return {
        "kf_index": i, "timestamp": float(t), "T_WC_r": np.asarray(r, float),
        "T_WC_q": np.asarray(q, float), "points_W": np.asarray(points_W, float),
        "keypoints_uv": np.asarray(uv, float), "window_desc": window_desc,
        "extra_desc": extra_desc, "extra_uv": np.asarray(extra_uv, np.float32),
        "extra_valid": np.ones(len(extra_desc), bool),
        "point_covisibilities": covis if covis is not None else [], "sequence": sequence,
        "quality": np.ones(n_pts),
    }


def closer_drive(cam, n: int, loop_dst_start: int, radius: float):
    """A long loop-closing session as image-free keyframe exports: ``n``
    keyframes on a circle of ``radius`` m whose VIO positions drift linearly
    to [6, -4, 1.5] m, keyframes 6..15 revisited from ``loop_dst_start`` on
    (the same world points, in the drifted frame, with the descriptors the
    early keyframe saw as fresh corners). ``cam`` is the closer's camera.
    Returns (exports, true positions, VIO positions)."""
    loop_src = list(range(6, 16))
    th = np.linspace(0, 2 * np.pi, loop_dst_start, endpoint=False)
    circ = np.stack([radius * np.cos(th), radius * np.sin(th), np.zeros_like(th)], 1)
    pos_true = np.concatenate([circ, circ[: n - loop_dst_start]])
    drift = np.linspace(0, 1, n)[:, None] * np.array([6.0, -4.0, 1.5])
    pos_vio = pos_true + drift
    q_id = np.array([0.0, 0.0, 0.0, 1.0])

    def pixels(p_C):
        uv, ok = project(cam, torch.as_tensor(p_C, dtype=cam.fu.dtype, device=cam.fu.device))
        return uv.cpu().numpy(), bool(ok.all())

    site = {}
    for src in loop_src:
        rngs = np.random.RandomState(5000 + src)
        pts = (pos_true[src] + np.array([-1.0, -0.8, 4.0])
               + rngs.rand(60, 3) * np.array([2.0, 1.6, 1.5]))
        uv, ok = pixels(pts - pos_true[src])  # the early camera at identity rotation
        if not ok:
            raise ValueError("closer_drive: a loop site leaves the camera's image")
        site[src] = (pts, uv, _random_desc(rngs, 60))
    exports = []
    for i in range(n):
        rng = np.random.RandomState(10_000 + i)
        k = i - loop_dst_start
        if i in site:
            _, uv, desc = site[i]
            e = keyframe_export(i, i, pos_vio[i], q_id, extra_desc=desc, extra_uv=uv, rng=rng)
        elif 0 <= k < len(loop_src):
            pts, _, desc = site[loop_src[k]]
            uv_cur, _ = pixels(pts - pos_true[i])
            e = keyframe_export(i, i, pos_vio[i], q_id, points_W=pts + drift[i],
                                uv=uv_cur.astype(float), window_desc=desc, rng=rng)
        else:
            e = keyframe_export(i, i, pos_vio[i], q_id, rng=rng)
        exports.append(e)
    return exports, pos_true, pos_vio
