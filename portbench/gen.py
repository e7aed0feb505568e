"""The benchmark's sensor generator: trajectory, IMU, scene, renderer, events.

A frozen copy of the port's synthetic sequence (``sim.py`` and
``pipeline/dataset.py::SyntheticRenderer``), rewritten so that a whole
sequence renders in a few batched calls on the card. It imports nothing of
the program, so a later change to the program cannot move the yardstick.

- Trajectory: the closed form of ``sim.default_trajectory`` (sinusoids in
  position and in the rotation vector, a C2 start-from-rest ramp), with a
  forward speed in place of its drift term. Velocity, acceleration and the
  body rate are written out analytically; the IMU is sampled from them, with
  white noise of density ``sigma_*_c`` from the rig's IMU model.
- Scene: Gaussian blobs on a jittered grid in a box over the path (the
  rendered landmarks), each with a brightness and an anisotropic shape, and
  a slab of sonar targets below the path that no camera sees.
- Renderer: every blob whose centre projects (radial-tangential model)
  within reach of the image splats its Gaussian, cut at r^2 < 60 sigma^2, as
  the port's renderer does; the splats of a batch of frames are summed by
  one integer scatter-add in fixed point, exact in any order. Images are
  quantized to uint8, as a camera delivers them.
- Laps: a trajectory without forward speed is periodic in ``lap_s`` once
  the ramp is over, so one lap is rendered and its images are replayed with
  new timestamps; the IMU is sampled over the whole sequence.
- Prior map: a mix with ``prior_keyframes`` hands the closer a prior
  session's keyframes along the mix's own path from the first frame past
  the ramp (``build_prior``). A lap mix draws them from its one lap; a mix
  without ``lap_s`` lays them along the path as far as they reach, past the
  window's frames where needed (those rendered for cam0 alone), and its
  window then flies the start of that path again.

Everything random comes from ``numpy.random.default_rng`` streams: the
scene's places from the mix's ``scene_seed``, the blobs' looks (dealt from
one fixed set) and the IMU noise from ``--seed``. So the same seed gives the
same sequence on any machine, and every seed the same geometry.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np

SPLAT_CUT = 60.0  # blobs splat where r^2 < 60 sigma^2 (the port's renderer)
BLOB_SIGMA = 1.6  # px
MIN_DEPTH = 0.1  # m, a blob nearer the camera plane is not drawn
GRAVITY_DIR = np.array([0.0, 0.0, 1.0])  # f = C_SW (a_W + g e_z)


# ------------------------------------------------------------------ rig
@dataclass
class Camera:
    width: int
    height: int
    fu: float
    fv: float
    cu: float
    cv: float
    dist: np.ndarray  # radial-tangential k1, k2, p1, p2
    T_SC: np.ndarray  # (4, 4) camera in the body frame

    def max_r2(self) -> float:
        """The largest normalized r^2 inside which the radial model stays
        monotonic (beyond it, points far outside the field of view fold
        back into the image); capped by the image's own corners."""
        k1, k2 = float(self.dist[0]), float(self.dist[1])
        r = np.linspace(1e-3, 3.0, 3000)
        rd = r * (1 + k1 * r * r + k2 * r ** 4)
        bad = np.nonzero(np.diff(rd) <= 0)[0]
        r_mono = r[bad[0]] if bad.size else r[-1]
        corner = math.hypot(max(self.cu, self.width - self.cu) / self.fu,
                            max(self.cv, self.height - self.cv) / self.fv)
        return float(min(r_mono, 1.5 * corner) ** 2)


@dataclass
class Rig:
    cameras: List[Camera]
    cam_rate: float
    imu_rate: float
    sigma_g_c: float
    sigma_a_c: float
    g: float
    T_SSo: np.ndarray
    depth: bool
    sonar: bool


def load_rig(cfg: dict) -> Rig:
    """The rig of a configuration file (the OpenCV-YAML keys, as JSON)."""
    cams = []
    for c in cfg["cameras"]:
        w, h = c["image_dimension"]
        cams.append(Camera(int(w), int(h), *map(float, c["focal_length"]),
                           *map(float, c["principal_point"]),
                           dist=np.asarray(c["distortion_coefficients"], float),
                           T_SC=np.asarray(c["T_SC"], float).reshape(4, 4)))
        if c.get("distortion_type", "radialtangential") != "radialtangential":
            raise ValueError("the generator renders radial-tangential cameras only")
    imu = cfg.get("imu_params", {})
    return Rig(
        cameras=cams, cam_rate=float(cfg.get("camera_params", {}).get("camera_rate", 20)),
        imu_rate=float(imu.get("imu_rate", 100)), sigma_g_c=float(imu.get("sigma_g_c", 12e-4)),
        sigma_a_c=float(imu.get("sigma_a_c", 8e-3)), g=float(imu.get("g", 9.81)),
        T_SSo=np.asarray(cfg.get("sonar_params", {}).get("T_SSo", np.eye(4).ravel()),
                         float).reshape(4, 4),
        depth=bool(cfg.get("isDepthUsed", False)), sonar=bool(cfg.get("isSonarUsed", False)),
    )


# ------------------------------------------------------------- rotations
def skew(v: np.ndarray) -> np.ndarray:
    z = np.zeros(v.shape[:-1])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([np.stack([z, -w, y], -1), np.stack([w, z, -x], -1),
                     np.stack([-y, x, z], -1)], -2)


def _so3_coeffs(phi: np.ndarray):
    th2 = np.sum(phi * phi, -1)[..., None, None]
    th = np.sqrt(th2)
    small = th2 < 1e-12
    ths = np.where(small, 1.0, th)
    a = np.where(small, 1.0 - th2 / 6.0, np.sin(ths) / ths)
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(ths)) / (ths * ths))
    c = np.where(small, 1.0 / 6.0 - th2 / 120.0, (ths - np.sin(ths)) / (ths ** 3))
    return a, b, c


def exp_so3(phi: np.ndarray) -> np.ndarray:
    """Rotation matrices of rotation vectors (..., 3) (Rodrigues)."""
    a, b, _ = _so3_coeffs(phi)
    K = skew(phi)
    return np.eye(3) + a * K + b * (K @ K)


def right_jacobian(phi: np.ndarray) -> np.ndarray:
    """J_r(phi): R(phi)^T dR/dt = [J_r(phi) dphi/dt]x."""
    _, b, c = _so3_coeffs(phi)
    K = skew(phi)
    return np.eye(3) - b * K + c * (K @ K)


def yaw_of(R: np.ndarray) -> np.ndarray:
    """Yaw of the Z-Y-X Euler decomposition, atan2(R10, R00)."""
    return np.arctan2(R[..., 1, 0], R[..., 0, 0])


# ------------------------------------------------------------ trajectory
@dataclass
class Trajectory:
    """p(t) = e(t) (A sin(w t) + v t), phi(t) = e(t) B sin(W t): the port's
    ``sim.default_trajectory`` with ``scale`` on A and a forward speed v."""

    scale: float = 0.4
    speed: tuple = (0.0, 0.0, 0.0)
    ramp_tau: float = 0.8

    def __post_init__(self):
        two_pi = 2 * math.pi
        self.A = np.array([1.0, 0.8, 0.4]) * self.scale
        self.w = np.array([0.4, 0.3, 0.5]) * two_pi
        self.v = np.asarray(self.speed, float)
        self.B = np.array([0.2, 0.25, 0.3])
        self.W = np.array([0.3, 0.4, 0.2]) * two_pi

    def _env(self, t):
        t = np.asarray(t, float)[..., None]
        if self.ramp_tau <= 0:
            return np.ones_like(t), np.zeros_like(t), np.zeros_like(t)
        x = t / self.ramp_tau
        s = np.clip(x, 0.0, 1.0)
        inside = ((x > 0) & (x < 1)).astype(float)
        e = s ** 3 * (s * (6 * s - 15) + 10)
        de = inside * 30 * s * s * (s - 1) ** 2 / self.ramp_tau
        dde = inside * (120 * s ** 3 - 180 * s ** 2 + 60 * s) / self.ramp_tau ** 2
        return e, de, dde

    def position(self, t):
        e, _, _ = self._env(t)
        tt = np.asarray(t, float)[..., None]
        return e * (self.A * np.sin(self.w * tt) + self.v * tt)

    def acceleration(self, t):
        e, de, dde = self._env(t)
        tt = np.asarray(t, float)[..., None]
        f = self.A * np.sin(self.w * tt) + self.v * tt
        df = self.A * self.w * np.cos(self.w * tt) + self.v
        ddf = -self.A * self.w ** 2 * np.sin(self.w * tt)
        return dde * f + 2 * de * df + e * ddf

    def rotvec(self, t):
        e, de, _ = self._env(t)
        tt = np.asarray(t, float)[..., None]
        g = self.B * np.sin(self.W * tt)
        return e * g, de * g + e * self.B * self.W * np.cos(self.W * tt)

    def pose(self, t):
        """(R_WS (..., 3, 3), p_WS (..., 3)) at times t."""
        return exp_so3(self.rotvec(t)[0]), self.position(t)

    def imu(self, t, g: float):
        """Noise-free (gyro, specific force) in the body frame at times t."""
        phi, dphi = self.rotvec(t)
        gyro = (right_jacobian(phi) @ dphi[..., None])[..., 0]
        R = exp_so3(phi)
        acc = (np.swapaxes(R, -1, -2) @ (self.acceleration(t) + g * GRAVITY_DIR)[..., None])[..., 0]
        return gyro, acc


def camera_poses(rig: Rig, R_WS: np.ndarray, p_WS: np.ndarray, ci: int):
    """(R_WC, p_WC) of camera ``ci`` at body poses (..., 3, 3), (..., 3)."""
    T = rig.cameras[ci].T_SC
    return R_WS @ T[:3, :3], (R_WS @ T[:3, 3][:, None])[..., 0] + p_WS


def project(cam: Camera, p_C):
    """(uv (..., 2), in front and inside the monotonic part of the model) of
    camera-frame points, NumPy arrays or torch tensors alike."""
    xp = np if isinstance(p_C, np.ndarray) else __import__("torch")
    z = p_C[..., 2]
    zs = xp.where(z > MIN_DEPTH, z, xp.ones_like(z))
    x, y = p_C[..., 0] / zs, p_C[..., 1] / zs
    k1, k2, p1, p2 = (float(v) for v in cam.dist)
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    uv = xp.stack([cam.fu * xd + cam.cu, cam.fv * yd + cam.cv], -1)
    return uv, (z > MIN_DEPTH) & (r2 < cam.max_r2())


# ------------------------------------------------------------------ scene
@dataclass
class Scene:
    points: np.ndarray  # (N, 3) blob centres
    brightness: np.ndarray  # (N,)
    icov: np.ndarray  # (N, 3): a, b, c of the blob's inverse covariance (px^-2)
    sonar_points: np.ndarray  # (M, 3), seen by the sonar only


def make_scene(rng: np.random.Generator, lo: np.ndarray, hi: np.ndarray, density: float,
               sonar_z: tuple, sonar_density: float) -> Scene:
    """Blobs on a jittered grid of ``density`` per m^3 (one at a random spot
    of each cell, so that every seed fills every view alike), and sonar
    targets uniform in a slab of the same plan."""
    cell = density ** (-1.0 / 3.0)
    n_ax = np.maximum(1, np.floor((hi - lo) / cell).astype(int))
    step = (hi - lo) / n_ax
    grid = np.stack(np.meshgrid(*[np.arange(k) for k in n_ax], indexing="ij"), -1).reshape(-1, 3)
    pts = lo + (grid + rng.uniform(size=grid.shape)) * step
    n = len(pts)
    bright = 0.35 + 0.65 * rng.uniform(size=n)
    ang = rng.uniform(0.0, np.pi, size=n)
    aspect = 1.0 + 2.0 * rng.uniform(size=n)
    ca, sa = np.cos(ang), np.sin(ang)
    s1, s2 = BLOB_SIGMA * np.sqrt(aspect), BLOB_SIGMA / np.sqrt(aspect)
    icov = np.stack([(ca / s1) ** 2 + (sa / s2) ** 2, ca * sa * (1 / s1 ** 2 - 1 / s2 ** 2),
                     (sa / s1) ** 2 + (ca / s2) ** 2], -1)
    slo = np.array([lo[0], lo[1], sonar_z[0]])
    shi = np.array([hi[0], hi[1], sonar_z[1]])
    m = int(round(sonar_density * float(np.prod(shi - slo))))
    sonar = slo + rng.uniform(size=(m, 3)) * (shi - slo)
    return Scene(pts, bright, icov, sonar)


# --------------------------------------------------------------- renderer
FIXED_POINT = float(1 << 20)  # splats summed as integers: exact in any order


def render(rig: Rig, scene: Scene, R_WS: np.ndarray, p_WS: np.ndarray, device="cpu",
           batch: int = 16) -> np.ndarray:
    """uint8 images (F, cameras, H, W) of the body poses (F, 3, 3), (F, 3),
    rendered in batches of frames on ``device``. The splats are summed in
    fixed point (integer adds do not depend on their order), so a seed gives
    the same images on any device and run."""
    import torch

    n_f = R_WS.shape[0]
    cams = rig.cameras
    H, W = cams[0].height, cams[0].width
    if any((c.height, c.width) != (H, W) for c in cams):
        raise ValueError("the renderer takes cameras of one size")
    out = np.empty((n_f, len(cams), H, W), np.uint8)
    reach = math.sqrt(SPLAT_CUT) * BLOB_SIGMA
    R_off = int(math.ceil(reach))
    offs = torch.arange(-R_off, R_off + 2, device=device, dtype=torch.float32)
    pts = torch.as_tensor(scene.points, dtype=torch.float64, device=device)
    bright = torch.as_tensor(scene.brightness, dtype=torch.float32, device=device)
    icov = torch.as_tensor(scene.icov, dtype=torch.float32, device=device)
    cut = SPLAT_CUT * BLOB_SIGMA ** 2
    for f0 in range(0, n_f, batch):
        f1 = min(n_f, f0 + batch)
        uvs, imgs, ks = [], [], []
        for ci, cam in enumerate(cams):
            R_WC, p_WC = camera_poses(rig, R_WS[f0:f1], p_WS[f0:f1], ci)
            R_WC = torch.as_tensor(R_WC, device=device)
            p_WC = torch.as_tensor(p_WC, device=device)
            d = pts[None] - p_WC[:, None]  # (f, n, 3)
            p_C = (d[..., :, None] * R_WC[:, None]).sum(-2)  # R_WC^T d
            uv, ok = project(cam, p_C)
            ok &= ((uv[..., 0] > -reach) & (uv[..., 0] < W - 1 + reach)
                   & (uv[..., 1] > -reach) & (uv[..., 1] < H - 1 + reach))
            fi, ki = torch.nonzero(ok, as_tuple=True)
            uvs.append(uv[fi, ki].to(torch.float32))
            imgs.append(fi * len(cams) + ci)
            ks.append(ki)
        uv, img_i, k = torch.cat(uvs), torch.cat(imgs), torch.cat(ks)
        # pixel grid around each centre: (n, P, P)
        px = torch.floor(uv[:, 0])[:, None, None] + offs[None, None, :]
        py = torch.floor(uv[:, 1])[:, None, None] + offs[None, :, None]
        du, dv = px - uv[:, 0, None, None], py - uv[:, 1, None, None]
        a, b, c = icov[k, 0, None, None], icov[k, 1, None, None], icov[k, 2, None, None]
        q = a * du * du + 2 * b * du * dv + c * dv * dv
        keep = (du * du + dv * dv < cut) & (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
        val = torch.where(keep, bright[k, None, None] * torch.exp(-0.5 * q), 0.0)
        flat = torch.where(keep, img_i[:, None, None] * (H * W) + py.long() * W + px.long(), 0)
        acc = torch.zeros((f1 - f0) * len(cams) * H * W, dtype=torch.int64, device=device)
        acc.scatter_add_(0, flat.reshape(-1), torch.round(val * FIXED_POINT).long().reshape(-1))
        img = torch.clamp(acc.double() / FIXED_POINT * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        out[f0:f1] = img.view(f1 - f0, len(cams), H, W).cpu().numpy()
    return out


# -------------------------------------------------------------- sequence
@dataclass
class Sequence:
    """A cell's sensor stream: frame times with an index into ``images``
    (laps replay one lap's images), IMU samples, depth and sonar readings,
    and what the reference needs of the truth."""

    rig: Rig
    traj: Trajectory
    scene: Scene
    frame_t: np.ndarray  # (F,)
    frame_img: np.ndarray  # (F,) index into images
    images: np.ndarray  # (U, cameras, H, W) uint8
    imu_t: np.ndarray
    imu_gyro: np.ndarray
    imu_acc: np.ndarray
    depth: list  # (t, depth)
    sonar: list  # (t, range, heading)
    primitive: list = field(default_factory=list)  # (t, (r, q)) robot odometry
    prior: list = field(default_factory=list)  # keyframe exports of a prior session
    prior_T_WC: list = field(default_factory=list)  # their true (R_WC, p_WC)

    def truth(self, t):
        """True body poses (R_WS, p_WS) at sequence times t."""
        return self.traj.pose(np.asarray(t, float))


def sonar_range(rig: Rig, scene: Scene, R_WS: np.ndarray, p_WS: np.ndarray,
                cone_deg: float = 8.0) -> Optional[float]:
    """Range to the nearest sonar target inside the beam's cone (the sonar
    frame's x axis through T_SSo), as the port's ``sonar_range``; None when
    the cone holds none."""
    T = rig.T_SSo
    beam = R_WS @ T[:3, 0]
    origin = R_WS @ T[:3, 3] + p_WS
    rel = scene.sonar_points - origin
    d = np.linalg.norm(rel, axis=1)
    cosang = (rel @ beam) / np.maximum(d, 1e-9)
    inside = cosang > math.cos(math.radians(cone_deg))
    return float(d[inside].min()) if inside.any() else None


def make_sequence(rig: Rig, traffic: dict, seed: int, device="cpu") -> Sequence:
    """The sensor stream of ``traffic`` (a mix file's parameters) for this rig.

    The scene's places come from the mix's ``scene_seed``, so every seed
    gives the engine the same geometry and about the same work; ``seed``
    deals the blobs' looks (brightness and shape, one fixed set) to those
    places and draws the IMU noise (``default_rng(seed + 1)``, the port's
    ``synthetic_sequence`` convention)."""
    traj = Trajectory(scale=float(traffic["oscillation_scale"]),
                      speed=tuple(traffic["speed_mps"]), ramp_tau=float(traffic["ramp_tau_s"]))
    dt_f = 1.0 / rig.cam_rate
    t_first = float(traffic["t_first_frame_s"])
    n_frames = int(traffic["frames"])
    frame_t = t_first + dt_f * np.arange(n_frames)
    lap = traffic.get("lap_s")
    k0 = int(np.searchsorted(frame_t, traj.ramp_tau))  # the first frame past the ramp
    n_prior = int(traffic.get("prior_keyframes") or 0)
    t_path = frame_t[-1]
    if lap:
        # the first frame past the ramp starts the lap; later frames replay it
        per = int(round(float(lap) * rig.cam_rate))
        if abs(per * dt_f - float(lap)) > 1e-9:
            raise ValueError("lap_s must be a whole number of frames")
        uniq = np.arange(k0 + per)  # the whole lap, which a prior map also draws on
        frame_img = np.where(np.arange(n_frames) < k0, np.arange(n_frames),
                             k0 + (np.arange(n_frames) - k0) % per)
    else:
        uniq = np.arange(n_frames)
        frame_img = uniq.copy()
        if n_prior:  # the prior's keyframes reach past the window's frames
            last = k0 + int(traffic["prior_every_frames"]) * (n_prior - 1)
            t_path = max(t_path, t_first + dt_f * last)

    # the scene box over the whole path, with margins for the field of view
    path = traj.position(np.linspace(0.0, t_path + 1.0, 4000))
    m = float(traffic["margin_xy_m"])
    lo = np.array([path[:, 0].min() - m, path[:, 1].min() - m, traffic["blob_z_m"][0]])
    hi = np.array([path[:, 0].max() + m, path[:, 1].max() + m, traffic["blob_z_m"][1]])
    scene = make_scene(np.random.default_rng(int(traffic["scene_seed"])), lo, hi,
                       float(traffic["blobs_per_m3"]), tuple(traffic["sonar_z_m"]),
                       float(traffic["sonar_targets_per_m3"]))
    # the seed deals the mix's one set of blob looks to its fixed places
    deal = np.random.default_rng(seed).permutation(len(scene.points))
    scene = Scene(scene.points, scene.brightness[deal], scene.icov[deal], scene.sonar_points)

    R_u, p_u = traj.pose(t_first + dt_f * uniq)
    images = render(rig, scene, R_u, p_u, device=device)

    imu_t = np.arange(0.0, frame_t[-1] + 0.1, 1.0 / rig.imu_rate)
    gyro, acc = traj.imu(imu_t, rig.g)
    noise = np.random.default_rng(seed + 1)
    s = math.sqrt(rig.imu_rate)
    gyro = gyro + rig.sigma_g_c * s * noise.standard_normal(gyro.shape)
    acc = acc + rig.sigma_a_c * s * noise.standard_normal(acc.shape)

    R_f, p_f = traj.pose(frame_t)
    depth, sonar = [], []
    if rig.depth:
        every = max(1, int(round(rig.cam_rate / float(traffic["depth_hz"]))))
        depth = [(float(frame_t[k]), float(-p_f[k, 2])) for k in range(0, n_frames, every)]
    if rig.sonar:
        for k in range(n_frames):
            r = sonar_range(rig, scene, R_f[k], p_f[k])
            if r is not None:
                sonar.append((float(frame_t[k]), r, 0.0))
    seq = Sequence(rig, traj, scene, frame_t, frame_img, images, imu_t, gyro, acc, depth, sonar)
    walk = traffic.get("primitive_walk_m")
    if walk:
        # dead-reckoning odometry: the truth plus a random walk of ``walk`` m
        # per sqrt(s), as the port's synthetic sequence draws it
        steps = np.random.default_rng(seed + 17).standard_normal((n_frames, 3))
        off = np.cumsum(float(walk) * steps / math.sqrt(max(rig.cam_rate, 1.0)), 0)
        seq.primitive = [(float(frame_t[k]), (p_f[k] + off[k], quat_of(R_f[k])))
                         for k in range(n_frames)]
    if n_prior:
        build_prior(seq, traffic, k0, device=device)
    return seq


def build_prior(seq: Sequence, traffic: dict, k0: int, device="cpu") -> None:
    """A prior session along the path, as a resumed map holds it: one
    keyframe every ``prior_every_frames`` path frames from frame ``k0``, each
    with its rendered cam0 image, keypoints at the visible blobs' projections
    (up to ``prior_points``), their ids and positions, the pose of the true
    camera, and an accumulated drift of ``prior_drift_m`` per keyframe on the
    pose and the points alike. Timestamps lie ``prior_t_shift_s`` before the
    path's. A lap mix's keyframes lie within its one lap; a mix without
    ``lap_s`` renders those past the window's frames for cam0 at their own
    times."""
    rig, cam = seq.rig, seq.rig.cameras[0]
    n = int(traffic["prior_keyframes"])
    every = int(traffic["prior_every_frames"])
    step = np.asarray(traffic["prior_drift_m"], float)
    cap = int(traffic["prior_points"])
    frames = k0 + every * np.arange(n)  # path frames, rendered whatever the sequence's length
    beyond = frames >= len(seq.images)
    if traffic.get("lap_s") and beyond.any():
        raise ValueError("the prior map spans more than one lap")
    t_f = float(traffic["t_first_frame_s"]) + frames / seq.rig.cam_rate
    R_WS, p_WS = seq.truth(t_f)
    R_WC, p_WC = camera_poses(rig, R_WS, p_WS, 0)
    extra = np.empty((0, cam.height, cam.width), np.uint8)
    if beyond.any():
        cam0 = replace(rig, cameras=[cam])
        extra = render(cam0, seq.scene, R_WS[beyond], p_WS[beyond], device=device)[:, 0]
    extra_of = np.cumsum(beyond) - 1  # a frame past the window: its row of ``extra``
    seen: List[set] = []
    for i, f in enumerate(frames):
        p_C = (seq.scene.points - p_WC[i]) @ R_WC[i]
        uv, ok = project(cam, p_C)
        ok &= (uv[:, 0] >= 0) & (uv[:, 0] <= cam.width - 1) & (uv[:, 1] >= 0) & (uv[:, 1] <= cam.height - 1)
        ids = np.nonzero(ok)[0]
        ids = ids[np.argsort(p_C[ids, 2])][:cap]  # the nearest, as a window tracks them
        d = i * step
        covis = [[j for j in range(max(0, i - 4), i) if int(k) in seen[j]] for k in ids]
        seen.append(set(int(k) for k in ids))
        qx = (uv[ids, 0] >= cam.width / 2).astype(int)
        qy = (uv[ids, 1] >= cam.height / 2).astype(int)
        seq.prior.append({
            "kf_index": i, "timestamp": float(t_f[i]) - float(traffic["prior_t_shift_s"]),
            "image": extra[extra_of[i]] if beyond[i] else seq.images[f, 0],
            "T_WC_r": p_WC[i] + d, "T_WC_q": quat_of(R_WC[i]),
            "points_W": seq.scene.points[ids] + d, "landmark_ids": ids.astype(np.int32),
            "keypoints_uv": uv[ids].astype(np.float32), "quality": np.full(len(ids), 0.5),
            "num_tracked": int(len(ids)), "num_new": 0,
            "quadrant_counts": np.bincount(qy * 2 + qx, minlength=4)[:4],
            "response_strengths": np.ones(len(ids)), "point_covisibilities": covis,
            "sequence": 0,
        })
        seq.prior_T_WC.append((R_WC[i], p_WC[i]))


def quat_of(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) of a rotation matrix."""
    tr = np.trace(R)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, 0.25 * s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = [0.0, 0.0, 0.0, (R[k, j] - R[j, k]) / s]
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q)
