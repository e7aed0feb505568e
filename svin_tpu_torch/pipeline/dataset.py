"""Dataset readers + synthetic sequence rendering.

Counterpart of the JAX package's ``pipeline/dataset.py``: the EuRoC folder
reader, the sonar intensity-profile range extraction, the synthetic blob
renderer and its ordered event stream, the synchronous feeding loop, and
``events_from_source``, the apps' dispatch over the synthetic sequence, a
rosbag2 bag and a EuRoC folder.

The renderer's scene (blob positions, brightness, anisotropic shapes) and the
IMU noise come from ``numpy.random.Generator`` streams (the JAX package uses
``jax.random``, which torch cannot reproduce); ``SyntheticRenderer.from_scene``
takes a scene made elsewhere. Rendering runs on the rig's device in float32,
in bands of image rows so the (rows, W, N) splat stays small at full width.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import sim
from ..cameras import NCameraSystem, PinholeCamera, project
from ..imu import ImuParameters
from ..kinematics import compose, inverse, npq, transform_point

# image rows per splat band: (32, W, N) float32 intermediates stay ~60 MB at
# 800 px and 600 blobs
_ROW_BAND = 32


@dataclass
class SensorEvent:
    """One timestamped event, ordered stream (the app's interleave loop)."""

    t: float
    kind: str  # "imu" | "frame" | "depth" | "sonar" | "primitive"
    imu: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (gyro, acc)
    images: Optional[List[np.ndarray]] = None
    depth: Optional[float] = None
    sonar: Optional[Tuple[float, float]] = None  # (range, heading)
    # robot dead-reckoning odometry (the primitive estimator's pose feeding
    # the switching estimator) as (r (3,), q (4,)) world pose
    primitive: Optional[Tuple[np.ndarray, np.ndarray]] = None


def sonar_range_from_intensity(
    intensities,
    max_range: float,
    head_position_deg: float,
    discard_tail: int = 100,
    max_valid_range: float = 4.5,
    min_intensity: float = 10.0,
) -> Optional[Tuple[float, float]]:
    """Mechanically-scanned sonar intensity profile → (range, heading): the
    max-intensity bin ignoring the last ``discard_tail`` bins, gated on
    range < 4.5 m and intensity > 10. Returns None when gated out."""
    inten = np.asarray(intensities, float)
    n = inten.shape[0]
    if n == 0:
        return None
    resolution = max_range / n
    usable = inten[: max(n - discard_tail, 1)]
    idx = int(np.argmax(usable))
    peak = float(usable[idx])
    rng = (idx + 1) * resolution
    if rng < max_valid_range and peak > min_intensity:
        return rng, float(np.radians(head_position_deg))
    return None


def read_euroc_folder(path: str, num_cams: int = 2) -> Iterator[SensorEvent]:
    """EuRoC ASL-format folder: mav0/imu0/data.csv, mav0/cam{i}/data/*.png.
    Image decode uses cv2 if present, else imageio, else raw .npy."""
    root = path
    if os.path.isdir(os.path.join(path, "mav0")):
        root = os.path.join(path, "mav0")

    imu_rows = []
    with open(os.path.join(root, "imu0", "data.csv")) as f:
        for row in csv.reader(f):
            if row[0].startswith("#"):
                continue
            t = int(row[0]) * 1e-9
            imu_rows.append((t, np.array(row[1:4], float), np.array(row[4:7], float)))

    cam_files = []
    for ci in range(num_cams):
        d = os.path.join(root, f"cam{ci}", "data")
        fs = sorted(os.listdir(d))
        cam_files.append([(int(os.path.splitext(f)[0]) * 1e-9, os.path.join(d, f)) for f in fs])

    def _load(p):
        if p.endswith(".npy"):
            return np.load(p)
        try:
            import cv2

            return cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        except ImportError:
            import imageio.v2 as iio

            im = iio.imread(p)
            return im if im.ndim == 2 else im.mean(axis=-1).astype(np.uint8)

    # interleave: emit all imu <= frame time, then the frame
    ii = 0
    for fi, (t_f, _) in enumerate(cam_files[0]):
        while ii < len(imu_rows) and imu_rows[ii][0] <= t_f + 1e-9:
            t, g, a = imu_rows[ii]
            yield SensorEvent(t=t, kind="imu", imu=(g, a))
            ii += 1
        images = [_load(cam_files[ci][fi][1]) for ci in range(num_cams)]
        yield SensorEvent(t=t_f, kind="frame", images=images)


# --------------------------------------------------------------- synthetic
class SyntheticRenderer:
    """Renders a fixed 3D blob field through the analytic trajectory, on the
    device of the rig's tensors."""

    def __init__(
        self,
        rig: NCameraSystem,
        n_points: int = 600,
        seed: int = 0,
        traj: Optional[sim.Trajectory] = None,
        spread: float = 14.0,
        depth_offset: float = 6.0,
        blob_sigma: float = 1.6,
    ):
        rng = np.random.default_rng(seed)
        center = torch.tensor([0.0, 0.0, depth_offset], dtype=torch.float64)
        points = sim.landmark_grid(rng, n_points, center,
                                   torch.tensor([spread, spread, 2 * depth_offset], dtype=torch.float64))
        brightness = 0.35 + 0.65 * rng.uniform(size=n_points)
        # anisotropic per-blob shape (random orientation + aspect) so local
        # appearance is distinctive
        ang = rng.uniform(0.0, np.pi, size=n_points)
        aspect = 1.0 + 2.0 * rng.uniform(size=n_points)
        ca, sa = np.cos(ang), np.sin(ang)
        s1 = blob_sigma * np.sqrt(aspect)
        s2 = blob_sigma / np.sqrt(aspect)
        self._set_scene(
            rig, traj, points.numpy(), brightness,
            (ca / s1) ** 2 + (sa / s2) ** 2, ca * sa * (1.0 / s1**2 - 1.0 / s2**2),
            (sa / s1) ** 2 + (ca / s2) ** 2, blob_sigma,
        )

    @classmethod
    def from_scene(cls, rig: NCameraSystem, traj: sim.Trajectory, points_W, brightness,
                   icov_a, icov_b, icov_c, blob_sigma: float):
        """A renderer of a given scene (numpy arrays: points (N,3), per-blob
        brightness and inverse-covariance entries (N,))."""
        self = cls.__new__(cls)
        self._set_scene(rig, traj, points_W, brightness, icov_a, icov_b, icov_c, blob_sigma)
        return self

    def _set_scene(self, rig, traj, points_W, brightness, icov_a, icov_b, icov_c, blob_sigma):
        self.rig = rig
        self.traj = traj if traj is not None else sim.default_trajectory()
        dev = rig.cameras[0].fu.device
        self.device = dev
        self.points_W = torch.as_tensor(np.array(points_W, np.float64), device=dev)
        f32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32, device=dev)  # noqa: E731
        self.brightness = f32(brightness)
        self._icov_a, self._icov_b, self._icov_c = f32(icov_a), f32(icov_b), f32(icov_c)
        self.blob_sigma = float(blob_sigma)

    def pose(self, t: float):
        """Ground-truth T_WS at time t (float64, on the trajectory's device)."""
        return sim.pose(self.traj, torch.tensor(float(t), dtype=self.traj.r_amp.dtype,
                                                device=self.traj.r_amp.device))

    def render(self, T_WS, cam_idx: int) -> torch.Tensor:
        """(H, W) float32 image in [0, 1] of camera ``cam_idx`` at body pose
        T_WS: every blob in front of the camera and inside the image splats
        its anisotropic Gaussian (cut at r² < 60 σ²)."""
        dev = self.device
        cam = self.rig.cameras[cam_idx]
        T_SC = self.rig.T_SC[cam_idx]
        T_WS = type(T_WS)(r=T_WS.r.to(dev, torch.float64), q=T_WS.q.to(dev, torch.float64))
        T_WC = compose(T_WS, type(T_SC)(r=T_SC.r.to(torch.float64), q=T_SC.q.to(torch.float64)))
        p_C = transform_point(inverse(T_WC), self.points_W)
        cam32 = PinholeCamera(*(x.to(torch.float32) if isinstance(x, torch.Tensor) else x for x in cam))
        uv, valid = project(cam32, p_C.to(torch.float32))
        h, w = cam.height, cam.width
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
        du = xx - uv[None, None, :, 0]
        a, b, c = self._icov_a, self._icov_b, self._icov_c
        cut = 60.0 * self.blob_sigma ** 2
        reach = cut ** 0.5 + 1.0  # rows a blob can splat into, either side of its own
        img = torch.empty((h, w), dtype=torch.float32, device=dev)
        for y0 in range(0, h, _ROW_BAND):
            y1 = min(h, y0 + _ROW_BAND)
            yy = torch.arange(y0, y1, dtype=torch.float32, device=dev)[:, None, None]
            # the Gaussian only where it splats (~2% of the pixel-blob pairs),
            # summed over every blob as before: the exponential of the whole
            # band dominated a CPU render
            kc = torch.nonzero(valid & (uv[:, 1] > y0 - reach) & (uv[:, 1] < y1 + reach),
                               as_tuple=True)[0]
            du_c, dv_c = du[..., kc], yy - uv[None, None, kc, 1]
            i, j, kk = torch.nonzero(du_c * du_c + dv_c * dv_c < cut, as_tuple=True)
            k = kc[kk]
            du_s, dv_s = du_c[0, j, kk], dv_c[i, 0, kk]
            q = a[k] * du_s * du_s + 2.0 * b[k] * du_s * dv_s + c[k] * dv_s * dv_s
            contrib = torch.zeros((y1 - y0, w, uv.shape[0]), dtype=torch.float32, device=dev)
            contrib[i, j, k] = self.brightness[k] * torch.exp(-0.5 * q)
            img[y0:y1] = torch.sum(contrib, dim=-1)
        return torch.clamp(img, 0.0, 1.0)

    def render_frame(self, t: float) -> List[np.ndarray]:
        """One float32 host image per camera at time t."""
        T = self.pose(t)
        return [self.render(T, ci).cpu().numpy() for ci in range(self.rig.num_cameras)]

    def sonar_range(self, t: float, heading: float = 0.0, cone_deg: float = 8.0,
                    T_SSo: Optional[np.ndarray] = None):
        """Simulated single-beam sonar return: range to the nearest scene
        point inside a cone around the beam (the sonar-frame vector
        (cosθ, sinθ, 0) mapped through T_SSo into the body frame). Returns
        (range, heading) or (None, heading)."""
        T = self.pose(t)
        C_WS = npq.to_rotation_matrix(T.q.cpu().numpy())
        p_S = (self.points_W.cpu().numpy() - T.r.cpu().numpy()) @ C_WS  # body frame
        beam_sonar = np.array([np.cos(heading), np.sin(heading), 0.0])
        if T_SSo is None:
            beam = beam_sonar
            origin = np.zeros(3)
        else:
            T_SSo = np.asarray(T_SSo)
            beam = T_SSo[:3, :3] @ beam_sonar
            origin = T_SSo[:3, 3]
        rel = p_S - origin
        d = np.linalg.norm(rel, axis=1)
        cosang = (rel @ beam) / np.maximum(d, 1e-9)
        in_cone = cosang > np.cos(np.radians(cone_deg))
        if not in_cone.any():
            return None, heading
        return float(d[in_cone].min()), heading


def synthetic_sequence(
    rig: NCameraSystem,
    duration: float = 4.0,
    cam_rate: float = 10.0,
    imu_rate: float = 100.0,
    imu_params: Optional[ImuParameters] = None,
    seed: int = 0,
    imu_noisy: bool = True,
    n_points: int = 600,
    depth_enabled: bool = False,
    sonar_enabled: bool = False,
    sonar_T_SSo: Optional[np.ndarray] = None,
    traj: Optional[sim.Trajectory] = None,
    spread: float = 14.0,
    depth_offset: float = 6.0,
    t_first_frame: float = 0.25,
    degrade_windows: Optional[List[Tuple[float, float]]] = None,
    primitive_enabled: bool = False,
    primitive_noise: float = 0.02,
) -> Tuple[Iterator[SensorEvent], SyntheticRenderer]:
    """Ordered event stream + its renderer (ground truth via renderer.pose).
    Scene from ``seed``, IMU noise from ``seed + 1``. Frames inside a
    ``degrade_windows`` interval are rendered nearly featureless.
    ``primitive_enabled`` adds robot dead-reckoning odometry events before
    each frame: ground truth plus a random-walk offset of
    ``primitive_noise`` / sqrt(camera rate) per frame (the featureless noise
    and the walk share the ``seed + 17`` stream)."""
    params = imu_params if imu_params is not None else ImuParameters()
    renderer = SyntheticRenderer(rig, n_points=n_points, seed=seed, traj=traj, spread=spread,
                                 depth_offset=depth_offset)
    series = sim.simulate_imu(renderer.traj, 0.0, duration + 0.1, imu_rate, params,
                              rng=np.random.default_rng(seed + 1), noisy=imu_noisy)
    t_np = series.t.cpu().numpy()
    gyro = series.gyro.cpu().numpy()
    acc = series.acc.cpu().numpy()
    frame_times = np.arange(t_first_frame, duration, 1.0 / cam_rate)
    windows = degrade_windows or []
    noise_rng = np.random.default_rng(seed + 17)

    def gen():
        ii = 0
        prim_off = np.zeros(3)
        for t_f in frame_times:
            while ii < len(t_np) and t_np[ii] <= t_f + 1e-9:
                yield SensorEvent(t=float(t_np[ii]), kind="imu", imu=(gyro[ii], acc[ii]))
                ii += 1
            if depth_enabled:
                depth = -float(renderer.pose(float(t_f)).r[2])
                yield SensorEvent(t=float(t_f), kind="depth", depth=depth)
            if sonar_enabled:
                rng, heading = renderer.sonar_range(float(t_f), T_SSo=sonar_T_SSo)
                if rng is not None:
                    yield SensorEvent(t=float(t_f), kind="sonar", sonar=(rng, heading))
            if primitive_enabled:
                T = renderer.pose(float(t_f))
                prim_off = prim_off + primitive_noise * noise_rng.standard_normal(3) / np.sqrt(
                    max(cam_rate, 1.0))
                yield SensorEvent(t=float(t_f), kind="primitive",
                                  primitive=(T.r.cpu().numpy() + prim_off, T.q.cpu().numpy()))
            imgs = renderer.render_frame(float(t_f))
            if any(a <= t_f < b for a, b in windows):
                imgs = [(0.35 + 0.02 * noise_rng.standard_normal(im.shape)).astype(im.dtype)
                        for im in imgs]
            yield SensorEvent(t=float(t_f), kind="frame", images=imgs)

    return gen(), renderer


def run_events(engine, events, max_frames: int = 10**9):
    """Feed an event stream into a VioEngine (the synchronous app loop)."""
    n = 0
    results = []
    for ev in events:
        if ev.kind == "imu":
            engine.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "depth":
            engine.add_depth_measurement(ev.t, ev.depth)
        elif ev.kind == "sonar":
            engine.add_sonar_measurement(ev.t, *ev.sonar)
        elif ev.kind == "frame":
            r = engine.add_frame(ev.t, ev.images)
            if r is not None:
                results.append(r)
                n += 1
                if n >= max_frames:
                    break
    return results


def events_from_source(data: str, cfg, rig):
    """The apps' dataset-source dispatch: ``--synthetic`` (the rendered
    sequence), a rosbag2 directory or ``.db3`` file, or a EuRoC-layout
    folder. Environment:

    - synthetic: ``SVIN_SYNTH_DURATION`` (s, default 5), ``SVIN_SYNTH_REVISIT=1``
      (no linear drift, so the path revisits itself), ``SVIN_SYNTH_DEGRADE``
      ("t0:t1[,t0:t1...]" featureless stretches),
      ``SVIN_SYNTH_GYRO_NOISE_SCALE`` (the simulator's gyro noise against the
      engine's model), ``SVIN_SYNTH_SEED``, ``SVIN_SYNTH_PRIMITIVE=1``
      (primitive-odometry events);
    - rosbag2: ``SVIN_CAM_TOPICS`` (comma-separated), ``SVIN_IMU_TOPIC``,
      ``SVIN_DEPTH_TOPIC``, ``SVIN_SONAR_TOPIC``, ``SVIN_SKIP_FIRST_S``."""
    if data == "--synthetic":
        duration = float(os.environ.get("SVIN_SYNTH_DURATION", "5.0"))
        traj = sim.default_trajectory(scale=0.4, ramp_tau=0.8)
        if os.environ.get("SVIN_SYNTH_REVISIT", "0") == "1":
            traj = traj._replace(r_lin=traj.r_lin * 0.0)
        degrade = []
        for w in os.environ.get("SVIN_SYNTH_DEGRADE", "").split(","):
            if ":" in w:
                a, b = w.split(":")
                degrade.append((float(a), float(b)))
        gy_scale = float(os.environ.get("SVIN_SYNTH_GYRO_NOISE_SCALE", "1"))
        sim_imu = cfg.imu
        if gy_scale != 1.0:
            sim_imu = sim_imu._replace(sigma_g_c=sim_imu.sigma_g_c * gy_scale,
                                       sigma_gw_c=sim_imu.sigma_gw_c * gy_scale)
        events, _ = synthetic_sequence(
            rig, duration=duration, cam_rate=cfg.camera_rate, imu_rate=float(cfg.imu.rate),
            imu_params=sim_imu, traj=traj, seed=int(os.environ.get("SVIN_SYNTH_SEED", "0")),
            spread=6.0, depth_offset=3.0, t_first_frame=0.12,
            depth_enabled=cfg.is_depth_used, sonar_enabled=cfg.is_sonar_used,
            sonar_T_SSo=cfg.T_SSo if cfg.is_sonar_used else None,
            degrade_windows=degrade or None,
            primitive_enabled=os.environ.get("SVIN_SYNTH_PRIMITIVE", "0") == "1",
        )
        return events
    if data.endswith(".db3") or os.path.exists(os.path.join(data, "metadata.yaml")):
        from .rosbag import read_rosbag

        n = rig.num_cameras
        cam_topics = os.environ.get(
            "SVIN_CAM_TOPICS", ",".join(f"/cam{i}/image_raw" for i in range(n))).split(",")
        return read_rosbag(
            data, cam_topics=cam_topics,
            imu_topic=os.environ.get("SVIN_IMU_TOPIC", "/imu"),
            depth_topic=os.environ.get("SVIN_DEPTH_TOPIC") or None,
            sonar_topic=os.environ.get("SVIN_SONAR_TOPIC") or None,
            skip_first_s=float(os.environ.get("SVIN_SKIP_FIRST_S", "0")),
        )
    return read_euroc_folder(data, num_cams=rig.num_cameras)
