"""The generator: seeded, exact on replay, the transect never revisits, and
the IMU it samples integrates to the trajectory it renders."""
from __future__ import annotations

import json
import os

import numpy as np

import portbench_tiny as tiny
from portbench import gen


def _tiny(traffic="transect", **over):
    with open(os.path.join(tiny.HERE, "tiny", "tiny_stereorig.json")) as f:
        rig = gen.load_rig(json.load(f))
    with open(os.path.join(tiny.HERE, "tiny", f"tiny_{traffic}.json")) as f:
        t = json.load(f)
    t.update(over)
    return rig, t


def test_same_seed_same_events_other_seed_other_scene():
    rig, t = _tiny(frames=12)
    a, b = gen.make_sequence(rig, t, 2**31 + 99), gen.make_sequence(rig, t, 2**31 + 99)
    for f in ("images", "imu_gyro", "imu_acc", "frame_t"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.depth == b.depth and a.sonar == b.sonar
    c = gen.make_sequence(rig, t, 2**31 + 100)
    assert not np.array_equal(a.images, c.images)
    assert a.images.dtype == np.uint8 and a.images.max() > 100
    assert len(a.sonar) == len(a.frame_t)  # a sonar range per frame
    assert a.depth and all(abs(d + a.truth(np.array([t0]))[1][0, 2]) < 1e-12 for t0, d in a.depth)


def test_a_replayed_lap_equals_a_rendered_one():
    rig, t = _tiny("laps", frames=230, prior_keyframes=0)
    seq = gen.make_sequence(rig, t, 4)
    per = int(round(t["lap_s"] * rig.cam_rate))
    k0 = int(np.searchsorted(seq.frame_t, t["ramp_tau_s"]))
    late = np.arange(k0 + per, len(seq.frame_t))
    assert late.size > 10 and np.all(seq.frame_img[late] == seq.frame_img[late - per])
    R_a, p_a = seq.truth(seq.frame_t[late])
    R_b, p_b = seq.truth(seq.frame_t[late - per])
    np.testing.assert_allclose(p_a, p_b, atol=1e-9)
    np.testing.assert_allclose(R_a, R_b, atol=1e-9)
    rendered = gen.render(rig, seq.scene, R_a, p_a)
    replayed = seq.images[seq.frame_img[late]]
    diff = np.abs(rendered.astype(int) - replayed.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-3


def test_the_transect_sees_no_place_twice():
    """Full-size geometry: frames 30 s apart or more (15 m of path) share no
    visible blob."""
    with open(os.path.join(tiny.PORTBENCH, "configs", "okvis_euroc_stereo.json")) as f:
        rig = gen.load_rig(json.load(f))
    with open(os.path.join(tiny.PORTBENCH, "traffic", "transect.json")) as f:
        t = json.load(f)
    traj = gen.Trajectory(t["oscillation_scale"], tuple(t["speed_mps"]), t["ramp_tau_s"])
    times = t["t_first_frame_s"] + np.arange(0, t["frames"], 10) / rig.cam_rate
    path = traj.position(np.linspace(0, times[-1] + 1, 4000))
    m = t["margin_xy_m"]
    lo = np.array([path[:, 0].min() - m, path[:, 1].min() - m, t["blob_z_m"][0]])
    hi = np.array([path[:, 0].max() + m, path[:, 1].max() + m, t["blob_z_m"][1]])
    scene = gen.make_scene(np.random.default_rng(0), lo, hi, t["blobs_per_m3"], (0, 0), 0)
    cam = rig.cameras[0]
    seen = []
    for ti in times:
        R, p = gen.camera_poses(rig, *traj.pose(np.array([ti])), 0)
        uv, ok = gen.project(cam, (scene.points - p[0]) @ R[0])
        ok &= (uv[:, 0] >= 0) & (uv[:, 0] < cam.width) & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
        seen.append(set(np.nonzero(ok)[0].tolist()))
    assert min(len(s) for s in seen) > 400  # enough blobs for 400 keypoints
    for i in range(len(times)):
        for j in range(i + 1, len(times)):
            if times[j] - times[i] >= 30.0:
                assert not seen[i] & seen[j], (times[i], times[j])


def test_the_imu_integrates_to_the_trajectory():
    """Body rate and specific force against central differences of the pose."""
    traj = gen.Trajectory(0.4, (0.5, 0.0, 0.0), 0.8)
    t = np.array([0.3, 1.7, 4.2, 9.9])
    h = 1e-5
    gyro, acc = traj.imu(t, 9.81)
    R0, _ = traj.pose(t)
    Rp, _ = traj.pose(t + h)
    Rm, _ = traj.pose(t - h)
    W = np.swapaxes(R0, -1, -2) @ (Rp - Rm) / (2 * h)  # [w]x
    np.testing.assert_allclose(np.stack([W[:, 2, 1], W[:, 0, 2], W[:, 1, 0]], -1), gyro, atol=1e-6)
    a_W = (traj.position(t + h) - 2 * traj.position(t) + traj.position(t - h)) / h**2
    f = (np.swapaxes(R0, -1, -2) @ (a_W + np.array([0, 0, 9.81]))[..., None])[..., 0]
    np.testing.assert_allclose(f, acc, atol=1e-3)
