"""The port's rosbag2 ingestion, dataset-source dispatch and the two CLIs
that need no loop closer.

Mirrors the JAX package's ``tests/test_rosbag.py`` (CDR round trips, message
round trips, stereo pairing and its midpoint re-stamp, unpaired drops, the
skipped first seconds, EuRoC export, a bag feeding the engine) on the port's
modules; then across the packages: a bag written by either package's
``RosbagWriter`` reads back as the same events in the other,
``events_from_source`` covers its three branches (the bag and EuRoC
branches give the JAX package's events), and ``apps.evaluate`` /
``apps.convert_bag`` give the JAX CLIs' output.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from svin_tpu.pipeline import events_from_source as jax_events_from_source
from svin_tpu.pipeline import rosbag as jbag
from svin_tpu_torch import sim
from svin_tpu_torch.pipeline import (VioConfig, VioEngine, events_from_source, read_euroc_folder,
                                     run_events, synthetic_sequence)
from svin_tpu_torch.pipeline.rosbag import (
    CdrReader,
    CdrWriter,
    RosbagWriter,
    convert_bag_to_euroc,
    decode_compressed_image,
    decode_fluid_pressure,
    decode_image,
    decode_imu,
    read_bag_messages,
    read_rosbag,
)
from torch_parity import port_rig

torch.set_num_threads(1)
CAMS = ["/cam0/image_raw", "/cam1/image_raw"]


def test_cdr_alignment_round_trip():
    w = CdrWriter()
    w.u8(7)
    w.f64(3.25)  # 8-byte alignment after a 1-byte write
    w.string("hello")
    w.u32(42)
    w.i32(-5)
    r = CdrReader(w.data())
    assert r.u8() == 7
    assert r.f64() == 3.25
    assert r.string() == "hello"
    assert r.u32() == 42
    assert r.i32() == -5


def test_imu_message_round_trip(tmp_path):
    bag = RosbagWriter(str(tmp_path / "bag"))
    bag.add_topic("/imu", "sensor_msgs/msg/Imu")
    gyro, acc = np.array([0.1, -0.2, 0.3]), np.array([9.0, 0.5, -1.5])
    bag.write_imu("/imu", 1_500_000_000, gyro, acc)
    bag.close()
    msgs = list(read_bag_messages(str(tmp_path / "bag")))
    assert len(msgs) == 1
    m = decode_imu(msgs[0].raw)
    assert m.t_ns == 1_500_000_000
    np.testing.assert_allclose(m.gyro, gyro)
    np.testing.assert_allclose(m.acc, acc)


def test_image_messages_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 255, (48, 64), dtype=np.uint8)
    bag = RosbagWriter(str(tmp_path / "bag"))
    bag.add_topic("/cam0/image_raw", "sensor_msgs/msg/Image")
    bag.add_topic("/cam0/compressed", "sensor_msgs/msg/CompressedImage")
    bag.write_image("/cam0/image_raw", 10, img)
    bag.write_compressed_image("/cam0/compressed", 20, img, fmt="png")
    bag.close()
    msgs = {m.topic: m for m in read_bag_messages(str(tmp_path / "bag"))}
    np.testing.assert_array_equal(decode_image(msgs["/cam0/image_raw"].raw).image, img)
    np.testing.assert_array_equal(decode_compressed_image(msgs["/cam0/compressed"].raw).image, img)


def test_fluid_pressure_depth():
    w = CdrWriter()
    w.header(5)
    w.f64(101325.0 + 7.5 * 997.0 * 9.80665)
    w.f64(0.0)
    assert abs(decode_fluid_pressure(w.data()).value - 7.5) < 1e-9


def make_stereo_bag(writer_cls, path, n_frames=5, imu_per_frame=5, right_offset_ns=2_000_000):
    rng = np.random.default_rng(1)
    bag = writer_cls(path)
    bag.add_topic("/cam0/image_raw", "sensor_msgs/msg/Image")
    bag.add_topic("/cam1/image_raw", "sensor_msgs/msg/Image")
    bag.add_topic("/imu", "sensor_msgs/msg/Imu")
    bag.add_topic("/depth", "sensor_msgs/msg/FluidPressure")
    bag.add_topic("/sonar", "sensor_msgs/msg/Range")
    t0, frame_dt = 1_000_000_000, 100_000_000
    imu_dt = frame_dt // imu_per_frame
    for k in range(n_frames * imu_per_frame):
        bag.write_imu("/imu", t0 + k * imu_dt, np.zeros(3), np.array([0.0, 0.0, 9.81]))
    for k in range(n_frames):
        t = t0 + k * frame_dt
        img = rng.integers(0, 255, (32, 40), dtype=np.uint8)
        bag.write_image("/cam0/image_raw", t, img)
        bag.write_image("/cam1/image_raw", t + right_offset_ns, img)  # must still pair
        bag.write_fluid_pressure("/depth", t, 3.0 + 0.1 * k)
        bag.write_range("/sonar", t, 1.5 + 0.01 * k)
    bag.close()
    return t0, frame_dt


def test_read_rosbag_stereo_pairing(tmp_path):
    t0, frame_dt = make_stereo_bag(RosbagWriter, str(tmp_path / "bag"))
    events = list(read_rosbag(str(tmp_path / "bag"), cam_topics=CAMS, imu_topic="/imu",
                              depth_topic="/depth"))
    frames = [e for e in events if e.kind == "frame"]
    assert len(frames) == 5
    assert sum(e.kind == "imu" for e in events) == 25
    assert sum(e.kind == "depth" for e in events) == 5
    for k, f in enumerate(frames):
        assert len(f.images) == 2
        assert abs(f.t - (t0 + k * frame_dt + 1_000_000) * 1e-9) < 1e-9  # midpoint re-stamp
    ts = [e.t for e in events]
    assert all(b >= a - 0.011 for a, b in zip(ts, ts[1:]))


def test_read_rosbag_drops_unpaired(tmp_path):
    bag = RosbagWriter(str(tmp_path / "bag"))
    for topic in CAMS:
        bag.add_topic(topic, "sensor_msgs/msg/Image")
    img = np.zeros((8, 8), np.uint8)
    bag.write_image(CAMS[0], 1_000_000_000, img)  # no right match
    bag.write_image(CAMS[0], 2_000_000_000, img)
    bag.write_image(CAMS[1], 2_000_000_000, img)
    bag.close()
    frames = [e for e in read_rosbag(str(tmp_path / "bag"), cam_topics=CAMS) if e.kind == "frame"]
    assert len(frames) == 1 and abs(frames[0].t - 2.0) < 1e-9


def test_skip_first_seconds(tmp_path):
    make_stereo_bag(RosbagWriter, str(tmp_path / "bag"))
    events = list(read_rosbag(str(tmp_path / "bag"), cam_topics=CAMS, imu_topic="/imu",
                              skip_first_s=0.25))
    assert events and all(e.t >= 1.0 + 0.25 - 1e-9 for e in events)


def test_convert_bag_to_euroc(tmp_path):
    make_stereo_bag(RosbagWriter, str(tmp_path / "bag"))
    out = tmp_path / "euroc"
    counts = convert_bag_to_euroc(str(tmp_path / "bag"), str(out), cam_topics=CAMS, imu_topic="/imu")
    assert counts == {"imu": 25, "cam0": 5, "cam1": 5}
    events = list(read_euroc_folder(str(out), num_cams=2))
    frames = [e for e in events if e.kind == "frame"]
    # IMU rows trailing the last frame are dropped, as the reference app loop does
    assert len(frames) == 5 and sum(e.kind == "imu" for e in events) == 21
    assert frames[0].images[0].shape == (32, 40)


def test_rosbag_feeds_vio_engine(tmp_path):
    """A rendered sequence written as a bag and replayed through the port's
    engine gives finite frame results."""
    rig = port_rig()
    events, _ = synthetic_sequence(rig, duration=1.2, traj=sim.default_trajectory(scale=0.3, ramp_tau=0.6),
                                   spread=6.0, depth_offset=3.0, n_points=300)
    bag = RosbagWriter(str(tmp_path / "bag"))
    for topic in CAMS:
        bag.add_topic(topic, "sensor_msgs/msg/Image")
    bag.add_topic("/imu", "sensor_msgs/msg/Imu")
    for e in events:
        t_ns = int(round(e.t * 1e9))
        if e.kind == "imu":
            bag.write_imu("/imu", t_ns, e.imu[0], e.imu[1])
        elif e.kind == "frame":
            for topic, im in zip(CAMS, e.images):
                bag.write_image(topic, t_ns, np.asarray(im * 255, np.uint8))
    bag.close()
    cfg = VioConfig()
    cfg.max_keypoints = 150
    results = run_events(VioEngine(cfg, rig=rig, device="cpu"),
                         read_rosbag(str(tmp_path / "bag"), cam_topics=CAMS, imu_topic="/imu"),
                         max_frames=6)
    assert len(results) >= 4
    assert all(np.isfinite(r.T_WS.r).all() for r in results)


def same_events(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.kind, a.t, a.depth) == (b.kind, b.t, b.depth)
        for x, y in ((a.imu, b.imu), (a.images, b.images), (a.sonar, b.sonar)):
            assert (x is None) == (y is None)
            if x is not None:
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bags_cross_between_the_packages(tmp_path, writer):
    """A bag written by one package's writer reads back as the same events
    in both packages' readers."""
    cls = jbag.RosbagWriter if writer == "jax" else RosbagWriter
    make_stereo_bag(cls, str(tmp_path / "bag"))
    kw = dict(cam_topics=CAMS, imu_topic="/imu", depth_topic="/depth", sonar_topic="/sonar")
    got = list(read_rosbag(str(tmp_path / "bag"), **kw))
    want = list(jbag.read_rosbag(str(tmp_path / "bag"), **kw))
    assert sum(e.kind == "sonar" for e in got) == 5
    same_events(got, want)


def test_events_from_source_branches(tmp_path, monkeypatch):
    """``--synthetic`` streams the rendered sequence (primitive-odometry
    events with SVIN_SYNTH_PRIMITIVE=1); a bag directory, its ``.db3`` file
    and a EuRoC folder give the JAX package's events."""
    from svin_tpu.pipeline import VioConfig as JaxConfig
    from vio_fixtures import small_rig

    cfg = VioConfig()
    cfg.camera_rate = 5.0
    monkeypatch.setenv("SVIN_SYNTH_DURATION", "0.6")
    plain = list(events_from_source("--synthetic", cfg, port_rig()))
    kinds = [e.kind for e in plain]
    assert kinds.count("frame") == 3 and "imu" in kinds and "primitive" not in kinds
    monkeypatch.setenv("SVIN_SYNTH_PRIMITIVE", "1")
    prim = list(events_from_source("--synthetic", cfg, port_rig()))
    assert [e.kind for e in prim if e.kind != "primitive"] == kinds
    ps = [e for e in prim if e.kind == "primitive"]
    assert len(ps) == 3 and all(e.primitive[0].shape == (3,) and e.primitive[1].shape == (4,)
                                for e in ps)
    # frames are unchanged by the extra events
    for a, b in zip([e for e in prim if e.kind == "frame"], [e for e in plain if e.kind == "frame"]):
        np.testing.assert_array_equal(a.images[0], b.images[0])

    make_stereo_bag(RosbagWriter, str(tmp_path / "bag"))
    monkeypatch.setenv("SVIN_DEPTH_TOPIC", "/depth")
    monkeypatch.setenv("SVIN_SKIP_FIRST_S", "0.15")
    db3 = next(str(p) for p in (tmp_path / "bag").iterdir() if p.suffix == ".db3")
    jcfg = JaxConfig()
    for source in (str(tmp_path / "bag"), db3):
        got = list(events_from_source(source, cfg, port_rig()))
        assert got and any(e.kind == "depth" for e in got)
        same_events(got, list(jax_events_from_source(source, jcfg, small_rig())))
    convert_bag_to_euroc(str(tmp_path / "bag"), str(tmp_path / "euroc"), CAMS, "/imu")
    got = list(events_from_source(str(tmp_path / "euroc"), cfg, port_rig()))
    assert sum(e.kind == "frame" for e in got) == 5
    same_events(got, list(jax_events_from_source(str(tmp_path / "euroc"), jcfg, small_rig())))


def cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_evaluate_and_convert_bag_give_the_jax_output(tmp_path):
    from svin_tpu.apps import convert_bag as jconvert
    from svin_tpu.apps import evaluate as jevaluate
    from svin_tpu_torch.apps import convert_bag, evaluate

    rng = np.random.default_rng(4)
    t = np.arange(60) * 0.1
    gt = np.column_stack([t, np.cumsum(rng.standard_normal((60, 3)) * 0.05, axis=0),
                          np.tile([0, 0, 0, 1.0], (60, 1))])
    est = gt.copy()
    est[:, 1:4] = 1.1 * gt[:, 1:4] + 0.01 * rng.standard_normal((60, 3))
    q = rng.standard_normal((60, 4)) * 0.02 + [0, 0, 0, 1]
    est[:, 4:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    est[:, 0] += 0.004
    np.savetxt(tmp_path / "est.txt", est)
    np.savetxt(tmp_path / "gt.txt", gt)
    pairs = []
    for extra in ([], ["--se3"], ["--max-dt", "0.05"]):
        argv = [str(tmp_path / "est.txt"), str(tmp_path / "gt.txt"), *extra]
        got, want = cli(evaluate.main, argv), cli(jevaluate.main, argv)
        assert got == want and got[0] == 0
        pairs.append(json.loads(got[1])["n_pairs"])
    assert pairs == [60, 60, 60]
    assert cli(evaluate.main, [])[0] == cli(jevaluate.main, [])[0] == 2

    make_stereo_bag(RosbagWriter, str(tmp_path / "bag"))
    outs = {}
    for name, main in (("port", convert_bag.main), ("jax", jconvert.main)):
        outs[name] = cli(main, [str(tmp_path / "bag"), str(tmp_path / name), ",".join(CAMS), "/imu"])
    assert outs["port"] == outs["jax"] and outs["port"][1].strip() == "cam0=5 cam1=5 imu=25"
    for sub in ("imu0/data.csv", "cam0/data.csv", "cam1/data.csv"):
        assert (tmp_path / "port" / sub).read_text() == (tmp_path / "jax" / sub).read_text()
    names = sorted(os.listdir(tmp_path / "port" / "cam0" / "data"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "cam0" / "data")) and len(names) == 5
