"""rosbag2 ingestion: deterministic dataset replay from ROS 2 bags.

Counterpart of the JAX package's ``pipeline/rosbag.py`` (sqlite3 + struct +
numpy, no ROS linked), on the port's ``SensorEvent``. rosbag2's default
storage is a SQLite database (``*.db3`` with ``topics``/``messages`` tables)
and its default serialization is CDR; a small CDR codec decodes
``sensor_msgs/msg/{Imu, Image, CompressedImage, FluidPressure, Range}``.
``read_rosbag`` pairs the camera topics by approximate time and re-stamps
each pair to its midpoint, dropping non-increasing stamps (the
``stereo_sync`` republisher's rule); CompressedImage payloads decode with
cv2. Optional zstd per-message / per-file compression is handled when the
``zstandard`` module is present. ``convert_bag_to_euroc`` exports a bag as a
EuRoC-layout folder; ``RosbagWriter`` writes bags (round-trip tests,
dataset re-export).
"""
from __future__ import annotations

import os
import sqlite3
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .dataset import SensorEvent

# ---------------------------------------------------------------------------
# CDR codec (XCDR1 encapsulation, as used by rmw_fastrtps / rosbag2 "cdr")
# ---------------------------------------------------------------------------


class CdrReader:
    """Minimal CDR deserializer. The 4-byte encapsulation header selects
    endianness (0x0000 BE / 0x0001 LE); primitive reads are aligned to their
    size relative to the start of the payload (CDR rule)."""

    def __init__(self, buf: bytes):
        if len(buf) < 4:
            raise ValueError("CDR payload too short")
        self.buf = buf
        kind = struct.unpack_from(">H", buf, 0)[0]
        self.le = bool(kind & 1)
        self.fmt = "<" if self.le else ">"
        self.pos = 4  # alignment is relative to this origin

    def _align(self, n: int) -> None:
        off = (self.pos - 4) % n
        if off:
            self.pos += n - off

    def _prim(self, code: str, size: int):
        self._align(size)
        v = struct.unpack_from(self.fmt + code, self.buf, self.pos)[0]
        self.pos += size
        return v

    def u8(self) -> int:
        return self._prim("B", 1)

    def i32(self) -> int:
        return self._prim("i", 4)

    def u32(self) -> int:
        return self._prim("I", 4)

    def f32(self) -> float:
        return self._prim("f", 4)

    def f64(self) -> float:
        return self._prim("d", 8)

    def string(self) -> str:
        n = self.u32()  # length including NUL terminator
        s = self.buf[self.pos : self.pos + max(n - 1, 0)]
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def bytes_seq(self) -> bytes:
        n = self.u32()
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def f64_array(self, n: int) -> np.ndarray:
        self._align(8)
        a = np.frombuffer(
            self.buf, dtype=(np.dtype("<f8") if self.le else np.dtype(">f8")),
            count=n, offset=self.pos,
        )
        self.pos += 8 * n
        return np.asarray(a, np.float64)

    def header(self) -> Tuple[int, str]:
        """std_msgs/Header → (stamp_ns, frame_id)."""
        sec = self.i32()
        nsec = self.u32()
        frame = self.string()
        return sec * 1_000_000_000 + nsec, frame


class CdrWriter:
    """Matching serializer (little-endian XCDR1)."""

    def __init__(self):
        self.parts = bytearray(b"\x00\x01\x00\x00")

    def _align(self, n: int) -> None:
        off = (len(self.parts) - 4) % n
        if off:
            self.parts += b"\x00" * (n - off)

    def _prim(self, code: str, size: int, v) -> None:
        self._align(size)
        self.parts += struct.pack("<" + code, v)

    def u8(self, v: int):
        self._prim("B", 1, v)

    def i32(self, v: int):
        self._prim("i", 4, v)

    def u32(self, v: int):
        self._prim("I", 4, v)

    def f64(self, v: float):
        self._prim("d", 8, v)

    def string(self, s: str):
        b = s.encode("utf-8") + b"\x00"
        self.u32(len(b))
        self.parts += b

    def bytes_seq(self, b: bytes):
        self.u32(len(b))
        self.parts += b

    def f64_array(self, a) -> None:
        for v in np.asarray(a, np.float64).reshape(-1):
            self.f64(float(v))

    def header(self, stamp_ns: int, frame_id: str = ""):
        self.i32(stamp_ns // 1_000_000_000)
        self.u32(stamp_ns % 1_000_000_000)
        self.string(frame_id)

    def data(self) -> bytes:
        return bytes(self.parts)


# --- message decoders -------------------------------------------------------


@dataclass
class ImuMsg:
    t_ns: int
    gyro: np.ndarray  # (3,)
    acc: np.ndarray  # (3,)
    orientation: np.ndarray  # (4,) xyzw


@dataclass
class ImageMsg:
    t_ns: int
    image: np.ndarray  # (H,W) or (H,W,3) uint8


@dataclass
class ScalarMsg:
    t_ns: int
    value: float


def decode_imu(buf: bytes) -> ImuMsg:
    r = CdrReader(buf)
    t_ns, _ = r.header()
    orientation = r.f64_array(4)  # x y z w
    r.f64_array(9)
    gyro = r.f64_array(3)
    r.f64_array(9)
    acc = r.f64_array(3)
    r.f64_array(9)
    return ImuMsg(t_ns=t_ns, gyro=gyro, acc=acc, orientation=orientation)


def decode_image(buf: bytes) -> ImageMsg:
    r = CdrReader(buf)
    t_ns, _ = r.header()
    height, width = r.u32(), r.u32()
    encoding = r.string()
    r.u8()  # is_bigendian
    step = r.u32()
    data = r.bytes_seq()
    arr = np.frombuffer(data, np.uint8)
    if encoding in ("mono8", "8UC1"):
        img = arr.reshape(height, step)[:, :width]
    elif encoding in ("bgr8", "rgb8", "8UC3"):
        img = arr.reshape(height, step // 3, 3)[:, :width]
        if encoding == "rgb8":
            img = img[..., ::-1]
        # VIO consumes intensity; mirror cv_bridge mono conversion
        img = np.round(
            0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
        ).astype(np.uint8)
    elif encoding in ("mono16", "16UC1"):
        img = (
            np.frombuffer(data, np.uint16).reshape(height, step // 2)[:, :width]
            >> 8
        ).astype(np.uint8)
    else:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    return ImageMsg(t_ns=t_ns, image=np.ascontiguousarray(img))


def decode_compressed_image(buf: bytes) -> ImageMsg:
    import cv2

    r = CdrReader(buf)
    t_ns, _ = r.header()
    r.string()  # format, e.g. "png"/"jpeg"
    data = r.bytes_seq()
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError("cv2 could not decode CompressedImage payload")
    return ImageMsg(t_ns=t_ns, image=img)


def decode_fluid_pressure(buf: bytes) -> ScalarMsg:
    """sensor_msgs/FluidPressure (Pa) → water depth in metres (the ROS 2
    stand-in for the reference's ROS1-only bar30/Depth message,
    Subscriber.cpp:245-258): depth = gauge pressure / (rho g)."""
    r = CdrReader(buf)
    t_ns, _ = r.header()
    pressure = r.f64()
    r.f64()  # variance
    depth = max(pressure - 101325.0, 0.0) / (997.0 * 9.80665)
    return ScalarMsg(t_ns=t_ns, value=depth)


def decode_range(buf: bytes) -> ScalarMsg:
    """sensor_msgs/Range → sonar range (ROS 2 stand-in for
    imagenex831l/ProcessedRange, whose intensity-profile extraction lives in
    dataset.sonar_range_from_intensity)."""
    r = CdrReader(buf)
    t_ns, _ = r.header()
    r.u8()  # radiation_type
    r.f32()  # field_of_view
    r.f32()  # min_range
    r.f32()  # max_range
    rng = r.f32()
    return ScalarMsg(t_ns=t_ns, value=float(rng))


DECODERS: Dict[str, Callable[[bytes], object]] = {
    "sensor_msgs/msg/Imu": decode_imu,
    "sensor_msgs/msg/Image": decode_image,
    "sensor_msgs/msg/CompressedImage": decode_compressed_image,
    "sensor_msgs/msg/FluidPressure": decode_fluid_pressure,
    "sensor_msgs/msg/Range": decode_range,
}


# ---------------------------------------------------------------------------
# Storage layer (SQLite, rosbag2 default)
# ---------------------------------------------------------------------------


@dataclass
class BagMessage:
    t_ns: int  # receive timestamp from the messages table
    topic: str
    type: str
    raw: bytes


def _bag_db_files(path: str) -> Tuple[List[str], Optional[str]]:
    """Accept a .db3 file or a bag directory; return (db files, compression
    mode) with mode one of None/'file'/'message'."""
    if os.path.isfile(path) and not path.endswith(".metadata.yaml"):
        return [path], None
    meta = os.path.join(path, "metadata.yaml")
    mode = None
    if os.path.exists(meta):
        text = open(meta).read()
        if "compression_format: zstd" in text:
            if "compression_mode: FILE" in text:
                mode = "file"
            elif "compression_mode: MESSAGE" in text:
                mode = "message"
    files = sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if f.endswith(".db3") or f.endswith(".db3.zst")
    )
    if not files:
        raise FileNotFoundError(f"no .db3 storage files under {path}")
    return files, mode


def _maybe_decompress_file(path: str) -> str:
    if not path.endswith(".zst"):
        return path
    import tempfile

    import zstandard

    out = tempfile.NamedTemporaryFile(suffix=".db3", delete=False)
    with open(path, "rb") as f:
        zstandard.ZstdDecompressor().copy_stream(f, out)
    out.close()
    return out.name


def read_bag_messages(
    path: str, topics: Optional[List[str]] = None
) -> Iterator[BagMessage]:
    """Yield raw messages in timestamp order across all storage files."""
    files, mode = _bag_db_files(path)
    dctx = None
    if mode == "message" or any(f.endswith(".zst") for f in files):
        import zstandard

        dctx = zstandard.ZstdDecompressor()
    for f in files:
        con = sqlite3.connect(_maybe_decompress_file(f))
        try:
            tmap = {
                tid: (name, typ)
                for tid, name, typ in con.execute(
                    "SELECT id, name, type FROM topics"
                )
            }
            q = (
                "SELECT topic_id, timestamp, data FROM messages "
                "ORDER BY timestamp"
            )
            for tid, ts, data in con.execute(q):
                name, typ = tmap[tid]
                if topics is not None and name not in topics:
                    continue
                raw = bytes(data)
                if mode == "message":
                    raw = dctx.decompress(raw)
                yield BagMessage(t_ns=ts, topic=name, type=typ, raw=raw)
        finally:
            con.close()


# ---------------------------------------------------------------------------
# Event stream (okvis_node_synchronous / stereo_sync analog)
# ---------------------------------------------------------------------------


def read_rosbag(
    path: str,
    cam_topics: List[str],
    imu_topic: str = "/imu",
    depth_topic: Optional[str] = None,
    sonar_topic: Optional[str] = None,
    sync_tolerance_s: float = 0.02,
    skip_first_s: float = 0.0,
    decoders: Optional[Dict[str, Callable[[bytes], object]]] = None,
) -> Iterator[SensorEvent]:
    """Bag → timestamp-ordered SensorEvent stream.

    Camera topics are paired with approximate-time sync and re-stamped to
    the pair midpoint, dropping non-increasing stamps (stereo_sync.cpp:
    imageCallback); ``skip_first_s`` mirrors okvis_node_synchronous's
    optional skip-first-seconds argument.
    """
    dec = dict(DECODERS)
    if decoders:
        dec.update(decoders)
    wanted = list(cam_topics) + [imu_topic]
    if depth_topic:
        wanted.append(depth_topic)
    if sonar_topic:
        wanted.append(sonar_topic)

    n_cams = len(cam_topics)
    pending: List[List[ImageMsg]] = [[] for _ in range(n_cams)]
    prev_stamp = -1
    t0 = None

    def flush_frames() -> Iterator[SensorEvent]:
        nonlocal prev_stamp
        while all(pending):
            heads = [p[0] for p in pending]
            ts = [h.t_ns for h in heads]
            if max(ts) - min(ts) > sync_tolerance_s * 1e9:
                pending[int(np.argmin(ts))].pop(0)  # drop the stale head
                continue
            mid = (min(ts) + max(ts)) // 2
            for p in pending:
                p.pop(0)
            if mid <= prev_stamp:
                continue
            prev_stamp = mid
            yield SensorEvent(
                t=mid * 1e-9, kind="frame", images=[h.image for h in heads]
            )

    for msg in read_bag_messages(path, topics=wanted):
        if msg.type not in dec:
            continue
        m = dec[msg.type](msg.raw)
        t_ns = getattr(m, "t_ns", msg.t_ns) or msg.t_ns
        if t0 is None:
            t0 = t_ns
        if (t_ns - t0) * 1e-9 < skip_first_s:
            continue
        if msg.topic == imu_topic:
            yield SensorEvent(t=t_ns * 1e-9, kind="imu", imu=(m.gyro, m.acc))
        elif msg.topic in cam_topics:
            pending[cam_topics.index(msg.topic)].append(m)
            yield from flush_frames()
        elif depth_topic and msg.topic == depth_topic:
            yield SensorEvent(t=t_ns * 1e-9, kind="depth", depth=m.value)
        elif sonar_topic and msg.topic == sonar_topic:
            yield SensorEvent(
                t=t_ns * 1e-9, kind="sonar", sonar=(m.value, 0.0)
            )


def convert_bag_to_euroc(
    path: str,
    out_dir: str,
    cam_topics: List[str],
    imu_topic: str = "/imu",
) -> Dict[str, int]:
    """Bag → EuRoC-layout folder (``cam{i}/data/*.png`` + ``data.csv``,
    ``imu0/data.csv``) — the dataset_convertor analog. Returns counts."""
    import cv2

    dec = DECODERS
    counts = {"imu": 0, **{f"cam{i}": 0 for i in range(len(cam_topics))}}
    imu_dir = os.path.join(out_dir, "imu0")
    os.makedirs(imu_dir, exist_ok=True)
    cam_dirs = []
    for i in range(len(cam_topics)):
        d = os.path.join(out_dir, f"cam{i}", "data")
        os.makedirs(d, exist_ok=True)
        cam_dirs.append(d)
    imu_f = open(os.path.join(imu_dir, "data.csv"), "w")
    imu_f.write(
        "#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
        "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
        "a_RS_S_z [m s^-2]\n"
    )
    cam_fs = []
    for i in range(len(cam_topics)):
        f = open(os.path.join(out_dir, f"cam{i}", "data.csv"), "w")
        f.write("#timestamp [ns],filename\n")
        cam_fs.append(f)
    try:
        for msg in read_bag_messages(path, topics=list(cam_topics) + [imu_topic]):
            if msg.type not in dec:
                continue
            m = dec[msg.type](msg.raw)
            if msg.topic == imu_topic:
                imu_f.write(
                    f"{m.t_ns},{m.gyro[0]},{m.gyro[1]},{m.gyro[2]},"
                    f"{m.acc[0]},{m.acc[1]},{m.acc[2]}\n"
                )
                counts["imu"] += 1
            elif msg.topic in cam_topics:
                i = cam_topics.index(msg.topic)
                name = f"{m.t_ns}.png"
                cv2.imwrite(os.path.join(cam_dirs[i], name), m.image)
                cam_fs[i].write(f"{m.t_ns},{name}\n")
                counts[f"cam{i}"] += 1
    finally:
        imu_f.close()
        for f in cam_fs:
            f.close()
    return counts


# ---------------------------------------------------------------------------
# Writer (round-trip tests; dataset → bag re-export)
# ---------------------------------------------------------------------------


class RosbagWriter:
    """Minimal rosbag2-compatible SQLite writer (uncompressed, CDR)."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        name = os.path.basename(os.path.normpath(path))
        self.db_path = os.path.join(path, f"{name}_0.db3")
        self.dir = path
        self.con = sqlite3.connect(self.db_path)
        self.con.executescript(
            """
            CREATE TABLE topics(
              id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT NOT NULL,
              serialization_format TEXT NOT NULL,
              offered_qos_profiles TEXT NOT NULL);
            CREATE TABLE messages(
              id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,
              timestamp INTEGER NOT NULL, data BLOB NOT NULL);
            """
        )
        self.topic_ids: Dict[str, int] = {}
        self.count = 0

    def add_topic(self, name: str, type_: str) -> int:
        tid = len(self.topic_ids) + 1
        self.con.execute(
            "INSERT INTO topics VALUES (?,?,?,?,?)", (tid, name, type_, "cdr", "")
        )
        self.topic_ids[name] = tid
        return tid

    def write(self, topic: str, t_ns: int, raw: bytes) -> None:
        self.count += 1
        self.con.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)",
            (self.topic_ids[topic], t_ns, sqlite3.Binary(raw)),
        )

    def write_imu(self, topic: str, t_ns: int, gyro, acc) -> None:
        w = CdrWriter()
        w.header(t_ns)
        w.f64_array([0.0, 0.0, 0.0, 1.0])
        w.f64_array(np.zeros(9))
        w.f64_array(gyro)
        w.f64_array(np.zeros(9))
        w.f64_array(acc)
        w.f64_array(np.zeros(9))
        self.write(topic, t_ns, w.data())

    def write_image(self, topic: str, t_ns: int, image: np.ndarray) -> None:
        img = np.ascontiguousarray(np.asarray(image, np.uint8))
        w = CdrWriter()
        w.header(t_ns)
        w.u32(img.shape[0])
        w.u32(img.shape[1])
        w.string("mono8")
        w.u8(0)
        w.u32(img.shape[1])
        w.bytes_seq(img.tobytes())
        self.write(topic, t_ns, w.data())

    def write_compressed_image(
        self, topic: str, t_ns: int, image: np.ndarray, fmt: str = "png"
    ) -> None:
        import cv2

        ok, enc = cv2.imencode("." + fmt, np.asarray(image, np.uint8))
        if not ok:
            raise ValueError("cv2.imencode failed")
        w = CdrWriter()
        w.header(t_ns)
        w.string(fmt)
        w.bytes_seq(enc.tobytes())
        self.write(topic, t_ns, w.data())

    def write_fluid_pressure(self, topic: str, t_ns: int, depth_m: float) -> None:
        w = CdrWriter()
        w.header(t_ns)
        w.f64(101325.0 + depth_m * 997.0 * 9.80665)
        w.f64(0.0)
        self.write(topic, t_ns, w.data())

    def write_range(self, topic: str, t_ns: int, range_m: float) -> None:
        w = CdrWriter()
        w.header(t_ns)
        w.u8(0)
        for v in (0.1, 0.0, 100.0, range_m):
            w._prim("f", 4, v)
        self.write(topic, t_ns, w.data())

    def close(self) -> None:
        self.con.commit()
        self.con.close()
        with open(os.path.join(self.dir, "metadata.yaml"), "w") as f:
            f.write(
                "rosbag2_bagfile_information:\n"
                "  version: 5\n"
                "  storage_identifier: sqlite3\n"
                f"  relative_file_paths:\n    - {os.path.basename(self.db_path)}\n"
                f"  message_count: {self.count}\n"
                "  compression_format: \"\"\n"
                "  compression_mode: \"\"\n"
            )
