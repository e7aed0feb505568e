"""Output writers + debug visualization.

Counterpart of the JAX package's ``pipeline/outputs.py``, numpy and host
code on the port's ``FrameResult`` / ``Transformation``: CSV state and
landmark logs, keypoint and match overlays rendered into numpy images (no
drawing library needed), the loop-closure debug directory tree, and a
top-down trajectory view.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..kinematics import npq
from .vio import FrameResult


def _host(a) -> np.ndarray:
    """numpy view of an array or a (CPU or device) tensor."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class CsvStateWriter:
    """State log: timestamp, p_WS, q_WS, v, b_g, b_a (the okvis CSV state
    format)."""

    def __init__(self, path: str):
        self.f = open(path, "w")
        self.f.write(
            "#timestamp, p_WS_x, p_WS_y, p_WS_z, q_x, q_y, q_z, q_w,"
            " v_x, v_y, v_z, b_g_x, b_g_y, b_g_z, b_a_x, b_a_y, b_a_z\n"
        )

    def write(self, r: FrameResult) -> None:
        row = [r.timestamp, *_host(r.T_WS.r), *_host(r.T_WS.q), *_host(r.speed_bias)]
        self.f.write(", ".join(f"{v:.9f}" for v in row) + "\n")

    def close(self) -> None:
        self.f.close()


class CsvLandmarkWriter:
    """Landmark log: id, x, y, z, quality."""

    def __init__(self, path: str):
        self.f = open(path, "w")
        self.f.write("#id, p_W_x, p_W_y, p_W_z, quality\n")

    def write_map(self, lm_ids, points, quality) -> None:
        for i, p, q in zip(_host(lm_ids), _host(points), _host(quality)):
            self.f.write(f"{int(i)}, {p[0]:.6f}, {p[1]:.6f}, {p[2]:.6f}, {q:.4f}\n")

    def close(self) -> None:
        self.f.close()


# ------------------------------------------------------------ visualization
def _stamp_cross(img: np.ndarray, u: int, v: int, val: float, size: int = 2):
    h, w = img.shape[:2]
    for d in range(-size, size + 1):
        if 0 <= v + d < h and 0 <= u < w:
            img[v + d, u] = val
        if 0 <= v < h and 0 <= u + d < w:
            img[v, u + d] = val


def draw_keypoints(
    image: np.ndarray,
    uv: np.ndarray,
    valid: Optional[np.ndarray] = None,
    matched: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Keypoint overlay: matched keypoints bright (1.0), unmatched dim (0.6)
    on a [0, 1] copy of the image."""
    out = np.array(_host(image), np.float32, copy=True)
    if out.max() > 1.5:
        out /= 255.0
    uvn = _host(uv)
    n = len(uvn)
    valid = np.ones(n, bool) if valid is None else _host(valid)
    matched = np.zeros(n, bool) if matched is None else _host(matched)
    for k in range(n):
        if not valid[k]:
            continue
        u, v = int(round(uvn[k, 0])), int(round(uvn[k, 1]))
        _stamp_cross(out, u, v, 1.0 if matched[k] else 0.6)
    return out


def draw_matches(
    image_a: np.ndarray,
    uv_a: np.ndarray,
    image_b: np.ndarray,
    uv_b: np.ndarray,
    pairs: np.ndarray,  # (M,2) indices into uv_a / uv_b
) -> np.ndarray:
    """Side-by-side match view with connecting lines."""
    a = np.array(_host(image_a), np.float32, copy=True)
    b = np.array(_host(image_b), np.float32, copy=True)
    if a.max() > 1.5:
        a /= 255.0
    if b.max() > 1.5:
        b /= 255.0
    h = max(a.shape[0], b.shape[0])
    w = a.shape[1] + b.shape[1]
    canvas = np.zeros((h, w), np.float32)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    uv_a, uv_b = _host(uv_a), _host(uv_b)
    for ia, ib in _host(pairs):
        ua, va = uv_a[int(ia)]
        ub, vb = uv_b[int(ib)]
        _stamp_cross(canvas, int(round(ua)), int(round(va)), 1.0)
        _stamp_cross(canvas, int(round(ub)) + off, int(round(vb)), 1.0)
        # the line as stamps along a linear interpolation
        n = int(max(abs(ub + off - ua), abs(vb - va), 1))
        for u, v in zip(np.linspace(ua, ub + off, n), np.linspace(va, vb, n)):
            ui, vi = int(round(u)), int(round(v))
            if 0 <= vi < h and 0 <= ui < w:
                canvas[vi, ui] = max(canvas[vi, ui], 0.8)
    return canvas


class DebugOutputDirs:
    """Debug artifact directory tree: loop_candidates/, descriptor_matched/,
    pnp_verified/, loop_closure/, geometric_verification/ and the
    loop_closure.txt / switch_info.txt logs."""

    SUBDIRS = (
        "loop_candidates", "descriptor_matched", "pnp_verified",
        "loop_closure", "geometric_verification",
    )

    def __init__(self, root: str):
        self.root = root
        for d in self.SUBDIRS:
            os.makedirs(os.path.join(root, d), exist_ok=True)
        self.loop_log = open(os.path.join(root, "loop_closure.txt"), "w")
        self.switch_log = open(os.path.join(root, "switch_info.txt"), "w")

    def log_loop(self, query: int, match: int, inliers: int, rel_t, rel_yaw):
        t = _host(rel_t)
        self.loop_log.write(
            f"{query} {match} {inliers} {t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {rel_yaw:.4f}\n"
        )
        self.loop_log.flush()

    def log_switch(self, t: float, msg: str):
        self.switch_log.write(f"{t:.6f} {msg}\n")
        self.switch_log.flush()

    def save_image(self, subdir: str, name: str, image: np.ndarray, caption: str = ""):
        """Write a viewable .png (uint8; a [0, 1] float image is scaled),
        with an optional white caption banner 50 px high on top. Falls back
        to .npy without cv2."""
        arr = _host(image)
        if arr.dtype != np.uint8:
            a = arr.astype(np.float32)
            if a.size and a.max() <= 1.5:
                a = a * 255.0
            arr = np.clip(a, 0, 255).astype(np.uint8)
        path = os.path.join(self.root, subdir, name + ".png")
        try:
            import cv2

            if caption:
                banner = np.full((50, arr.shape[1]), 255, np.uint8)
                cv2.putText(banner, caption, (12, 32), cv2.FONT_HERSHEY_SIMPLEX, 0.8, 0, 2)
                arr = np.concatenate([banner, arr], axis=0)
            cv2.imwrite(path, arr)
        except ImportError:
            np.save(os.path.join(self.root, subdir, name + ".npy"), arr)

    def close(self):
        self.loop_log.close()
        self.switch_log.close()


# ------------------------------------------------------- top-down pose view
class TopDownViewer:
    """Top-down trajectory renderer without a GUI: the path height-colored
    (low blue, high red), the latest body axes drawn at ``frame_scale``
    meters, the canvas scaled to the trajectory's extent. ``render()``
    returns an (S, S, 3) uint8 RGB image; ``save()`` writes a PNG."""

    def __init__(self, image_size: int = 500, frame_scale: float = 0.2):
        self.size = int(image_size)
        self.frame_scale = float(frame_scale)
        self._path: List[np.ndarray] = []  # (x, y, z)
        self._C_last = np.eye(3)
        self._v_last = np.zeros(3)

    def add_pose(self, T_WS, velocity=None) -> None:
        self._path.append(_host(T_WS.r).astype(float).reshape(3))
        self._C_last = npq.to_rotation_matrix(_host(T_WS.q).astype(float))
        if velocity is not None:
            self._v_last = _host(velocity).astype(float).reshape(3)

    def add_result(self, r: FrameResult) -> None:
        self.add_pose(r.T_WS, r.speed_bias[:3])

    # -- drawing helpers -----------------------------------------------
    def _to_image(self, xy: np.ndarray, lo: np.ndarray, scale: float):
        pt = (xy - lo) * scale
        return pt[..., 0], self.size - pt[..., 1]  # y up

    @staticmethod
    def _draw_segment(img, u0, v0, u1, v1, color):
        n = int(max(abs(u1 - u0), abs(v1 - v0), 1)) + 1
        us = np.clip(np.round(np.linspace(u0, u1, n)).astype(int), 0, img.shape[1] - 1)
        vs = np.clip(np.round(np.linspace(v0, v1, n)).astype(int), 0, img.shape[0] - 1)
        img[vs, us] = color

    def render(self) -> np.ndarray:
        img = np.full((self.size, self.size, 3), 10, np.uint8)
        if len(self._path) < 2:
            return img
        path = np.asarray(self._path)
        fs = self.frame_scale
        lo = path[:, :2].min(axis=0) - fs
        hi = path[:, :2].max(axis=0) + fs
        scale = min(self.size / max(hi[0] - lo[0], 1e-9), self.size / max(hi[1] - lo[1], 1e-9))
        z = path[:, 2]
        z_lo, z_hi = z.min(), max(z.max(), z.min() + 1e-9)
        u, v = self._to_image(path[:, :2], lo, scale)
        for i in range(len(path) - 1):
            rel_h = (z[i] + z[i + 1] - 2 * z_lo) * 0.5 / (z_hi - z_lo)
            color = np.array([255 * rel_h, 0, 255 * (1 - rel_h)], np.uint8)  # RGB
            self._draw_segment(img, u[i], v[i], u[i + 1], v[i + 1], color)
        # body axes at the last pose (x red, y green, z blue)
        origin = path[-1, :2]
        axis_colors = ([255, 0, 0], [0, 255, 0], [0, 0, 255])
        for ax in range(3):
            tip = origin + self._C_last[:2, ax] * fs
            u0, v0 = self._to_image(origin, lo, scale)
            u1, v1 = self._to_image(tip, lo, scale)
            self._draw_segment(img, u0, v0, u1, v1, np.array(axis_colors[ax], np.uint8))
        return img

    def save(self, path: str) -> None:
        import cv2

        cv2.imwrite(path, self.render()[:, :, ::-1])  # RGB -> BGR
