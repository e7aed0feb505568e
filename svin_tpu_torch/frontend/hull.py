"""Convex-hull keyframe-overlap geometry (host-side, tiny point sets).

A copy of the JAX package's ``frontend/hull.py`` (numpy only).

The reference decides keyframe insertion from convex hulls of the matched
vs. all keypoints per camera (``Frontend::doWeNeedANewKeyframe``,
okvis_frontend/src/Frontend.cpp:265-332): overlap = area(hull of matched) /
area(hull of all), ratio = n_matched / #keypoints strictly inside the
matched hull, maxed over cameras; a new keyframe is needed unless
overlap > 0.6 and ratio > 0.2. Point sets are <=400 per camera so this is
plain NumPy on host — no device round-trip is worth it.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone-chain convex hull, CCW, no repeated endpoint.

    ``points`` is (N, 2); returns (H, 2). Collinear boundary points are
    dropped (like cv::convexHull's default). N < 3 returns the input.
    """
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    n = pts.shape[0]
    if n < 3:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def polygon_area(hull: np.ndarray) -> float:
    """Shoelace area of a simple polygon given as ordered vertices."""
    h = np.asarray(hull, dtype=np.float64)
    if h.shape[0] < 3:
        return 0.0
    x, y = h[:, 0], h[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def points_strictly_inside(hull: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Boolean mask: which ``points`` are strictly inside the convex hull
    (boundary excluded — mirrors ``cv::pointPolygonTest(...) > 0``)."""
    h = np.asarray(hull, dtype=np.float64)
    p = np.asarray(points, dtype=np.float64)
    if h.shape[0] < 3 or p.shape[0] == 0:
        return np.zeros(p.shape[0], dtype=bool)
    a = h
    b = np.roll(h, -1, axis=0)
    # cross((b-a), (p-a)) for every edge x point; CCW hull => inside is > 0
    ex = (b[:, 0] - a[:, 0])[:, None]
    ey = (b[:, 1] - a[:, 1])[:, None]
    px = p[None, :, 0] - a[:, 0][:, None]
    py = p[None, :, 1] - a[:, 1][:, None]
    cr = ex * py - ey * px
    return np.all(cr > 0.0, axis=0)


def keyframe_overlap_ratio(
    all_uv: Sequence[np.ndarray], matched_uv: Sequence[np.ndarray]
) -> Tuple[float, float]:
    """Max-over-cameras (overlap, matching-ratio) of the reference heuristic.

    ``all_uv[i]``/``matched_uv[i]`` are the (N_i, 2)/(M_i, 2) keypoint
    coordinates for camera i. Cameras with <3 points in either set are
    skipped (Frontend.cpp:300-303).
    """
    overlap = 0.0
    ratio = 0.0
    for pts_all, pts_m in zip(all_uv, matched_uv):
        pts_all = np.asarray(pts_all, dtype=np.float64)
        pts_m = np.asarray(pts_m, dtype=np.float64)
        if pts_all.shape[0] < 3 or pts_m.shape[0] < 3:
            continue
        hull_all = convex_hull(pts_all)
        hull_m = convex_hull(pts_m)
        area_all = polygon_area(hull_all)
        if area_all <= 0.0:
            continue
        overlap = max(overlap, polygon_area(hull_m) / area_all)
        n_inside = int(points_strictly_inside(hull_m, pts_all).sum())
        # reference divides without guarding (Frontend.cpp:320): 0 inside
        # points with >=3 matches gives +inf, i.e. the ratio gate passes
        ratio = max(
            ratio, pts_m.shape[0] / n_inside if n_inside else float("inf")
        )
    return overlap, ratio
