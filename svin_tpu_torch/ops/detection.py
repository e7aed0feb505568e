"""Keypoint detection: Harris corner score + NMS + spatially-capped top-K.

Counterpart of the JAX package's ``ops/detection.py`` (a Harris-scored
replacement for the reference's BRISK scale-space detector). Output is
fixed-shape: K keypoint slots (uv, score, valid, octave). Works on one
(H, W) image or a batch (B, H, W).

Selection order matches ``jax.lax.top_k``, which returns the lower index
first among equal values: the top K come from a stable descending sort
(``torch.topk`` promises no order for ties), so keypoint order, and every
index that depends on it, is the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .image import _edge_cols, _edge_rows, gaussian_blur

# Config→response threshold mapping: the reference's detector threshold
# (detection_options.threshold, default 40) applies to BRISK's integer Harris
# response (raw 3x3 Sobel on uint8 intensities, descaled >>18); this response
# uses unit-normalized Sobel (raw/8) on [0,1] intensities, so responses
# differ by (8*255)^4 with the 2^18 descale: threshold 40 maps to ~6.05e-7.
BRISK_THRESHOLD_SCALE = float(2 ** 18) / float((8 * 255) ** 4)


class Keypoints(NamedTuple):
    uv: torch.Tensor  # (..., K, 2) float pixel coords (x, y) at full resolution
    score: torch.Tensor  # (..., K)
    angle: torch.Tensor  # (..., K) orientation [rad] (filled by the descriptor stage)
    valid: torch.Tensor  # (..., K) bool
    octave: torch.Tensor = None  # (..., K) int32 pyramid level (0 = full res)


def harris_score(img: torch.Tensor, k: float = 0.04, sigma: float = 1.0) -> torch.Tensor:
    """Harris corner response on the full image."""
    sobel = torch.tensor([-0.5, 0.0, 0.5], dtype=img.dtype, device=img.device)
    smooth = torch.tensor([0.25, 0.5, 0.25], dtype=img.dtype, device=img.device)
    h, w = img.shape[-2:]

    # d/dx: central difference along x, then [1 2 1]/4 smoothing along y
    r = _edge_cols(img, 1, 1)
    gx = sum(r[..., :, i:i + w] * sobel[i] for i in range(3))
    c = _edge_rows(gx, 1, 1)
    Ix = sum(c[..., i:i + h, :] * smooth[i] for i in range(3))
    # d/dy: the same on the transposed image
    r = _edge_rows(img, 1, 1)
    gy = sum(r[..., i:i + h, :] * sobel[i] for i in range(3))
    c = _edge_cols(gy, 1, 1)
    Iy = sum(c[..., :, i:i + w] * smooth[i] for i in range(3))

    Ixx = gaussian_blur(Ix * Ix, sigma=sigma, radius=2)
    Iyy = gaussian_blur(Iy * Iy, sigma=sigma, radius=2)
    Ixy = gaussian_blur(Ix * Iy, sigma=sigma, radius=2)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    return det - k * tr * tr


def nms(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Keep local maxima in a (2r+1)² neighborhood (ties all kept)."""
    n = 2 * radius + 1
    s = score.reshape((-1, 1) + score.shape[-2:])
    mx = F.max_pool2d(s, n, stride=1, padding=radius)  # pads with -inf
    return (s >= mx).reshape(score.shape)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2×2 mean pooling (one pyramid level down)."""
    h, w = img.shape[-2:]
    h2, w2 = h // 2, w // 2
    a = img[..., : h2 * 2, : w2 * 2].reshape(img.shape[:-2] + (h2, 2, w2, 2))
    return a.mean(dim=(-3, -1))


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest along the last dim, the lower index first among equal
    values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _detect_level(img, max_keypoints: int, threshold, cell: int, cell_cap: int, border: int):
    """Single-scale Harris + NMS + (optional per-cell cap) + top-K on one
    pyramid level; returns (uv, score, valid) in this level's pixels."""
    h, w = img.shape[-2:]
    dev = img.device
    s = harris_score(img)
    keep = nms(s)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    in_border = (xx >= border) & (xx < w - border) & (yy >= border) & (yy < h - border)
    neg_inf = torch.full_like(s, -float("inf"))
    masked = torch.where(keep & in_border & (s > threshold), s, neg_inf)
    lead = masked.shape[:-2]
    if cell > 0:
        # keep the best `cell_cap` responses per tile: cell_cap rounds of
        # per-cell max selection, suppressing each round's winners
        cells_x = -(-w // cell)
        n_cells = -(-h // cell) * cells_x
        flat_cells = ((yy // cell) * cells_x + (xx // cell)).reshape(-1)
        remaining = masked.reshape(lead + (h * w,))
        selected = torch.full_like(remaining, -float("inf"))
        idx = flat_cells.expand_as(remaining)
        for _ in range(cell_cap):
            cell_max = torch.full(lead + (n_cells,), -float("inf"), dtype=s.dtype, device=dev)
            cell_max = cell_max.scatter_reduce(-1, idx, remaining, reduce="amax")
            is_win = (remaining == torch.gather(cell_max, -1, idx)) & torch.isfinite(remaining)
            selected = torch.where(is_win, remaining, selected)
            remaining = torch.where(is_win, torch.full_like(remaining, -float("inf")), remaining)
        masked = selected.reshape(lead + (h, w))
    scores, idx = top_k_stable(masked.reshape(lead + (h * w,)), max_keypoints)
    uv = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
    valid = torch.isfinite(scores)
    return uv, torch.where(valid, scores, torch.zeros_like(scores)), valid


def detect(
    img: torch.Tensor,
    max_keypoints: int = 400,
    threshold=1e-6,
    cell: int = 0,
    cell_cap: int = 8,
    border: int = 20,
    octaves: int = 0,
) -> Keypoints:
    """Detect up to K Harris corners. ``cell`` > 0 caps density to
    ``cell_cap`` keypoints per cell×cell tile. ``octaves`` > 0 adds coarser
    pyramid levels (2× mean-pooled each): each level detects independently,
    coordinates are mapped back to full resolution (center-aligned), and the
    global top-K by response is kept."""
    levels = []
    im = img
    for L in range(octaves + 1):
        uv, score, valid = _detect_level(
            im, max_keypoints, threshold, cell, max(cell_cap >> L, 1), max(border >> L, 4),
        )
        s = float(1 << L)
        uv0 = uv * s + (s - 1.0) / 2.0
        levels.append((uv0, score, valid, torch.full(valid.shape, L, dtype=torch.int32, device=img.device)))
        if L < octaves:
            im = _downsample2(im)
    if octaves == 0:
        uv0, score, valid, octv = levels[0]
    else:
        uv0 = torch.cat([l[0] for l in levels], dim=-2)
        score = torch.cat([l[1] for l in levels], dim=-1)
        valid = torch.cat([l[2] for l in levels], dim=-1)
        octv = torch.cat([l[3] for l in levels], dim=-1)
        top, idx = top_k_stable(torch.where(valid, score, torch.full_like(score, -float("inf"))),
                                max_keypoints)
        ok = torch.isfinite(top)
        uv0 = torch.gather(uv0, -2, idx[..., None].expand(idx.shape + (2,)))
        score = torch.where(ok, top, torch.zeros_like(top))
        valid = ok
        octv = torch.gather(octv, -1, idx)
    return Keypoints(
        uv=uv0, score=score, angle=torch.zeros(valid.shape, dtype=img.dtype, device=img.device),
        valid=valid, octave=octv,
    )


def quadrant_counts(kp: Keypoints, width: int, height: int) -> torch.Tensor:
    """Per-image-quadrant keypoint counts of one image's keypoints (4,)."""
    qx = (kp.uv[:, 0] >= width / 2).to(torch.int64)
    qy = (kp.uv[:, 1] >= height / 2).to(torch.int64)
    q = qy * 2 + qx
    return torch.zeros(4, dtype=torch.int32, device=kp.uv.device).index_add_(
        0, q, kp.valid.to(torch.int32))
