"""Image preprocessing ops: resize, blur, histogram equalization, CLAHE.

Counterpart of the JAX package's ``ops/image.py``: the reference's OpenCV
preprocessing chain (resize by resizeFactor → optional median blur → CLAHE
or global hist-eq) on float32 images in [0, 1]. Every op takes (..., H, W)
and keeps leading batch dims (one image per camera). The JAX package's
dense one-hot tile histograms become one scatter-add over (tile, bin) ids, and
its four tile-CDF lookups become advanced indexing.
"""
from __future__ import annotations

import math

import torch


def to_float(img: torch.Tensor) -> torch.Tensor:
    if img.dtype == torch.uint8:
        return img.to(torch.float32) / 255.0
    return img.to(torch.float32)


def _edge_rows(img: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """Pad rows (dim -2) by edge replication."""
    h = img.shape[-2]
    idx = torch.clamp(torch.arange(-top, h + bottom, device=img.device), 0, h - 1)
    return img.index_select(-2, idx)


def _edge_cols(img: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Pad columns (dim -1) by edge replication."""
    w = img.shape[-1]
    idx = torch.clamp(torch.arange(-left, w + right, device=img.device), 0, w - 1)
    return img.index_select(-1, idx)


def pad_edge(img: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    return _edge_cols(_edge_rows(img, top, bottom), left, right)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize (align_corners=False, OpenCV-compatible sampling).
    Sample coordinates are computed in float64, weights cast to the image's
    dtype."""
    h, w = img.shape[-2:]
    dev = img.device
    ys = (torch.arange(out_h, device=dev, dtype=torch.float64) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, device=dev, dtype=torch.float64) + 0.5) * (w / out_w) - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0).to(img.dtype)
    wx = torch.clamp(xs - x0, 0.0, 1.0).to(img.dtype)
    y0i, y1i, x0i, x1i = y0.long(), y1.long(), x0.long(), x1.long()
    r0, r1 = img.index_select(-2, y0i), img.index_select(-2, y1i)
    top = r0.index_select(-1, x0i) * (1 - wx) + r0.index_select(-1, x1i) * wx
    bot = r1.index_select(-1, x0i) * (1 - wx) + r1.index_select(-1, x1i) * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


def _separable_conv(img: torch.Tensor, k) -> torch.Tensor:
    """Same-size separable filter with edge replication; ``k`` is a 1-D
    tensor of taps, applied as a left-to-right sum of shifted copies."""
    n = k.shape[0]
    r = n // 2
    h, w = img.shape[-2:]
    p = _edge_rows(img, r, r)
    rows = sum(p[..., i:i + h, :] * k[i] for i in range(n))
    p = _edge_cols(rows, r, r)
    return sum(p[..., :, i:i + w] * k[i] for i in range(n))


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    return _separable_conv(img, k)


def median_blur3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median filter: the middle of the 9 shifted copies."""
    p = pad_edge(img, 1, 1, 1, 1)
    h, w = img.shape[-2:]
    stack = torch.stack([p[..., dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)])
    return torch.sort(stack, dim=0).values[4]


def _bin_index(img: torch.Tensor, bins: int) -> torch.Tensor:
    v = torch.clamp(img, 0.0, 1.0)
    return torch.clamp((v * (bins - 1)).to(torch.int64), 0, bins - 1)


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """float32 histogram of ``ids`` over n bins (``torch.bincount`` reads
    the largest id on the host on CUDA; this does not wait)."""
    ones = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    return torch.zeros(n, dtype=torch.float32, device=ids.device).index_add_(0, ids, ones)


def hist_equalize(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Global histogram equalization (cv::equalizeHist analog), per image."""
    idx = _bin_index(img, bins)
    lead = idx.shape[:-2]
    flat = idx.reshape(-1, idx.shape[-2] * idx.shape[-1])
    n = flat.shape[0]
    ids = flat + bins * torch.arange(n, device=img.device)[:, None]
    hist = _count(ids.reshape(-1), n * bins).reshape(n, bins)
    cdf = torch.cumsum(hist, dim=1)
    # OpenCV semantics: normalize by the first occupied bin's cdf
    cdf_min = torch.amin(torch.where(hist > 0, cdf, torch.full_like(cdf, math.inf)), dim=1, keepdim=True)
    out = (torch.gather(cdf, 1, flat) - cdf_min) / torch.clamp(cdf[:, -1:] - cdf_min, min=1.0)
    return out.reshape(lead + idx.shape[-2:])


def clahe(img: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8,
          bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization (cv::createCLAHE
    analog). The image is edge-padded to a multiple of the tile grid;
    per-tile histograms are clipped at ``clip_limit × mean`` with uniform
    redistribution, turned into CDFs, and sampled with bilinear
    interpolation between the four surrounding tile CDFs."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    dev = img.device
    th = -(-h // tiles_y)
    tw = -(-w // tiles_x)
    ph, pw = th * tiles_y, tw * tiles_x
    idx = _bin_index(pad_edge(img, 0, ph - h, 0, pw - w), bins)  # (..., ph, pw)
    idx = idx.reshape((-1, ph, pw))
    n = idx.shape[0]
    T = tiles_y * tiles_x

    # per-(image, tile) histograms as one bincount over (image, tile, bin)
    tile_y = torch.arange(ph, device=dev) // th
    tile_x = torch.arange(pw, device=dev) // tw
    tile = (tile_y[:, None] * tiles_x + tile_x[None, :])  # (ph, pw)
    ids = (torch.arange(n, device=dev)[:, None, None] * T + tile) * bins + idx
    counts = _count(ids.reshape(-1), n * T * bins).reshape(n, T, bins)

    # clip + redistribute (OpenCV semantics: limit relative to mean count)
    limit = max(clip_limit * (th * tw) / bins, 1.0)
    clipped = torch.clamp(counts, max=limit)
    excess = torch.sum(counts - clipped, dim=-1, keepdim=True)
    clipped = clipped + excess / bins
    cdf = torch.cumsum(clipped, dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1.0)
    cdf = cdf.reshape(n, tiles_y, tiles_x, bins)

    # bilinear blend of the 4 neighboring tile mappings at every pixel
    yy = torch.arange(ph, dtype=torch.float32, device=dev)
    xx = torch.arange(pw, dtype=torch.float32, device=dev)
    ty = (yy + 0.5) / th - 0.5
    tx = (xx + 0.5) / tw - 0.5
    ty0 = torch.clamp(torch.floor(ty), 0, tiles_y - 1)
    tx0 = torch.clamp(torch.floor(tx), 0, tiles_x - 1)
    ty1 = torch.clamp(ty0 + 1, 0, tiles_y - 1)
    tx1 = torch.clamp(tx0 + 1, 0, tiles_x - 1)
    wy = torch.clamp(ty - ty0, 0.0, 1.0)[:, None]
    wx = torch.clamp(tx - tx0, 0.0, 1.0)[None, :]
    ty0i, ty1i, tx0i, tx1i = ty0.long(), ty1.long(), tx0.long(), tx1.long()
    img_i = torch.arange(n, device=dev)[:, None, None]

    def lookup(tyi, txi):
        # cdf[image, tyi[y], txi[x], idx[image, y, x]] for all pixels
        return cdf[img_i, tyi[None, :, None], txi[None, None, :], idx]

    out = (
        lookup(ty0i, tx0i) * (1 - wy) * (1 - wx)
        + lookup(ty0i, tx1i) * (1 - wy) * wx
        + lookup(ty1i, tx0i) * wy * (1 - wx)
        + lookup(ty1i, tx1i) * wy * wx
    )
    return out[:, :h, :w].reshape(lead + (h, w))


def preprocess(
    img: torch.Tensor,
    resize_factor: float = 1.0,
    use_median: bool = False,
    histogram_method: str = "NONE",
    clahe_clip_limit: float = 2.0,
    clahe_tiles: int = 8,
) -> torch.Tensor:
    """The preprocessing chain as one function: resize by ``resizeFactor`` →
    optional 3x3 median → CLAHE (clip limit + tile grid) or global hist-eq.
    The resize output shape is static per (input shape, factor), matching the
    rescaled intrinsics of the config loader."""
    out = to_float(img)
    if resize_factor != 1.0:
        out = resize_bilinear(
            out,
            int(round(out.shape[-2] * resize_factor)),
            int(round(out.shape[-1] * resize_factor)),
        )
    if use_median:
        out = median_blur3(out)
    method = histogram_method.upper()
    if method == "HISTOGRAM":
        out = hist_equalize(out)
    elif method == "CLAHE":
        out = clahe(out, clip_limit=clahe_clip_limit, tiles_y=clahe_tiles, tiles_x=clahe_tiles)
    return out
