"""Oriented 256-bit binary descriptor (BRISK/BRIEF-class) + bit packing.

Counterpart of the JAX package's ``ops/descriptor.py``: a fixed
pseudo-random pairwise-intensity-test pattern (numpy seed 42, so
bit-identical to the JAX package's), rotated by the shared extraction angle,
sampled bilinearly from a Gaussian-smoothed image, packed into 8 32-bit
words held as int32 (the bit-identical view of the JAX package's uint32).

The JAX package samples with one (K, P²) × (P², 512) matmul against a
bilinear selection matrix (an MXU device). Here each sample gathers its four
corners directly, with the selection matrix's indexing: a corner's row in
that matrix is its flat index into the P×P patch, so at extraction angles
where the rotated pattern leaves the patch a corner wraps into a
neighbouring patch row (see ``px`` in ``describe``). The four products are
summed in the order of the matrix's nonzero entries. Over the CPU tests'
frames the descriptors are bit-identical to the JAX package's; a bit whose
two samples tie to float32 rounding could still differ.
"""
from __future__ import annotations

import numpy as np
import torch

from .image import gaussian_blur, pad_edge

DESC_BITS = 256
DESC_WORDS = DESC_BITS // 32
PATCH_RADIUS = 16.0


def _make_pattern(seed: int = 42) -> np.ndarray:
    """(256, 2, 2) array of (pointA, pointB) offsets, Gaussian-distributed
    (sigma = radius/5, ORB-style), clipped to the patch."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(DESC_BITS, 2, 2) * (PATCH_RADIUS / 5.0 * 2.0)
    return np.clip(pts, -PATCH_RADIUS + 1, PATCH_RADIUS - 1)


PATTERN = _make_pattern().astype(np.float32)  # (256,2,2)


def _sample_positions(ang0: torch.Tensor, max_octave: int, P: int):
    """Per octave, the 512 rotated, scaled sample positions in patch
    coordinates: integer corners (x0, y0) and fractions (fx, fy), each
    (max_octave+1, 512)."""
    dtype, dev = ang0.dtype, ang0.device
    ca, sa = torch.cos(ang0), torch.sin(ang0)
    R = torch.stack([torch.stack([ca, -sa]), torch.stack([sa, ca])])
    base = torch.as_tensor(PATTERN, device=dev).reshape(2 * DESC_BITS, 2).to(dtype) @ R.T
    x0s, y0s, fxs, fys = [], [], [], []
    for L in range(max_octave + 1):
        pos = base * float(1 << L) + (P // 2)
        x0f = torch.floor(pos[:, 0])
        y0f = torch.floor(pos[:, 1])
        fxs.append(pos[:, 0] - x0f)
        fys.append(pos[:, 1] - y0f)
        x0s.append(x0f.to(torch.int64))
        y0s.append(y0f.to(torch.int64))
    return torch.stack(x0s), torch.stack(y0s), torch.stack(fxs), torch.stack(fys)


def describe(
    img: torch.Tensor,  # (H, W)
    uv: torch.Tensor,  # (K, 2)
    angle: torch.Tensor,  # () or (K,) extraction direction [rad]: its first element is used
    valid: torch.Tensor,  # (K,)
    smooth_sigma: float = 2.0,
    octave: torch.Tensor = None,  # (K,) int pyramid level; scales the pattern
    max_octave: int = 0,  # bound on octave values
) -> torch.Tensor:
    """Packed descriptors (K, 8) int32. Invalid keypoints get 0. Keypoints
    from coarser octaves sample a 2^octave-scaled pattern."""
    K = uv.shape[0]
    dtype, dev = img.dtype, img.device
    ang = angle.reshape(-1)
    ang0 = ang[0] if ang.shape[0] > 0 else torch.zeros((), dtype=dtype, device=dev)
    smoothed = gaussian_blur(img, sigma=smooth_sigma, radius=3)

    R_max = int(PATCH_RADIUS) * (1 << max_octave) + 2
    P = 2 * R_max + 2  # patch side, covers bilinear corners at max scale
    padded = pad_edge(smoothed, P, P, P, P)
    Hp, Wp = padded.shape
    # each keypoint's patch origin in the padded image, anchored at its
    # nearest pixel (clamped as a dynamic slice is)
    oy = torch.clamp(torch.round(uv[:, 1]).to(torch.int64) - P // 2 + P, 0, Hp - P)
    ox = torch.clamp(torch.round(uv[:, 0]).to(torch.int64) - P // 2 + P, 0, Wp - P)

    x0, y0, fx, fy = _sample_positions(ang0, max_octave, P)
    lv = torch.zeros(K, dtype=torch.int64, device=dev) if octave is None else octave.to(torch.int64)
    x0, y0 = x0[lv], y0[lv]  # (K, 512)
    fx, fy = fx[lv].to(dtype), fy[lv].to(dtype)
    flat = padded.reshape(-1)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def px(dy, dx):
        # the selection matrix's row is the flat index into the P×P patch,
        # with the JAX scatter's index rules: a corner past the patch's side
        # wraps into the next or previous patch row, a negative index counts
        # from the patch's end, and one past the end is dropped (reads 0)
        f = (y0 + dy) * P + (x0 + dx)
        f = torch.where(f < 0, f + P * P, f)
        inside = (f >= 0) & (f < P * P)
        f = torch.clamp(f, 0, P * P - 1)
        v = flat[(oy[:, None] + f // P) * Wp + (ox[:, None] + f % P)]
        return torch.where(inside, v, zero)

    vals = (
        px(0, 0) * ((1 - fx) * (1 - fy))
        + px(0, 1) * (fx * (1 - fy))
        + px(1, 0) * ((1 - fx) * fy)
        + px(1, 1) * (fx * fy)
    )
    vals = vals.reshape(K, DESC_BITS, 2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int64).reshape(K, DESC_WORDS, 32)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    packed = torch.sum(bits << shifts, dim=-1).to(torch.int32)  # wraps: the uint32 bits
    return torch.where(valid[:, None], packed, torch.zeros_like(packed))


def gravity_angles(uv: torch.Tensor, gravity_in_cam: torch.Tensor) -> torch.Tensor:
    """Extraction direction = image-plane projection of the camera-frame
    gravity direction, one (uniform) angle per keypoint; 0 when gravity is
    nearly along the optical axis."""
    gx, gy, gz = gravity_in_cam[..., 0], gravity_in_cam[..., 1], gravity_in_cam[..., 2]
    in_plane = torch.sqrt(gx * gx + gy * gy)
    stable = in_plane > 0.2 * torch.abs(gz)
    ang = torch.where(stable, torch.atan2(gy, gx), torch.zeros_like(gx))
    return ang[..., None].expand(uv.shape[:-1])
