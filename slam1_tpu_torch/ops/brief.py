"""Orientation (intensity centroid) + steered rBRIEF 256-bit descriptors
(counterpart of `slam1_tpu/ops/brief.py`).

The sampling pattern comes from the same numpy `RandomState` draw, so
it is identical to the JAX package's. Descriptor sampling is a plain
gather: the JAX version expresses the same lookup as one-hot
contractions (`brief.py:129-134`), which select exactly one value per
sample.
"""

from __future__ import annotations

import numpy as np
import torch


def make_pattern(n_pairs: int = 256, radius: float = 13.0,
                 seed: int = 1234) -> np.ndarray:
    """(n_pairs, 2, 2) float32 (dx, dy) sample-pair offsets within a disk."""
    rng = np.random.RandomState(seed)
    pts = rng.normal(0.0, radius * 0.45, size=(n_pairs * 4, 2))
    pts = pts[np.linalg.norm(pts, axis=1) <= radius][:n_pairs * 2]
    while len(pts) < n_pairs * 2:  # pragma: no cover (overdraw covers this)
        extra = rng.normal(0.0, radius * 0.45, size=(n_pairs, 2))
        extra = extra[np.linalg.norm(extra, axis=1) <= radius]
        pts = np.concatenate([pts, extra])[:n_pairs * 2]
    return pts.reshape(n_pairs, 2, 2).astype(np.float32)


def gaussian_kernel(sigma: float, ksize: int) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, sigma: float = 1.4, ksize: int = 7):
    """Separable Gaussian blur of (..., H, W) images with edge padding,
    as ksize shifted weighted adds in tap order (the JAX version's
    order, so the sums round the same way)."""
    k = gaussian_kernel(sigma, ksize)
    r = ksize // 2
    h, w = img.shape[-2:]
    dev = img.device
    cols = torch.clamp(torch.arange(-r, w + r, device=dev), 0, w - 1)
    ph = img[..., :, cols]
    out = sum(float(k[j]) * ph[..., :, j:j + w] for j in range(ksize))
    rows = torch.clamp(torch.arange(-r, h + r, device=dev), 0, h - 1)
    pv = out[..., rows, :]
    return sum(float(k[j]) * pv[..., j:j + h, :] for j in range(ksize))


def extract_patches(img, xy, patch_size: int):
    """Gather (N, P, P) patches of an (H,W) image centred on
    integer-rounded keypoints; indices are clipped to the image."""
    h, w = img.shape
    r = patch_size // 2
    cx = torch.round(xy[..., 0]).long()
    cy = torch.round(xy[..., 1]).long()
    off = torch.arange(-r, r + 1, device=img.device)
    yy = torch.clamp(cy[:, None, None] + off[None, :, None], 0, h - 1)
    xx = torch.clamp(cx[:, None, None] + off[None, None, :], 0, w - 1)
    return img[yy, xx]


def orientation(patches):
    """Gaussian-weighted intensity-centroid angle per patch (N,P,P) ->
    (N,) radians, over the inscribed disk (see the JAX docstring for
    why the weighting is needed)."""
    p = patches.shape[-1]
    r = p // 2
    off = torch.arange(-r, r + 1, dtype=patches.dtype, device=patches.device)
    oy = off[:, None]
    ox = off[None, :]
    r2 = oy * oy + ox * ox
    disk = r2 <= r * r
    sig = r / 2.0
    g = torch.exp(-r2 / (2.0 * sig * sig))
    w = torch.where(disk, patches * g, torch.zeros_like(patches))
    m10 = torch.sum(w * ox, dim=(-2, -1))
    m01 = torch.sum(w * oy, dim=(-2, -1))
    return torch.atan2(m01, m10)


def _describe(patches, angles, pattern):
    """Steered rBRIEF bits from pre-extracted (N,P,P) patches.

    pattern: (B,2,2) tensor of (dx, dy) pairs. Returns (N, B//8) uint8,
    packed 8 bits per byte, LSB first.
    """
    n, p, _ = patches.shape
    n_pairs = pattern.shape[0]
    c = p // 2
    cos_t = torch.cos(angles)[:, None, None]    # (N,1,1)
    sin_t = torch.sin(angles)[:, None, None]
    px = pattern[None, :, :, 0]                 # (1,B,2)
    py = pattern[None, :, :, 1]
    rx = cos_t * px - sin_t * py                # (N,B,2)
    ry = sin_t * px + cos_t * py
    ix = torch.clamp(torch.round(rx).long() + c, 0, p - 1)
    iy = torch.clamp(torch.round(ry).long() + c, 0, p - 1)
    rows = torch.arange(n, device=patches.device)[:, None, None]
    vals = patches[rows, iy, ix]                # (N,B,2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.uint8)
    bits = bits.reshape(n, n_pairs // 8, 8)
    weights = (1 << torch.arange(8, device=patches.device)).to(torch.uint8)
    return torch.sum(bits * weights, dim=-1, dtype=torch.uint8)


def describe(img_blurred, xy, angles, pattern):
    """Steered rBRIEF on one (H,W) image that is already blurred.

    xy: (N,2) keypoint coords; angles: (N,); pattern: (B,2,2) array.
    Returns (N, B//8) uint8 packed descriptors.
    """
    pattern = torch.as_tensor(pattern, dtype=img_blurred.dtype).to(
        img_blurred.device)
    patch = 2 * int(np.ceil(float(pattern.abs().max()) * 1.5)) + 3
    patches = extract_patches(img_blurred, xy, max(patch, 33))
    return _describe(patches, angles, pattern)


def unpack_bits(desc_packed):
    """(..., B/8) uint8 -> (..., B) uint8 bits, LSB first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_packed.device)
    bits = (desc_packed[..., :, None] >> shifts) & 1
    return bits.reshape(desc_packed.shape[:-1] + (-1,))


def unpack_bits_pm1(desc_packed):
    """(..., B/8) uint8 -> (..., B) int8 in {-1,+1} (LSB first)."""
    return unpack_bits(desc_packed).to(torch.int8) * 2 - 1
