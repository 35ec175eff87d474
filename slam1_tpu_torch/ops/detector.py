"""Tiled feature detection: FAST score -> NMS -> per-tile top-k ->
oriented rBRIEF descriptors, with fixed output capacity (counterpart of
`slam1_tpu/ops/detector.py`).

Every function takes a batch of images (B,H,W) — the stereo frontend
detects left and right in one pass — and returns `Features` with a
leading batch dimension. Pyramids with a scale factor other than 2
resize the full image per level with the reference's antialiased linear
filter (`resize_linear`). The score maps come from
`dispatch.fast_score` / `dispatch.fast_score_levels` (the CUDA kernel
for CUDA tensors; `detect_pyramid` scores all its levels in one launch).
Patch
extraction is a plain gather: the JAX version's tile-local one-hot
contractions (`detector.py:27-63`) select exactly one pixel per patch
element from the zero-padded blurred image.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from slam1_tpu_torch.config import DetectorConfig
from slam1_tpu_torch.ops import brief, dispatch, fast
from slam1_tpu_torch.types import Features


def _top_k_stable(x, k: int):
    """Top-k along the last dim with ties to the LOWEST index, as
    `lax.top_k` breaks them (`torch.topk` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _extract_patches(blurred, y, x, ph: int, pw: int, patch: int):
    """(B,N,P,P) patches of the blurred image at integer keypoints
    (y, x: (B,N)), zero outside the image — the values the reference's
    tile-local one-hot contractions select."""
    m = patch // 2
    bsz, h, w = blurred.shape
    bp = torch.nn.functional.pad(blurred, (m, m + pw - w, m, m + ph - h))
    offs = torch.arange(patch, device=blurred.device)
    rows = y[..., None, None] + offs[:, None]         # (B,N,P,1)
    cols = x[..., None, None] + offs[None, :]         # (B,N,1,P)
    bidx = torch.arange(bsz, device=blurred.device)[:, None, None, None]
    return bp[bidx, rows, cols]


def _paraboff(m, p, c):
    den = m + p - 2.0 * c
    ok = torch.abs(den) > 1e-9
    t = 0.5 * (m - p) / torch.where(ok, den, torch.ones_like(den))
    return torch.clamp(torch.where(ok, t, torch.zeros_like(t)), -0.5, 0.5)


def detect(img, cfg: DetectorConfig, valid_h=None, valid_w=None,
           raw=None) -> Features:
    """Detect + describe on a (B,H,W) float32 batch; valid_h/valid_w
    (ints) bound the usable region of a padded canvas. `raw` is the
    image's FAST score map where the caller already has it."""
    bsz, h, w = img.shape
    dev = img.device
    margin = cfg.patch_size // 2 + 1
    valid_h = h if valid_h is None else valid_h
    valid_w = w if valid_w is None else valid_w

    if raw is None:
        raw = dispatch.fast_score(img, cfg.fast_threshold, cfg.fast_arc)
    score = fast.nms(raw, cfg.nms_radius)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = ((ys >= margin) & (ys < valid_h - margin)
              & (xs >= margin) & (xs < valid_w - margin))
    score = torch.where(inside, score, torch.zeros_like(score))

    # Per-tile top-k (tiles padded with zero score to divide the canvas).
    gr, gc = cfg.grid_rows, cfg.grid_cols
    th = -(-h // gr)
    tw = -(-w // gc)
    ph, pw = th * gr, tw * gc
    score_p = torch.nn.functional.pad(score, (0, pw - w, 0, ph - h))
    tiles = score_p.reshape(bsz, gr, th, gc, tw).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(bsz, gr * gc, th * tw)
    top_scores, top_idx = _top_k_stable(tiles, cfg.kp_per_tile)  # (B,T,k)

    t_ids = torch.arange(gr * gc, device=dev)
    y = top_idx // tw + (t_ids // gc * th)[:, None]
    x = top_idx % tw + (t_ids % gc * tw)[:, None]
    yf = y.reshape(bsz, -1)
    xf = x.reshape(bsz, -1)

    # Subpixel refinement: 1D quadratic fit of the PRE-NMS score.
    yc = torch.clamp(yf, 1, h - 2)
    xc = torch.clamp(xf, 1, w - 2)
    bi = torch.arange(bsz, device=dev)[:, None]
    s0 = raw[bi, yc, xc]
    dx = _paraboff(raw[bi, yc, xc - 1], raw[bi, yc, xc + 1], s0)
    dy = _paraboff(raw[bi, yc - 1, xc], raw[bi, yc + 1, xc], s0)
    xy = torch.stack([xf.to(img.dtype) + dx, yf.to(img.dtype) + dy], dim=-1)
    scores = top_scores.reshape(bsz, -1)
    mask = scores > 0.0

    blurred = brief.gaussian_blur(img, cfg.blur_sigma)
    patches = _extract_patches(blurred, yf, xf, ph, pw, cfg.patch_size)
    n = yf.shape[1]
    patches = patches.reshape(bsz * n, cfg.patch_size, cfg.patch_size)
    angles = brief.orientation(patches)
    # Steering quantized to 30 deg bins (see the JAX detector).
    bin_w = 2.0 * torch.pi / 12.0
    angles = torch.round(angles / bin_w) * bin_w
    desc = brief._describe(patches, angles, _pattern_for(cfg, dev))
    return Features(xy=xy, score=scores, angle=angles.reshape(bsz, n),
                    desc=desc.reshape(bsz, n, -1), mask=mask)


def detect_batch(imgs, cfg: DetectorConfig, valid_h=None, valid_w=None):
    """The reference's name for detection over a leading batch axis:
    `detect` already takes a (B,H,W) batch."""
    return detect(imgs, cfg, valid_h, valid_w)


def block_mean2(img, pairwise: bool = False):
    """Mean of each 2x2 block of (..., H, W) with H, W even, rounded as
    the reference's `reshape(h2, 2, w2, 2).mean((1, 3))` rounds. XLA
    picks the order of those four additions by the row width: each row's
    pair first, (a + b) + (c + d), when W is a power of two, left to
    right, ((a + b) + c) + d, otherwise; a level made from another level
    in the same compiled program (levels 2 and up of the reference's
    jitted pyramids, `pairwise`) takes the pairs first whatever its
    width (measured on the CPU at 120x160, 97x133, 128x256 and
    376x1280; the two orders are 1 ulp apart on some pixels)."""
    a = img[..., 0::2, 0::2]
    b = img[..., 0::2, 1::2]
    c = img[..., 1::2, 0::2]
    d = img[..., 1::2, 1::2]
    w = img.shape[-1]
    if pairwise or w & (w - 1) == 0:
        return ((a + b) + (c + d)) / 4.0
    return (((a + b) + c) + d) / 4.0


def _downsample2(img, pairwise: bool = False):
    """Exact 2x2 average pool of (..., H, W); odd trailing rows/cols are
    edge-padded first. `pairwise` as in `block_mean2`."""
    h, w = img.shape[-2:]
    if h % 2 or w % 2:
        rows = torch.clamp(torch.arange(h + h % 2, device=img.device), 0,
                           h - 1)
        cols = torch.clamp(torch.arange(w + w % 2, device=img.device), 0,
                           w - 1)
        img = img[..., rows, :][..., :, cols]
    return block_mean2(img, pairwise)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) float32 weights of a linear resize with a triangle
    antialiasing filter, as `jax.image.resize(..., "linear",
    antialias=True)` builds them (`scale_and_translate`), rounded as
    XLA:CPU's compiled program rounds them at the test canvas's shapes:
    the division by the kernel's width is a product with its reciprocal,
    the weights' sample position one fused multiply-add (computed here
    in float64 and rounded once) and the normalising column sums, in row
    order, take it unfused. Made once per shape and device."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))          # the scale is a host float
    ks = max(inv, f32(1.0))                  # widened kernel (downsampling)
    a = np.arange(n_out, dtype=f32) + f32(0.5)

    def triangle(sample):
        x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
        return np.maximum(f32(0.0), f32(1.0) - x * (f32(1.0) / ks))

    sample = (a.astype(np.float64) * np.float64(inv) - 0.5).astype(f32)
    wts = triangle(sample)
    tot = np.zeros(n_out, f32)
    for row in triangle(a * inv - f32(0.5)):
        tot += row
    wts = np.where(np.abs(tot) > 1000.0 * np.finfo(f32).eps,
                   wts / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    wts = np.where(inside[None, :], wts, f32(0.0)).astype(f32)
    return torch.as_tensor(wts, device=device)


def resize_linear(img, nh: int, nw: int):
    """(B,H,W) -> (B,nh,nw): the reference's `jax.image.resize(img, (nh,
    nw), "linear", antialias=True)` as two products with the separable
    weight matrices, rows first (float32 throughout: the runtime keeps
    TF32 off)."""
    _, h, w = img.shape
    wh = _resize_weights(h, nh, img.device)
    ww = _resize_weights(w, nw, img.device)
    return (wh.T @ img) @ ww


def pyramid_levels(img, cfg: DetectorConfig):
    """The images `detect_pyramid` detects on, level 0 first: for a
    scale factor of 2 each level is the 2x2 mean of the one before; for
    any other factor s level l is the full image resized to
    (max(16, round(H / s^l)), max(16, round(W / s^l)))."""
    _, h, w = img.shape
    levels = [img]
    pow2 = abs(cfg.scale_factor - 2.0) < 1e-9
    for lvl in range(1, cfg.num_levels):
        if pow2:
            levels.append(_downsample2(levels[-1], pairwise=lvl > 1))
        else:
            s = cfg.scale_factor ** lvl
            levels.append(resize_linear(img, max(16, round(h / s)),
                                        max(16, round(w / s))))
    return levels


def detect_pyramid(img, cfg: DetectorConfig, valid_h=None,
                   valid_w=None) -> Features:
    """Multi-scale detect + describe on a (B,H,W) batch: level l is the
    image downsampled by s**l (`pyramid_levels`), detected with a grid
    shrunk by the same factor and described on the downsampled image;
    coordinates map back to full resolution (x_full = s*x + (s-1)/2).
    Multi-level output is padded to a multiple of 128 slots with masked
    entries, as in the reference, so slot indices agree."""
    _, h, w = img.shape
    valid_h = h if valid_h is None else valid_h
    valid_w = w if valid_w is None else valid_w
    levels = pyramid_levels(img, cfg)
    raws = dispatch.fast_score_levels(levels, cfg.fast_threshold,
                                      cfg.fast_arc)
    feats = []
    for lvl, (cur, raw) in enumerate(zip(levels, raws)):
        s = cfg.scale_factor ** lvl
        gr, gc = cfg.level_grid(lvl)
        lcfg = dataclasses.replace(cfg, grid_rows=gr, grid_cols=gc,
                                   num_levels=1)
        f = detect(cur, lcfg, valid_h=int(valid_h / s),
                   valid_w=int(valid_w / s), raw=raw)
        if lvl > 0:
            f = f._replace(xy=f.xy * s + (s - 1.0) / 2.0)
        feats.append(f)
    if len(feats) == 1:
        return feats[0]
    out = Features(*[torch.cat(parts, dim=1) for parts in zip(*feats)])
    pad = (-out.mask.shape[1]) % 128
    if pad:
        out = Features(*[
            torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])],
                      dim=1) for a in out])
    return out


@functools.lru_cache(maxsize=8)
def _pattern(n_pairs, radius, seed, device):
    return torch.as_tensor(brief.make_pattern(n_pairs, radius, seed),
                           device=device)


def _pattern_for(cfg: DetectorConfig, device):
    """The rBRIEF pattern, copied to `device` once per process."""
    return _pattern(cfg.brief_pairs, cfg.brief_radius, cfg.pattern_seed,
                    device)
