"""FAST-9 corner scoring and NMS in plain PyTorch (counterpart of
`slam1_tpu/ops/fast.py`).

`fast_score` is the plain twin of the CUDA kernel in
`csrc/fast_score.cu`: the CPU path of the detector, and the reference
the kernel is held against on the card. It follows the run-length form
of the TPU kernel (`slam1_tpu/ops/pallas_kernels.py:_fast_kernel`) and
sums the 16 taps in circle order 0..15, so the score agrees with both
JAX versions to the last bit and NMS (an exact `>=` compare) keeps the
same pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, 16 taps in circular order: (dy, dx).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BORDER = 3


def border_mask(h: int, w: int, device) -> torch.Tensor:
    """(H,W) bool: True where a pixel is >= BORDER px from every edge."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return ((ys >= BORDER) & (ys < h - BORDER)
            & (xs >= BORDER) & (xs < w - BORDER))


def fast_score(img, threshold: float, arc: int = 9):
    """FAST corner score map.

    Args:
      img: (..., H, W) float32 grayscale (any leading batch dims).
      threshold: intensity delta for brighter/darker classification.
      arc: required contiguous arc length (9 = FAST-9).
    Returns:
      (..., H, W) float32; 0 at non-corners and within 3 px of the
      border. Score = max over the two polarities of the sum of
      max(|diff| - threshold, 0) over the 16 taps.
    """
    zeros = torch.zeros_like(img, dtype=torch.int32)
    run_b, run_d = zeros, zeros
    corner = torch.zeros_like(img, dtype=torch.bool)
    score_b = torch.zeros_like(img)
    score_d = torch.zeros_like(img)
    n = len(CIRCLE)
    for t in range(n + arc - 1):
        dy, dx = CIRCLE[t % n]
        # Taps wrap around the edges; the border is zeroed below.
        tap = torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))
        diff = tap - img
        bright = diff > threshold
        dark = diff < -threshold
        run_b = torch.where(bright, run_b + 1, zeros)
        run_d = torch.where(dark, run_d + 1, zeros)
        corner = corner | (run_b >= arc) | (run_d >= arc)
        if t < n:
            score_b = score_b + torch.clamp(diff - threshold, min=0.0)
            score_d = score_d + torch.clamp(-diff - threshold, min=0.0)
    score = torch.maximum(score_b, score_d)
    keep = corner & border_mask(img.shape[-2], img.shape[-1], img.device)
    return torch.where(keep, score, torch.zeros_like(score))


def arc_mask(bits, arc: int):
    """The arc test as csrc/fast_score.cu makes it. `bits`: an integer
    tensor of 16-bit masks, bit k set where tap k of the circle passed
    its compare. True where >= `arc` consecutive taps on the circle are
    set: with m32 = m | m << 16, bit i of AND_{k < arc} (m32 >> k) says
    that taps i .. i + arc - 1 (mod 16) are all set."""
    m32 = bits.to(torch.int64)
    m32 = m32 | (m32 << 16)
    run = m32.clone()
    have = 1                      # bit i of run: bits i..i+have-1 set
    while 2 * have <= arc:
        run = run & (run >> have)
        have *= 2
    if have < arc:
        run = run & (run >> (arc - have))
    return (run & 0xFFFF) != 0


def nms(score, radius: int = 2):
    """Local-maximum suppression: keep pixels equal to the (2r+1)^2
    window max (-inf outside the image, as reduce_window "SAME")."""
    k = 2 * radius + 1
    s4 = score.reshape((-1, 1) + score.shape[-2:])
    neigh = F.max_pool2d(s4, k, stride=1, padding=radius).reshape(
        score.shape)
    return torch.where((score >= neigh) & (score > 0.0), score,
                       torch.zeros_like(score))
