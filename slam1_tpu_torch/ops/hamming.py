"""Brute-force Hamming descriptor matching (counterpart of
`slam1_tpu/ops/hamming.py`).

All three matchers reduce the (N, M) distance problem to per-row best /
second-best / argbest plus the per-column argmin through
`dispatch.hamming_top2`: on a CUDA tensor the fused kernel in
`csrc/hamming_top2.cu` (at any N and M), on a CPU tensor its dense
plain twin. Ties go to the lowest index, as `lax.top_k` and `argmin`
do in the reference, so the cross-check agrees exactly.
"""

from __future__ import annotations

import torch

from slam1_tpu_torch.ops import dispatch
from slam1_tpu_torch.ops.cuda_kernels import distance_matrix  # noqa: F401
from slam1_tpu_torch.types import Matches


def _finish(d1, d2, best, col_best, mask_a, ratio, max_distance,
            cross_check) -> Matches:
    ok = (d1 <= max_distance) & (d1.float() < ratio * d2.float())
    best = best.long()
    if cross_check:
        rows = torch.arange(best.shape[-1], device=best.device)
        ok = ok & (torch.gather(col_best.long(), -1, best) == rows)
    if mask_a is not None:
        ok = ok & mask_a
    return Matches(idx=best, distance=d1, mask=ok)


def _top2(desc_a, desc_b, mask_a, mask_b, **gate):
    """dispatch.hamming_top2 with absent masks taken as all-valid."""
    if mask_a is None:
        mask_a = torch.ones(desc_a.shape[:1], dtype=torch.bool,
                            device=desc_a.device)
    if mask_b is None:
        mask_b = torch.ones(desc_b.shape[:1], dtype=torch.bool,
                            device=desc_b.device)
    return dispatch.hamming_top2(desc_a, desc_b, mask_a, mask_b, **gate)


def match(desc_a, desc_b, mask_a=None, mask_b=None, *, ratio=0.8,
          max_distance=64, cross_check=True) -> Matches:
    """Best match with Lowe ratio test and optional mutual consistency."""
    d1, d2, best, col_best = _top2(desc_a, desc_b, mask_a, mask_b)
    return _finish(d1, d2, best, col_best, mask_a, ratio, max_distance,
                   cross_check)


def match_batched(desc_a, desc_b, mask_a, mask_b, *, ratio=0.8,
                  max_distance=64, cross_check=True) -> Matches:
    """`match` over a leading batch axis: (B,N,32) x (B,M,32) with (B,N),
    (B,M) masks, one kernel launch for the whole batch on CUDA."""
    d1, d2, best, col_best = dispatch.hamming_top2_batched(
        desc_a, desc_b, mask_a, mask_b)
    return _finish(d1, d2, best, col_best, mask_a, ratio, max_distance,
                   cross_check)


def match_epipolar(desc_a, desc_b, xy_a, xy_b, mask_a, mask_b, *,
                   ratio=0.8, max_distance=64, dy_tol=2.0,
                   min_disparity=0.25, max_disparity=96.0,
                   cross_check=True) -> Matches:
    """Rectified-stereo matching: the epipolar band (|dy| <= dy_tol,
    disparity in [min, max]) is applied BEFORE best/second-best
    selection, so the ratio test compares geometrically plausible
    rivals only."""
    d1, d2, best, col_best = _top2(
        desc_a, desc_b, mask_a, mask_b, uv_a=xy_a, uv_b=xy_b,
        dy_tol=float(dy_tol), dx_lo=float(min_disparity),
        dx_hi=float(max_disparity))
    return _finish(d1, d2, best, col_best, mask_a, ratio, max_distance,
                   cross_check)


def match_windowed(desc_a, desc_b, uv_pred_a, xy_b, mask_a, mask_b, *,
                   radius, ratio=0.8, max_distance=64,
                   cross_check=True) -> Matches:
    """Prediction-gated matching: B candidates outside an axis-aligned
    `radius`-px square around each A row's predicted position are
    gated out before best/second-best selection."""
    d1, d2, best, col_best = _top2(
        desc_a, desc_b, mask_a, mask_b, uv_a=uv_pred_a, uv_b=xy_b,
        dy_tol=float(radius), dx_lo=-float(radius), dx_hi=float(radius))
    return _finish(d1, d2, best, col_best, mask_a, ratio, max_distance,
                   cross_check)


def gather_matches(values_b, matches: Matches, fill=0.0):
    """Gather per-match rows of `values_b` aligned to A's index space."""
    out = values_b[matches.idx]
    keep = matches.mask.reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(keep, out, torch.full_like(out, fill))
