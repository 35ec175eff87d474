"""Rectified-stereo dense disparity: block matching + semi-global
aggregation (counterpart of `slam1_tpu/ops/disparity.py`).

  - cost volume (D,H,W) by ZSAD over a box window: every disparity's
    shifted right image comes from one gather (the reference rolls the
    image once per disparity, with the same wrap-around), and the window
    sums are cumulative-sum box filters over the whole volume at once;
  - optional 2-pass semi-global aggregation along scanlines: the
    left-to-right and right-to-left passes are independent, so they are
    stacked on a leading axis and run in ONE sequential loop over the
    image columns (the reference's `lax.scan` order), each column written
    into a preallocated buffer;
  - winner-take-all argmin, uniqueness, parabolic sub-pixel refinement;
  - left-right consistency check from the same cost volume.

Invalid pixels get disparity = -1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DisparityResult(NamedTuple):
    disp: torch.Tensor   # (H,W) float32 left-image disparity; -1 = invalid
    valid: torch.Tensor  # (H,W) bool


SCAN_BLOCK = 16


def _cumsum_last(x):
    """Inclusive cumulative sum over the last dim, rounded as the
    reference's `jnp.cumsum` rounds on the CPU: XLA rewrites the scan
    into blocks of 16 summed left to right, a scan of the block totals
    (the same rewrite, recursively) and one addition of the preceding
    blocks' total to each element (measured: bit-equal at lengths 17 to
    5000). `torch.cumsum` rounds otherwise, and the box sums below are
    differences of large running sums that cancel."""
    n = x.shape[-1]
    nb = -(-n // SCAN_BLOCK)
    b = min(n, SCAN_BLOCK)
    xb = torch.nn.functional.pad(x, (0, nb * b - n)).reshape(
        x.shape[:-1] + (nb, b))
    inner = xb.clone()
    for i in range(1, b):
        inner[..., i] += inner[..., i - 1]
    if nb == 1:
        return inner[..., 0, :n]
    outer = _cumsum_last(inner[..., -1])                     # (..., nb)
    inner[..., 1:, :] += outer[..., :-1, None]
    return inner.reshape(x.shape[:-1] + (nb * b,))[..., :n]


def _box_filter(img, radius: int):
    """(2r+1)^2 box sums over the last two dims via cumulative sums."""
    k = 2 * radius + 1
    p = torch.nn.functional.pad(img, (radius + 1, radius, radius + 1, radius))
    c = _cumsum_last(_cumsum_last(p.transpose(-1, -2)).transpose(-1, -2))
    return (c[..., k:, k:] - c[..., :-k, k:]
            - c[..., k:, :-k] + c[..., :-k, :-k])


def _cost_volume(left, right, max_disp: int, radius: int):
    """(D,H,W) ZSAD matching cost; out-of-range columns get +inf."""
    k2 = (2 * radius + 1) ** 2
    mu_l = _box_filter(left, radius) / k2
    mu_r = _box_filter(right, radius) / k2
    zl = left - mu_l
    w = left.shape[-1]
    dev = left.device
    xs = torch.arange(w, device=dev)
    ds = torch.arange(max_disp, device=dev)
    # Column x of disparity d reads column (x - d) mod W: jnp.roll's wrap.
    src = (xs[None, :] - ds[:, None]) % w                    # (D,W)
    r_sh = right[:, src].permute(1, 0, 2)                    # (D,H,W)
    mu_sh = mu_r[:, src].permute(1, 0, 2)
    sad = _box_filter(torch.abs(zl - (r_sh - mu_sh)), radius)
    ok = xs[None, None, :] >= ds[:, None, None] + radius
    return torch.where(ok, sad, torch.full_like(sad, float("inf")))


def _sgm_passes(cost_hwd, p1: float, p2: float):
    """Both horizontal SGM passes over an (H,W,D) cost volume: (2,W,H,D)
    aggregated costs, [0] left to right, [1] right to left with its
    columns back in image order."""
    c = cost_hwd.transpose(0, 1)                            # (W,H,D)
    c = torch.stack([c, c.flip(0)])                          # (2,W,H,D)
    n, w, h, d = c.shape
    finite = torch.isfinite(c)
    big = float("inf")
    out = torch.empty_like(c)
    out[:, 0] = c[:, 0]
    # prev + p1 with an +inf column on either side: its shifted views are
    # the reference's `up + p1` and `dn + p1`.
    shifted = torch.full((n, h, d + 2), big, dtype=c.dtype, device=c.device)
    for x in range(1, w):
        prev = out[:, x - 1]
        m = torch.amin(prev, dim=-1, keepdim=True)           # (2,H,1)
        torch.add(prev, p1, out=shifted[..., 1:d + 1])
        agg = torch.minimum(torch.minimum(prev, m + p2),
                            torch.minimum(shifted[..., 2:],
                                          shifted[..., :d]))
        cost_col = c[:, x]
        step = cost_col + agg - m
        # inf + finite stays inf; guard inf - inf.
        step = torch.where(finite[:, x], step, big)
        torch.where(torch.isfinite(m), step, cost_col, out=out[:, x])
    out[1] = out[1].flip(0)
    return out


def disparity(left, right, max_disp: int = 64, radius: int = 5,
              sgm: bool = True, p1: float = 0.03, p2: float = 0.45,
              lr_check: bool = True, lr_tol: float = 1.0,
              uniq_ratio: float = 0.98) -> DisparityResult:
    """Dense left-image disparity of a rectified float [0,1] pair."""
    h, w = left.shape
    dev = left.device
    vol = _cost_volume(left, right, max_disp, radius)        # (D,H,W)

    if sgm:
        hwd = vol.permute(1, 2, 0)                           # (H,W,D)
        # The penalties scaled in float32, as the reference's traced
        # float32 p1, p2 are.
        scale = np.float32((2 * radius + 1) ** 2)
        agg = _sgm_passes(hwd, float(np.float32(p1) * scale),
                          float(np.float32(p2) * scale))     # (2,W,H,D)
        vol = (agg[0] + agg[1]).permute(2, 1, 0)             # (D,H,W)

    d_best = torch.argmin(vol, dim=0)                        # (H,W)
    dgrid = torch.arange(max_disp, device=dev)[:, None, None]
    c_best = torch.amin(vol, dim=0)

    # Uniqueness: best must beat the runner-up (excluding +-1 neighbours).
    near = torch.abs(dgrid - d_best[None]) <= 1
    c_second = torch.amin(torch.where(near, float("inf"), vol), dim=0)
    unique = c_best <= uniq_ratio * c_second

    # Parabolic sub-pixel refinement around the winner.
    def at(dd):
        return torch.gather(vol, 0, dd[None])[0]
    dm = at(torch.clamp(d_best - 1, 0, max_disp - 1))
    dp = at(torch.clamp(d_best + 1, 0, max_disp - 1))
    denom = dm - 2.0 * c_best + dp
    offs = torch.where(torch.abs(denom) > 1e-9,
                       0.5 * (dm - dp) / torch.where(denom == 0, 1.0, denom),
                       0.0)
    offs = torch.clamp(offs, -0.5, 0.5)
    disp = d_best.to(left.dtype) + offs

    valid = ((d_best > 0) & (d_best < max_disp - 1)
             & torch.isfinite(c_best) & unique)

    if lr_check:
        # Right-image disparity from the same volume: costR[d,y,x] =
        # costL[d,y,x+d] (gather along W), then WTA.
        xs = torch.arange(w, device=dev)
        xr = torch.clamp(xs[None, None, :] + dgrid, 0, w - 1)  # (D,1,W)
        vol_r = torch.gather(vol, 2, xr.expand(vol.shape))
        vol_r = torch.where(xs[None, None, :] + dgrid < w, vol_r,
                            float("inf"))
        d_right = torch.argmin(vol_r, dim=0)                 # (H,W)
        # d_left(x) must agree with d_right(x - d_left(x)).
        x_in_r = torch.clamp(xs[None, :] - d_best, 0, w - 1)
        d_back = torch.gather(d_right, 1, x_in_r)
        valid = valid & (torch.abs(d_back - d_best) <= lr_tol)

    disp = torch.where(valid, disp, -1.0)
    return DisparityResult(disp=disp, valid=valid)


def sample_disparity(result: DisparityResult, xy):
    """Per-keypoint disparity lookup (nearest pixel): (disp (N,),
    valid (N,))."""
    h, w = result.disp.shape
    x = torch.clamp(torch.round(xy[..., 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(xy[..., 1]).long(), 0, h - 1)
    return result.disp[y, x], result.valid[y, x]
