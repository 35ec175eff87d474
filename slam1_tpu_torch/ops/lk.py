"""Pyramidal Lucas-Kanade sparse optical flow (counterpart of
`slam1_tpu/ops/lk.py`).

The reference maps each point through `vmap` and each point's solver
iterations through a `lax.scan`. Here all N points are one batched
tensor program: the window samples are one gather of (N, win*win)
positions per image, the 2x2 normal equations are solved in closed form
for all points at once, and the iterations are a Python loop (their
order is the reference's).

A track survives if the final per-patch photometric error is below
`max_err` and the tracked point stays inside the image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam1_tpu_torch.ops.detector import block_mean2


class FlowResult(NamedTuple):
    xy: torch.Tensor     # (N,2) tracked positions in the next image
    err: torch.Tensor    # (N,)  mean |I_prev - I_next| over the window
    mask: torch.Tensor   # (N,)  track survived (valid input & err & bounds)


def bilinear(img, xy):
    """Bilinear sample an (H,W) image at (...,2) float (x,y) coords.

    Coordinates are clamped to the valid interpolation domain.
    """
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    i00 = y0 * w + x0
    v00 = flat[i00]
    v01 = flat[i00 + 1]
    v10 = flat[i00 + w]
    v11 = flat[i00 + w + 1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _downsample2(img, pairwise: bool = False):
    """2x box-filtered decimation (pyramid level); an odd trailing row
    or column is dropped. `pairwise` as in `detector.block_mean2`: the
    reference's jitted `lk_track` makes levels 2 and up that way."""
    h, w = img.shape
    return block_mean2(img[:h // 2 * 2, :w // 2 * 2], pairwise)


def build_pyramid(img, levels: int):
    """[level0 (full res), level1 (half), ...]."""
    pyr = [img]
    for lv in range(1, levels):
        pyr.append(_downsample2(pyr[-1], pairwise=lv > 1))
    return pyr


def _window_offsets(win: int, dtype, device):
    r = win // 2
    o = torch.arange(-r, r + 1, dtype=dtype, device=device)
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)  # (W2,2)


def _track_level(prev, nxt, pts, guess, win: int, iters: int):
    """One pyramid level of iterative LK for all points.

    pts:   (N,2) point positions at THIS level's resolution (prev image).
    guess: (N,2) current flow estimate at this level's resolution.
    Returns (flow (N,2), err (N,)).
    """
    offs = _window_offsets(win, pts.dtype, pts.device)
    grid = pts[:, None, :] + offs                           # (N,W2,2)
    t = bilinear(prev, grid)                                # template
    # Spatial gradients of the template, constant across iterations. The
    # half-pixel steps [0.5, 0] and [0, 0.5] are made on the device: a
    # tensor of host data would be a copy from pageable memory, which
    # stalls the host and cannot be captured in a CUDA graph.
    dx, dy = torch.eye(2, dtype=pts.dtype, device=pts.device) * 0.5
    ix = bilinear(prev, grid + dx) - bilinear(prev, grid - dx)
    iy = bilinear(prev, grid + dy) - bilinear(prev, grid - dy)
    gxx = torch.sum(ix * ix, dim=-1)
    gxy = torch.sum(ix * iy, dim=-1)
    gyy = torch.sum(iy * iy, dim=-1)
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-8
    det = torch.where(inv_ok, det, torch.ones_like(det))
    i00, i01, i11 = gyy / det, -gxy / det, gxx / det        # G^-1

    v = guess
    for _ in range(iters):
        d = t - bilinear(nxt, grid + v[:, None, :])
        bx = torch.sum(d * ix, dim=-1)
        by = torch.sum(d * iy, dim=-1)
        dv = torch.stack([i00 * bx + i01 * by, i01 * bx + i11 * by], dim=-1)
        v = v + torch.where(inv_ok[:, None], dv, torch.zeros_like(dv))
    err = torch.mean(torch.abs(t - bilinear(nxt, grid + v[:, None, :])),
                     dim=-1)
    return v, err


def lk_track(prev, nxt, pts, mask, win: int = 11, levels: int = 3,
             iters: int = 10, max_err: float = 4.0 / 255.0) -> FlowResult:
    """Track (N,2) points from `prev` to `nxt` (both (H,W) float [0,1])."""
    h, w = prev.shape
    pyr_p = build_pyramid(prev, levels)
    pyr_n = build_pyramid(nxt, levels)

    flow = torch.zeros_like(pts)
    err = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    for lv in range(levels - 1, -1, -1):
        s = float(2.0 ** lv)
        flow_lv, err = _track_level(pyr_p[lv], pyr_n[lv], pts / s,
                                    flow / s, win, iters)
        flow = flow_lv * s

    new_xy = pts + flow
    r = win // 2 + 1
    inb = ((new_xy[:, 0] >= r) & (new_xy[:, 0] < w - r)
           & (new_xy[:, 1] >= r) & (new_xy[:, 1] < h - r))
    ok = mask & inb & (err < max_err) & torch.all(torch.isfinite(new_xy), -1)
    return FlowResult(xy=new_xy, err=err, mask=ok)
