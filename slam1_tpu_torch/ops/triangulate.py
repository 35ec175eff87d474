"""Triangulation (counterpart of `slam1_tpu/ops/triangulate.py`):

  - `stereo_rectified`: closed-form depth from disparity for a rectified
    rig, the production path;
  - `dlt`: batched general two-view DLT, the null vector of each
    row-normalised 4x4 design matrix by SVD (its sign cancels in the
    dehomogenisation).
"""

from __future__ import annotations

import torch

from slam1_tpu_torch.ops.camera import StereoCamera


def stereo_rectified(cam: StereoCamera, uv_l, uv_r,
                     min_disparity=0.25, max_depth=1e4):
    """uv_l, uv_r: (...,2) pixel coords in left/right images.
    Returns (X (...,3) in the left camera frame, valid (...))."""
    disparity = uv_l[..., 0] - uv_r[..., 0]
    valid = disparity > min_disparity
    d = torch.where(valid, disparity, torch.ones_like(disparity))
    z = cam.fx * cam.baseline / d
    valid = valid & (z < max_depth) & (z > 0)
    x = (uv_l[..., 0] - cam.cx) / cam.fx * z
    y = (uv_l[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1), valid


def dlt(P1, P2, uv1, uv2):
    """Two-view DLT triangulation: P1, P2 (3,4) projection matrices,
    uv1, uv2 (N,2) pixel observations -> (N,3) points."""
    def rows(P, uv):
        r1 = uv[..., 0:1] * P[2] - P[0]
        r2 = uv[..., 1:2] * P[2] - P[1]
        return torch.stack([r1, r2], dim=-2)              # (N,2,4)

    A = torch.cat([rows(P1, uv1), rows(P2, uv2)], dim=-2)  # (N,4,4)
    # Row normalisation keeps the float32 SVD well conditioned with
    # pixel-scale (~1e3) projection entries.
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    X_h = torch.linalg.svd(A).Vh[..., 3, :]   # smallest singular value
    w = X_h[..., 3:4]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X_h[..., :3] / w
