"""Pinhole + rectified-stereo camera model (counterpart of
`slam1_tpu/ops/camera.py`).

The stereo rig is rectified (KITTI odometry): identical K for both
cameras, right camera displaced by `baseline` along +x of the left.
Fields are 0-d tensors on the device the camera is used on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam1_tpu_torch.runtime import default_device


class StereoCamera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    baseline: torch.Tensor  # metres, positive

    @staticmethod
    def create(fx, fy, cx, cy, baseline, dtype=torch.float32, device=None):
        device = default_device(device)
        return StereoCamera(*[torch.as_tensor(v, dtype=dtype, device=device)
                              for v in (fx, fy, cx, cy, baseline)])

    @staticmethod
    def kitti_default(dtype=torch.float32, device=None):
        """KITTI odometry seq 00 grayscale rig parameters."""
        return StereoCamera.create(718.856, 718.856, 607.1928, 185.2157,
                                   0.5371657, dtype, device)

    @staticmethod
    def for_canvas(height: int, width: int, dtype=torch.float32,
                   device=None):
        """KITTI-like rig rescaled to an arbitrary canvas (same FOV and
        baseline, principal point at the canvas centre)."""
        fx = 718.856 * (width / 1226.0)
        return StereoCamera.create(fx, fx, width / 2.0, height / 2.0,
                                   0.5371657, dtype, device)

    def to(self, device) -> "StereoCamera":
        return StereoCamera(*[v.to(device) for v in self])


def project(cam: StereoCamera, X_cam, eps=1e-6):
    """Camera-frame points (...,3) -> pixel coords (...,2) + in-front mask."""
    z = X_cam[..., 2]
    valid = z > eps
    zs = torch.where(valid, z, torch.ones_like(z))
    u = cam.fx * X_cam[..., 0] / zs + cam.cx
    v = cam.fy * X_cam[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1), valid


def project_stereo(cam: StereoCamera, X_cam, eps=1e-6):
    """-> (uv_left, uv_right, valid)."""
    uv_l, valid = project(cam, X_cam, eps)
    X_r = torch.cat([X_cam[..., :1] - cam.baseline, X_cam[..., 1:]], dim=-1)
    uv_r, valid_r = project(cam, X_r, eps)
    return uv_l, uv_r, valid & valid_r
