"""Pinhole + rectified-stereo camera model (counterpart of
`slam1_tpu/ops/camera.py`).

The stereo rig is rectified (KITTI odometry): identical K for both
cameras, right camera displaced by `baseline` along +x of the left.
Fields are 0-d tensors on the device the camera is used on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam1_tpu_torch.ops import se3
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

    @property
    def K(self):
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx]),
            torch.stack([z, self.fy, self.cy]),
            torch.stack([z, z, o]),
        ])

    def projection_matrices(self):
        """(P_left, P_right) 3x4 for the rectified pair."""
        K = self.K
        P_l = torch.cat([K, K.new_zeros((3, 1))], dim=1)
        z = torch.zeros_like(self.baseline)
        t = torch.stack([-self.baseline, z, z])
        P_r = torch.cat([K, (K @ t)[:, None]], dim=1)
        return P_l, P_r


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


def project_world(cam: StereoCamera, T_wc, X_world, eps=1e-6):
    """World points through world-from-camera pose T_wc -> left pixels."""
    X_cam = se3.transform_points(se3.inverse(T_wc), X_world)
    return project(cam, X_cam, eps)


def backproject(cam: StereoCamera, uv, depth):
    """Pixels (...,2) + depth (...) -> camera-frame points (...,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)
