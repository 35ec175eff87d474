"""SO(3) / SE(3) in plain PyTorch, for the generator and the references.

A frozen copy of the formulas of `slam1_tpu_torch/ops/se3.py` (twists
[rho, phi], translation first; t = V rho), written here so that the
yardstick imports nothing of the program. Works in any float dtype;
the references call it in float64.
"""

from __future__ import annotations

import torch


def hat(w):
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _theta(phi):
    th2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    small = th2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    return theta, th2, small


def exp_so3(phi):
    """Rodrigues: (...,3) axis-angle -> (...,3,3)."""
    theta, th2, small = _theta(phi)
    K = hat(phi)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(theta)) / th2)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def v_matrix(phi):
    """Left Jacobian V of the SE(3) exponential: t = V rho."""
    theta, th2, small = _theta(phi)
    K = hat(phi)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(theta)) / th2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (theta - torch.sin(theta)) / (th2 * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + b * K + c * (K @ K)


def from_rt(R, t):
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)),
                     t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def exp_se3(xi):
    """(...,6) twist [rho, phi] -> (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return from_rt(exp_so3(phi), (v_matrix(phi) @ rho[..., None])[..., 0])


def log_so3(R):
    """(...,3,3) -> (...,3) axis-angle, for angles below pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = s2 < 1e-10
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(s, cos_t[..., None])
    return w * torch.where(small, 1.0 + s2 / 6.0, theta / s)


def log_se3(T):
    """(...,4,4) -> (...,6) twist [rho, phi]."""
    phi = log_so3(T[..., :3, :3])
    rho = torch.linalg.solve(v_matrix(phi), T[..., :3, 3:])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def transform_points(T, X):
    """(...,4,4) applied to points (...,N,3)."""
    return X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
