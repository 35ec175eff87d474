"""SO(3)/SE(3) Lie-group operations on batched tensors (counterpart of
`slam1_tpu/ops/se3.py`, same formulas and small-angle branches).

Conventions:
  - Rotations are 3x3 matrices R, twists are (6,) vectors [rho, phi]
    (translation first, rotation last) matching the tangent of
    T = [[R, t], [0, 1]].
  - `exp_se3` uses the closed-form V matrix so t = V @ rho.
"""

from __future__ import annotations

import torch

from slam1_tpu_torch.ops.lsq import inv3x3

_EPS = 1e-8


def hat(w):
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W):
    """(...,3,3) skew -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_theta(phi):
    """(theta, theta2, small_mask), each shaped (...,1,1)."""
    th2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    small = th2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    return theta, th2, small


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape)


def exp_so3(phi):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta, th2, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(theta)) / th2)
    return _eye3(K) + a * K + b * K2


def log_so3(R):
    """(...,3,3) rotation -> (...,3) axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5        # = sin(theta) * axis
    s2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = (s2 < 1e-10) & (cos_t[..., None] > 0.0)
    sin_t = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(sin_t, cos_t[..., None])
    near_pi = cos_t[..., None] < -0.999995
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / sin_t)
    generic = w * scale
    # theta ~ pi: axis from the diagonal of (R + I)/2.
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp(diag, 0.0, 1.0))
    one = torch.ones_like(B[..., 0, 1])
    sx = torch.where(B[..., 0, 1] + B[..., 1, 0] >= 0, one, -one)
    sz = torch.where(B[..., 1, 2] + B[..., 2, 1] >= 0, one, -one)
    axis = axis * torch.stack([one, sx, sx * sz], dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    return torch.where(near_pi, axis * theta, generic)


def _v_matrix(phi):
    """Left Jacobian V of SE(3) exp: t = V @ rho."""
    theta, th2, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(theta)) / th2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (theta - torch.sin(theta)) / (th2 * theta))
    return _eye3(K) + b * K + c * K2


def exp_se3(xi):
    """(...,6) twist [rho, phi] -> (...,4,4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    t = (_v_matrix(phi) @ rho[..., None])[..., 0]
    return from_Rt(R, t)


def log_se3(T):
    """(...,4,4) -> (...,6) twist [rho, phi]."""
    R, t = to_Rt(T)
    phi = log_so3(R)
    V = _v_matrix(phi)
    rho = (inv3x3(V) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def from_Rt(R, t):
    """(...,3,3),(...,3) -> (...,4,4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # Built on the device: writing a Python scalar into a CUDA tensor
    # would copy it from the host and synchronise.
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def to_Rt(T):
    return T[..., :3, :3], T[..., :3, 3]


def inverse(T):
    """(...,4,4) SE(3) inverse without a general solve."""
    R, t = to_Rt(T)
    Rt = R.transpose(-1, -2)
    return from_Rt(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A, B):
    return A @ B


def transform_points(T, X):
    """Apply (...,4,4) to points (...,N,3) -> (...,N,3)."""
    R, t = to_Rt(T)
    return X @ R.transpose(-1, -2) + t[..., None, :]


def rotation_angle(R):
    """Geodesic angle of a rotation matrix, radians."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def orthonormalize(R):
    """Project a near-rotation onto SO(3) via SVD (batched)."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    fix = torch.stack([one, one, det], dim=-1)
    return (U * fix[..., None, :]) @ Vt
