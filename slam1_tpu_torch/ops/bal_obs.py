"""BAL's camera model and its observation terms, and the plain twins of
the kernels of `csrc/bal_obs.cu` that evaluate them on bundle
adjustment's CG path (`models/ba.py` with the camera model `ba.BAL`).

The camera model, the public BAL convention (Agarwal et al., "Bundle
Adjustment in the Large"):

    P  = R(w) @ X + t             world -> camera, axis-angle rotation
    p  = -(P.x, P.y) / P.z        the camera looks down -z
    uv = f * (1 + k1 |p|^2 + k2 |p|^4) * p

with the camera's 9 parameters [w(3), t(3), f, k1, k2] moved additively.
Per monocular observation: the residual at the estimate, its Huber
weight, the robust cost, and the camera (2,9) and landmark (2,3)
Jacobians written out by hand (the reference takes
`jax.jacfwd` of the projection), summed into the normal equations'
blocks by camera and by landmark (float64, rounded once:
`ops/segment.seg_sum`, through `ops/ba_obs.camera_blocks` and
`landmark_blocks`, which take any camera width).

BAL's model cuts no observation (the reference's `bal_adjust` weights
every one by Huber alone): the pass keeps the stereo pass's contract with
its cut2 and cap None, and its truncated cost is the full one.

The twins:
  - `cameras_plain`: the cost at the estimate, the rows kept, W (O,9,3),
    Hcc (C,9,9) and bc (C,9);
  - `landmarks_plain`: Hll (L,3,3) and bl (L,3);
  - `cost_plain`: the cost alone.
They take the observations' ordering (`cuda_kernels.schur_order`) for
the kernels' contract and read nothing of it.
"""

from __future__ import annotations

import torch

from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.ops.ba_obs import (ObsTerms, camera_blocks,
                                        landmark_blocks)
from slam1_tpu_torch.ops.lsq import huber_weights

def project(cam9, X):
    """BAL projection of world points X (...,3) through cameras cam9
    (...,9) -> (...,2)."""
    R = se3.exp_so3(cam9[..., :3])
    P = (R @ X[..., None])[..., 0] + cam9[..., 3:6]
    pz = P[..., 2]
    den = torch.where(torch.abs(pz) > 1e-9, pz,
                      torch.sign(pz) * 1e-9 + 1e-12)
    p = -P[..., :2] / den[..., None]
    r2 = torch.sum(p * p, dim=-1)
    f, k1, k2 = cam9[..., 6], cam9[..., 7], cam9[..., 8]
    return (f * (1.0 + k1 * r2 + k2 * r2 * r2))[..., None] * p


def left_jacobian(w):
    """J_l (...,3,3) of axis-angle vectors w (...,3): exp(w + dw) =
    exp(J_l dw) exp(w) to first order, so d(R(w) X)/dw = -hat(R X) J_l.
    J_l = I + b hat(w) + c hat(w)^2 with b = (1 - cos t) / t^2 (below
    t^2 = 1e-8 its series, as `se3.exp_so3`) and c = (1 - sin t / t) / t^2
    (below t^2 = 1e-2 its series: the difference cancels in float32)."""
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = th2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(theta)) / th2)
    c = torch.where(th2 < 1e-2, 1.0 / 6.0 - th2 / 120.0 + th2 * th2 / 5040.0,
                    (1.0 - torch.sin(theta) / theta) / th2)
    K = se3.hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + b * K + c * (K @ K)


def obs_terms(cam9, X, uv):
    """Residuals (O,2) of observations uv (O,2) of world points X (O,3)
    through cameras cam9 (O,9), and their Jacobians with respect to the
    camera's 9 parameters (O,2,9) and the point (O,2,3), as
    `csrc/bal_obs.cu` writes them (see its header)."""
    R = se3.exp_so3(cam9[..., :3])
    q = (R @ X[..., None])[..., 0]
    P = q + cam9[..., 3:6]
    pz = P[..., 2]
    free = torch.abs(pz) > 1e-9
    den = torch.where(free, pz, torch.sign(pz) * 1e-9 + 1e-12)
    p = -P[..., :2] / den[..., None]
    r2 = torch.sum(p * p, dim=-1)
    f, k1, k2 = cam9[..., 6], cam9[..., 7], cam9[..., 8]
    d = 1.0 + k1 * r2 + k2 * r2 * r2
    s = f * d
    r = s[..., None] * p - uv
    # d uv / d p = s I + g p p^T, d p / d P, A = d uv / d P (O,2,3)
    g = f * (2.0 * k1 + 4.0 * k2 * r2)
    Jpp = (s[..., None, None] * torch.eye(2, dtype=p.dtype, device=p.device)
           + g[..., None, None] * (p[..., :, None] * p[..., None, :]))
    idn = 1.0 / den
    zero = torch.zeros_like(idn)
    dz = torch.where(free[..., None], P[..., :2] * (idn * idn)[..., None],
                     torch.zeros_like(p))
    dpdP = torch.stack([torch.stack([-idn, zero, dz[..., 0]], -1),
                        torch.stack([zero, -idn, dz[..., 1]], -1)], -2)
    A = Jpp @ dpdP
    Jl = A @ R
    M = -(se3.hat(q) @ left_jacobian(cam9[..., :3]))
    fr2 = (f * r2)[..., None]
    Jc = torch.cat([A @ M, A, (d[..., None] * p)[..., None],
                    (fr2 * p)[..., None], (fr2 * r2[..., None] * p)[..., None]],
                   dim=-1)
    return r, Jc, Jl


def _sum64(x):
    """The sum of x in float64, rounded once to x's dtype, as the kernels
    sum a cost."""
    return torch.sum(x.double()).to(x.dtype)


def huber_cost(problem, huber_delta: float):
    """(Huber cost (), residuals (O,2), Huber weights (O,)) of a
    `models.bal.BalProblem`; the cost summed in float64, rounded once."""
    r = project(problem.cams[problem.cam_idx.long()],
                problem.points[problem.lm_idx.long()]) - problem.uv
    r2 = torch.sum(r * r, dim=-1)
    hw = huber_weights(r2, huber_delta)
    return _sum64(problem.w * hw * r2), r, hw


def _uncut(*cut):
    if any(x is not None for x in cut):
        raise ValueError("bal_obs: BAL's pass takes no outlier cut")


def step_weights(problem, huber_delta: float):
    """(cost, the step's weights (O,)): the observation's weight times its
    Huber weight."""
    cost, _, hw = huber_cost(problem, huber_delta)
    return cost, problem.w * hw


def _terms(problem):
    return obs_terms(problem.cams[problem.cam_idx.long()],
                     problem.points[problem.lm_idx.long()], problem.uv)


def cameras_plain(problem, cam, order, cut2, cap,
                  huber_delta: float) -> ObsTerms:
    """Plain twin of cuda_kernels.bal_obs_cameras_cuda: the cost (as the
    full and the truncated cost) and the camera blocks at the problem's
    cameras and points; `cut2` and `cap` must be None. `cam` is the
    stereo pass's camera, which BAL has none of (its intrinsics are in
    the cameras): ()."""
    _uncut(cut2, cap)
    cost, w = step_weights(problem, huber_delta)
    r, Jc, Jl = _terms(problem)
    W, hcc, bc = camera_blocks(problem.cams.shape[0], problem.cam_idx.long(),
                               r, Jc, Jl, w)
    return ObsTerms(W, hcc, bc, cost, cost, torch.sum(w > 0).to(torch.int32))


def landmarks_plain(problem, cam, order, cut2, huber_delta: float):
    """Plain twin of cuda_kernels.bal_obs_landmarks_cuda: (Hll, bl);
    `cut2` must be None."""
    _uncut(cut2)
    _, w = step_weights(problem, huber_delta)
    r, _, Jl = _terms(problem)
    return landmark_blocks(problem.points.shape[0], problem.lm_idx.long(),
                           r, Jl, w)


def cost_plain(problem, cam, order, cap, huber_delta: float):
    """Plain twin of cuda_kernels.bal_obs_cost_cuda: the cost at the
    problem's cameras and points, as (full, truncated); `cap` must be
    None."""
    _uncut(cap)
    cost = huber_cost(problem, huber_delta)[0]
    return cost, cost
