"""Bundle adjustment's observation terms, and the plain twins of the
kernels of `csrc/ba_obs.cu` that evaluate them on the CG path.

Per stereo observation: the residual at the estimate, its Huber weight
and the graduated cut, the full and the truncated robust costs, the
camera (3,6) and landmark (3,3) Jacobians written out by hand (the
reference takes `jax.jacfwd` of `_obs_residual`; `vmap(jacfwd)` costs
hundreds of small launches per linearisation on a GPU), and their
products summed into the normal equations' blocks by camera and by
landmark (float64, rounded once: `ops/segment.seg_sum`).

The twins are the composition `models/ba.py` ran before the kernels
(`_cost`, `_obs_terms`, `_normal_blocks`), operation for operation:
  - `cameras_plain`: the costs at the estimate, the rows kept, W (O,6,3),
    Hcc (C,6,6) and bc (C,6);
  - `landmarks_plain`: Hll (L,3,3) and bl (L,3);
  - `cost_plain`: the two costs alone.
They take the observations' ordering (`cuda_kernels.schur_order`) for
the kernels' contract and read nothing of it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.lsq import huber_weights
from slam1_tpu_torch.ops.segment import seg_sum

Z_MIN = 1e-3               # depth clamp of the projection


def project(Xc, uv, ur, wr, cam: StereoCamera):
    """Residuals (O,3) of camera-frame points Xc (O,3), the clamped
    depth z (O,) and the unclamped-depth mask (O,)."""
    free = Xc[:, 2] > Z_MIN
    z = torch.clamp(Xc[:, 2], min=Z_MIN)
    u = cam.fx * Xc[:, 0] / z + cam.cx
    v = cam.fy * Xc[:, 1] / z + cam.cy
    u_r = cam.fx * (Xc[:, 0] - cam.baseline) / z + cam.cx
    r = torch.stack([u - uv[:, 0], v - uv[:, 1], wr * (u_r - ur)], dim=-1)
    return r, z, free


def obs_residual(T, X, uv, ur, wr, cam: StereoCamera):
    """Residuals (O,3) of stereo observations at camera poses T (O,4,4)
    and world points X (O,3): [u_left, v_left, right-u] errors. The third
    component is gated by the stereo weight `wr` (0 = monocular); stereo
    observations anchor the metric scale."""
    Xc = ((X - T[:, :3, 3])[:, None, :] @ T[:, :3, :3])[:, 0]   # R^T (X - t)
    return project(Xc, uv, ur, wr, cam)[0]


def obs_terms(T, X, uv, ur, wr, cam: StereoCamera):
    """Residuals (O,3) and their Jacobians at zero perturbation with
    respect to the camera twist dc (O,3,6), T <- T exp(dc), and to the
    landmark dl (O,3,3), X <- X + dl.

    With Xc = R^T (X - t): dXc/ddc = [-I | hat(Xc)] in the twist order
    [rho, phi] of `se3.exp_se3`, dXc/ddl = R^T. Below the depth clamp the
    depth's derivative is 0 (forward mode through a maximum)."""
    R = T[:, :3, :3]
    Xc = ((X - T[:, :3, 3])[:, None, :] @ R)[:, 0]
    r, z, free = project(Xc, uv, ur, wr, cam)
    dz = free.to(Xc.dtype)
    zero = torch.zeros_like(z)
    fxz, fyz = cam.fx / z, cam.fy / z
    iz2 = dz / (z * z)
    # d[u, v, wr * u_r] / dXc
    Jp = torch.stack([
        torch.stack([fxz, zero, -cam.fx * Xc[:, 0] * iz2], dim=-1),
        torch.stack([zero, fyz, -cam.fy * Xc[:, 1] * iz2], dim=-1),
        torch.stack([wr * fxz, zero,
                     -wr * cam.fx * (Xc[:, 0] - cam.baseline) * iz2],
                    dim=-1)], dim=-2)                            # (O,3,3)
    Jc = torch.cat([-Jp, Jp @ se3.hat(Xc)], dim=-1)              # (O,3,6)
    Jl = Jp @ R.transpose(-1, -2)                                # (O,3,3)
    return r, Jc, Jl


def huber_cost(problem, cam: StereoCamera, huber_delta: float):
    """(Huber cost (), residuals (O,3), Huber weights (O,)) of a
    `models.ba.BAProblem`."""
    T = problem.poses[problem.cam_idx.long()]
    X = problem.points[problem.lm_idx.long()]
    r = obs_residual(T, X, problem.uv, problem.ur, problem.wr, cam)
    r2 = torch.sum(r * r, dim=-1)
    hw = huber_weights(r2, huber_delta)
    return torch.sum(problem.w * hw * r2), r, hw


def trunc_cost(problem, hw, r2, cap):
    """The truncated robust cost sum_i w_i min(huber(r_i), cap); no cap
    (None) leaves it the full Huber cost."""
    contrib = hw * r2                          # huber(r): r2 or delta * r
    if cap is not None:
        contrib = torch.minimum(contrib, cap)
    return torch.sum(problem.w * contrib)


def camera_blocks(n_cams: int, cam_idx, r, Jc, Jl, w):
    """W (O,6,3), Hcc (C,6,6) and bc (C,6) of the observations' terms at
    weights w (O,); no pose prior."""
    w2 = w[:, None, None]
    hcc = seg_sum(n_cams, cam_idx, torch.einsum("oai,oaj->oij", Jc, Jc) * w2)
    W = torch.einsum("oai,oaj->oij", Jc, Jl) * w2                # (O,6,3)
    bc = -seg_sum(n_cams, cam_idx,
                  torch.einsum("oai,oa->oi", Jc, r * w[:, None]))
    return W, hcc, bc


def landmark_blocks(n_lms: int, lm_idx, r, Jl, w):
    """Hll (L,3,3) and bl (L,3) of the observations' terms at weights w."""
    hll = seg_sum(n_lms, lm_idx,
                  torch.einsum("oai,oaj->oij", Jl, Jl) * w[:, None, None])
    bl = -seg_sum(n_lms, lm_idx,
                  torch.einsum("oai,oa->oi", Jl, r * w[:, None]))
    return hll, bl


class ObsTerms(NamedTuple):
    """What the cameras' pass gives: the blocks W (O,6,3), hcc (C,6,6),
    bc (C,6), the full and the truncated cost at the estimate (0-d) and
    the rows the step keeps (0-d int32: weight above zero after the
    Huber weight and the cut)."""
    W: torch.Tensor
    hcc: torch.Tensor
    bc: torch.Tensor
    full: torch.Tensor
    trunc: torch.Tensor
    n_kept: torch.Tensor


def step_weights(problem, cam: StereoCamera, cut2, huber_delta: float):
    """(full cost, residuals (O,3), Huber weights (O,), r2 (O,), the
    step's weights (O,)): the observation's weight times its Huber weight,
    zero at r2 >= cut2 (no cut: `cut2` None)."""
    full, r, hw = huber_cost(problem, cam, huber_delta)
    r2 = torch.sum(r * r, dim=-1)
    w = problem.w * hw
    if cut2 is not None:
        w = w * (r2 < cut2).to(w.dtype)
    return full, r, hw, r2, w


def _terms(problem, cam: StereoCamera):
    T = problem.poses[problem.cam_idx.long()]
    X = problem.points[problem.lm_idx.long()]
    return obs_terms(T, X, problem.uv, problem.ur, problem.wr, cam)


def cameras_plain(problem, cam: StereoCamera, order, cut2, cap,
                  huber_delta: float) -> ObsTerms:
    """Plain twin of cuda_kernels.ba_obs_cameras_cuda: the costs and the
    camera blocks at the problem's poses and points, the step's weights
    cut at `cut2` (None: no cut) and the truncated cost capped at `cap`
    (None: the full cost)."""
    full, _, hw, r2, w = step_weights(problem, cam, cut2, huber_delta)
    trunc = trunc_cost(problem, hw, r2, cap)
    r, Jc, Jl = _terms(problem, cam)
    W, hcc, bc = camera_blocks(problem.poses.shape[0],
                               problem.cam_idx.long(), r, Jc, Jl, w)
    return ObsTerms(W, hcc, bc, full, trunc, torch.sum(w > 0).to(torch.int32))


def landmarks_plain(problem, cam: StereoCamera, order, cut2,
                    huber_delta: float):
    """Plain twin of cuda_kernels.ba_obs_landmarks_cuda: (Hll, bl)."""
    _, _, _, _, w = step_weights(problem, cam, cut2, huber_delta)
    r, _, Jl = _terms(problem, cam)
    return landmark_blocks(problem.points.shape[0], problem.lm_idx.long(),
                           r, Jl, w)


def cost_plain(problem, cam: StereoCamera, order, cap, huber_delta: float):
    """Plain twin of cuda_kernels.ba_obs_cost_cuda: (full cost, truncated
    cost) at the problem's poses and points."""
    full, r, hw = huber_cost(problem, cam, huber_delta)
    return full, trunc_cost(problem, hw, torch.sum(r * r, dim=-1), cap)
