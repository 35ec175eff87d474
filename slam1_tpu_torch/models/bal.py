"""BAL-style full bundle adjustment with 9-parameter cameras
(counterpart of `slam1_tpu/models/bal.py`).

The same landmark-elimination Schur LM as `models/ba.py` with 9-dof
camera blocks [rvec(3), tvec(3), f, k1, k2], so focal length and radial
distortion are refined jointly with geometry. The live backend holds
the intrinsics of its calibrated, rectified rig fixed; this solver is
for BAL-format datasets, where they are per-camera unknowns. It is off
the live path, so its Jacobians come from `torch.func.jacfwd`.

Camera model, the public BAL convention (Agarwal et al., "Bundle
Adjustment in the Large"):

    P  = R(rvec) @ X + t          world -> camera, axis-angle rotation
    p  = -(P.x, P.y) / P.z        the camera looks down -z
    uv = f * (1 + k1 |p|^2 + k2 |p|^4) * p
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models.ba import _damped
from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.ops.cg import cg
from slam1_tpu_torch.ops.lsq import huber_weights, inv3x3
from slam1_tpu_torch.ops.segment import seg_sum
from slam1_tpu_torch.runtime import default_device


class BalProblem(NamedTuple):
    cams: torch.Tensor     # (C,9) [rvec(3), tvec(3), f, k1, k2]
    points: torch.Tensor   # (L,3) world landmarks
    cam_idx: torch.Tensor  # (O,) int64
    lm_idx: torch.Tensor   # (O,) int64
    uv: torch.Tensor       # (O,2) principal-point-centred observations
    w: torch.Tensor        # (O,) observation weight; 0 = padding


def from_bal_dict(d, device=None) -> BalProblem:
    """Build a problem from a loaded BAL file's dict (cameras, points,
    cam_idx, lm_idx, uv)."""
    device = default_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BalProblem(
        cams=t(d["cameras"], torch.float32),
        points=t(d["points"], torch.float32),
        cam_idx=t(d["cam_idx"], torch.int64),
        lm_idx=t(d["lm_idx"], torch.int64),
        uv=t(d["uv"], torch.float32),
        w=torch.ones(len(d["cam_idx"]), dtype=torch.float32, device=device))


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


def _residual(dcam, dl, cam9, X, uv):
    """2-vector reprojection residual under additive perturbation of the
    9 camera parameters and the landmark."""
    return project(cam9 + dcam, X + dl) - uv


def _cost(problem: BalProblem, huber_delta: float):
    r = project(problem.cams[problem.cam_idx],
                problem.points[problem.lm_idx]) - problem.uv
    r2 = torch.sum(r * r, dim=-1)
    hw = huber_weights(r2, huber_delta)
    return torch.sum(problem.w * hw * r2), r, hw


def _schur_solve9(problem, r, Jc, Jl, w, lam, cg_iters: int):
    """Damped GN step: eliminate landmarks (batched 3x3), solve the
    reduced camera system matrix-free with block-Jacobi PCG, as
    `models/ba._schur_solve` with 9-dof blocks. No gauge pinning: LM
    damping keeps the normal equations SPD (the BAL gauge is a 7-dof
    similarity)."""
    C = problem.cams.shape[0]
    L = problem.points.shape[0]
    ci, li = problem.cam_idx, problem.lm_idx
    w2 = w[:, None, None]
    rw = r * w[:, None]
    Hcc = seg_sum(C, ci, torch.einsum("oai,oaj->oij", Jc, Jc) * w2)
    Hll = seg_sum(L, li, torch.einsum("oai,oaj->oij", Jl, Jl) * w2)
    W = torch.einsum("oai,oaj->oij", Jc, Jl) * w2                # (O,9,3)
    bc = -seg_sum(C, ci, torch.einsum("oai,oa->oi", Jc, rw))
    bl = -seg_sum(L, li, torch.einsum("oai,oa->oi", Jl, rw))
    Hcc_d = _damped(Hcc, lam)
    Hll_inv = inv3x3(_damped(Hll, lam))

    btil = bc - seg_sum(C, ci, torch.einsum(
        "oij,oj->oi", W, torch.einsum("lij,lj->li", Hll_inv, bl)[li]))

    def matvec(x):
        u = torch.einsum("oij,oi->oj", W, x[ci])
        v = torch.einsum("lij,lj->li", Hll_inv, seg_sum(L, li, u))
        y = torch.einsum("oij,oj->oi", W, v[li])
        return torch.einsum("cij,cj->ci", Hcc_d, x) - seg_sum(C, ci, y)

    Minv = torch.linalg.inv_ex(Hcc_d)[0]
    dc = cg(matvec, btil, iters=cg_iters,
            precond=lambda v: torch.einsum("cij,cj->ci", Minv, v))
    u = torch.einsum("oij,oi->oj", W, dc[ci])
    dl = torch.einsum("lij,lj->li", Hll_inv, bl - seg_sum(L, li, u))
    return dc, dl


def bal_adjust(problem: BalProblem,
               cfg: BAConfig) -> Tuple[BalProblem, torch.Tensor]:
    """Full 9-parameter LM bundle adjustment (cameras with f, k1, k2 and
    points all free). Returns (optimised problem, final cost ()).

    Parameter scales differ wildly (rvec ~1, f ~500): handled by the
    multiplicative damping lam * diag(H) and the block-Jacobi CG
    preconditioner, not by column normalisation."""
    dt, dev = problem.uv.dtype, problem.uv.device
    o = problem.uv.shape[0]
    z9 = torch.zeros((o, 9), dtype=dt, device=dev)
    z3 = torch.zeros((o, 3), dtype=dt, device=dev)
    # Each observation keeps a unit batch axis inside the projection:
    # forward mode through a 0-d `where` yields float64 tangents.
    jac = torch.func.vmap(torch.func.jacfwd(_residual, argnums=(0, 1)))
    cams, points = problem.cams, problem.points
    cost = _cost(problem, cfg.huber_delta)[0]
    lam = torch.full((), cfg.lm_lambda0, dtype=dt, device=dev)
    for _ in range(cfg.lm_iters):
        p = problem._replace(cams=cams, points=points)
        _, r, hw = _cost(p, cfg.huber_delta)
        Jc, Jl = jac(z9[:, None], z3[:, None], cams[p.cam_idx][:, None],
                     points[p.lm_idx][:, None], p.uv[:, None])
        Jc, Jl = Jc[:, 0, :, 0], Jl[:, 0, :, 0]          # (O,2,9), (O,2,3)
        dc, dl = _schur_solve9(p, r, Jc, Jl, problem.w * hw, lam,
                               cfg.cg_iters)
        dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
        dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
        new_cams = cams + dc
        new_points = points + dl
        new_cost = _cost(problem._replace(cams=new_cams, points=new_points),
                         cfg.huber_delta)[0]
        accept = new_cost < cost
        cams = torch.where(accept, new_cams, cams)
        points = torch.where(accept, new_points, points)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam / cfg.lm_lambda_down,
                                      lam * cfg.lm_lambda_up), 1e-9, 1e6)
    return problem._replace(cams=cams, points=points), cost
