"""Plain reference of BAL bundle adjustment as the port runs it
(`models/ba.bundle_adjust` with the camera model `ba.BAL`) and as the
benchmark's configuration `bal-venice` states it, in plain PyTorch: no
JAX, no kernel or module of the port. `benchmark/reference/bal_ref.py`
is a copy of this file, which `tests/test_torch_bal_shared.py` holds
equal to it.

The camera model, BAL's (Agarwal et al., "Bundle Adjustment in the
Large", ECCV 2010): a camera is [w (3), t (3), f, k1, k2], R = exp(hat(w))
by Rodrigues, P = R X + t, p = -(P_x, P_y) / P_z, the observation
f (1 + k1 |p|^2 + k2 |p|^4) p about the principal point. Its Jacobians
are written out here from the right Jacobian of SO(3) (d(R X)/dw = -R
hat(X) J_r(w)), the port's from the left one.

Levenberg-Marquardt over the cameras (moved additively, c + dc) and the
points, with, where BAL's own solver (Ceres, exact Jacobians, a sparse
Schur solve) differs:
  - Huber IRLS weights (delta in pixels) on every observation and
    acceptance on the full Huber cost, strictly lower than the current
    one, as the reference's `bal_adjust` (`slam1_tpu/models/bal.py`):
    no outlier cut (BAConfig's `outlier_px` is the stereo rig's);
  - the damping H + lam diag(H) + 1e-6 I, lam divided by lm_lambda_down
    on acceptance and multiplied by lm_lambda_up otherwise, clipped to
    [1e-9, 1e6];
  - each step's reduced camera system (landmarks eliminated) applied
    matrix-free and solved by `cg_iters` iterations of conjugate
    gradients from zero, preconditioned by the inverse of each camera's
    damped 9x9 block, frozen once r.z falls to 1e-12 (|p.Ap| below it
    counts as 1e-12), not solved exactly;
  - no camera held: the 7-dof similarity gauge is held by the damping
    alone, as the reference's `_schur_solve9` holds it.
Every product runs in `dtype` (float32 by default; the benchmark runs it
in float64) with TF32 off; `rnd` rounds the operands of every product
(the identity but in the benchmark's TF32 control).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CG_EPS = 1e-12


def _same(x):
    return x


def huber_weights(r2, delta):
    d2 = delta * delta
    return torch.where(r2 <= d2, torch.ones_like(r2),
                       torch.sqrt(d2 / torch.clamp(r2, min=1e-12)))


def skew(v):
    """(...,3) -> (...,3,3) with skew(a) b = a x b."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _coefficients(w):
    """(K, sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) of axis-angle
    vectors w, each by its series near t = 0."""
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    t = torch.sqrt(torch.clamp(t2, min=1e-30))
    tiny = t2 < 1e-8
    a = torch.where(tiny, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(tiny, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2)
    c = torch.where(t2 < 1e-2, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                    (t - torch.sin(t)) / (t2 * t))
    return skew(w), a, b, c


def rotation(w):
    K, a, b, _ = _coefficients(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def project(cams, X, rnd=_same):
    """(O,2) BAL projections of points X (O,3) through cameras (O,9)."""
    P = (rnd(rotation(cams[:, :3])) @ rnd(X)[:, :, None])[:, :, 0] \
        + cams[:, 3:6]
    z = P[:, 2]
    z = torch.where(torch.abs(z) > 1e-9, z, torch.sign(z) * 1e-9 + 1e-12)
    p = -P[:, :2] / z[:, None]
    r2 = torch.sum(p * p, dim=-1)
    return (cams[:, 6] * (1.0 + cams[:, 7] * r2
                          + cams[:, 8] * r2 * r2))[:, None] * p


def jacobians(cams, X, rnd=_same):
    """d projection / d camera (O,2,9) and / d point (O,2,3) at additive
    perturbations."""
    w, t, f, k1, k2 = (cams[:, :3], cams[:, 3:6], cams[:, 6], cams[:, 7],
                       cams[:, 8])
    K, _, b, c = _coefficients(w)
    R = rnd(rotation(w))
    P = (R @ rnd(X)[:, :, None])[:, :, 0] + t
    z = P[:, 2]
    free = torch.abs(z) > 1e-9
    z = torch.where(free, z, torch.sign(z) * 1e-9 + 1e-12)
    p = -P[:, :2] / z[:, None]
    r2 = torch.sum(p * p, dim=-1)
    d = 1.0 + k1 * r2 + k2 * r2 * r2
    zero = torch.zeros_like(z)
    dz = free.to(z.dtype) / (z * z)
    dp_dP = torch.stack([
        torch.stack([-1.0 / z, zero, P[:, 0] * dz], -1),
        torch.stack([zero, -1.0 / z, P[:, 1] * dz], -1)], -2)   # (O,2,3)
    eye2 = torch.eye(2, dtype=z.dtype, device=z.device)
    du_dp = ((f * d)[:, None, None] * eye2 + (f * (2.0 * k1 + 4.0 * k2 * r2))
             [:, None, None] * (p[:, :, None] * p[:, None, :]))
    A = rnd(du_dp) @ rnd(dp_dP)                                  # (O,2,3)
    eye3 = torch.eye(3, dtype=z.dtype, device=z.device)
    J_r = eye3 - b * K + c * (K @ K)
    dP_dw = -(R @ rnd(skew(X)) @ rnd(J_r))
    Jc = torch.cat([rnd(A) @ rnd(dP_dw), A, (d[:, None] * p)[:, :, None],
                    ((f * r2)[:, None] * p)[:, :, None],
                    ((f * r2 * r2)[:, None] * p)[:, :, None]], dim=-1)
    return Jc, rnd(A) @ R


def full_cost(cams, points, cam_idx, lm_idx, uv, w, delta,
              dtype=torch.float64):
    """The full Huber cost sum_i w_i huber(r_i) at (cams, points)."""
    r = (project(cams.to(dtype)[cam_idx.long()],
                 points.to(dtype)[lm_idx.long()]) - uv.to(dtype))
    r2 = torch.sum(r * r, dim=-1)
    return torch.sum(w.to(dtype) * huber_weights(r2, delta) * r2)


def pcg(matvec, b, Minv, iters: int):
    """`iters` iterations of conjugate gradients on S x = b from x = 0,
    preconditioned by the (C,9,9) blocks Minv, frozen once r.z falls to
    CG_EPS."""
    def precond(v):
        return torch.einsum("cij,cj->ci", Minv, v)

    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        if not bool(rz > CG_EPS):
            break
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = rz / (denom if bool(torch.abs(denom) >= CG_EPS) else CG_EPS)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def step(cams, points, cam_idx, lm_idx, uv, w, cfg: dict, lam,
         dtype=torch.float32, rnd=_same):
    """One LM iteration from (cams, points, lam) -> (cams, points, lam,
    accepted)."""
    ci, li = cam_idx.long(), lm_idx.long()
    C, L = cams.shape[0], points.shape[0]
    dev = cams.device
    delta = cfg["huber_delta"]

    def costs(cams_, points_):
        r = project(cams_[ci], points_[li], rnd) - uv
        r2 = torch.sum(r * r, dim=-1)
        return r, r2, torch.sum(w * huber_weights(r2, delta) * r2)

    r, r2, cost_cur = costs(cams, points)
    wt = w * huber_weights(r2, delta)
    Jc, Jl = jacobians(cams[ci], points[li], rnd)
    w3 = wt[:, None, None]
    Hcc = torch.zeros((C, 9, 9), dtype=dtype, device=dev).index_add_(
        0, ci, (rnd(Jc).transpose(1, 2) @ rnd(Jc)) * w3)
    Hll = torch.zeros((L, 3, 3), dtype=dtype, device=dev).index_add_(
        0, li, (rnd(Jl).transpose(1, 2) @ rnd(Jl)) * w3)
    W = (rnd(Jc).transpose(1, 2) @ rnd(Jl)) * w3                  # (O,9,3)
    rw = (r * wt[:, None])[:, :, None]
    bc = torch.zeros((C, 9), dtype=dtype, device=dev).index_add_(
        0, ci, -(rnd(Jc).transpose(1, 2) @ rnd(rw))[:, :, 0])
    bl = torch.zeros((L, 3), dtype=dtype, device=dev).index_add_(
        0, li, -(rnd(Jl).transpose(1, 2) @ rnd(rw))[:, :, 0])
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hcc_d = Hcc + lam * (Hcc * eye9) + 1e-6 * eye9
    Hll_inv = torch.linalg.inv(Hll + lam * (Hll * eye3) + 1e-6 * eye3)

    def back(x, a):
        """Hll_inv (a - sum_{o in l} W_o^T x_{c_o}) by landmark."""
        s = torch.zeros((L, 3), dtype=dtype, device=dev).index_add_(
            0, li, (rnd(W).transpose(1, 2) @ rnd(x)[ci][:, :, None])[:, :, 0])
        return (rnd(Hll_inv) @ rnd(a - s)[:, :, None])[:, :, 0]

    def cams_sum(v):
        return torch.zeros((C, 9), dtype=dtype, device=dev).index_add_(
            0, ci, (rnd(W) @ rnd(v)[li][:, :, None])[:, :, 0])

    def matvec(x):
        v = back(x, torch.zeros_like(bl))                  # -Hll_inv s
        return (rnd(Hcc_d) @ rnd(x)[:, :, None])[:, :, 0] + cams_sum(v)

    btil = bc - cams_sum((rnd(Hll_inv) @ rnd(bl)[:, :, None])[:, :, 0])
    dc = pcg(matvec, btil, torch.linalg.inv(Hcc_d), cfg["cg_iters"])
    dl = back(dc, bl)
    dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
    dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
    new_cams, new_points = cams + dc, points + dl
    _, _, cost_new = costs(new_cams, new_points)
    accept = bool(cost_new < cost_cur)
    if accept:
        cams, points, lam = new_cams, new_points, lam / cfg["lm_lambda_down"]
    else:
        lam = lam * cfg["lm_lambda_up"]
    return cams, points, min(max(lam, 1e-9), 1e6), accept


def lm(cams, points, cam_idx, lm_idx, uv, w, cfg: dict,
       dtype=torch.float32, rnd=_same):
    """`cfg["lm_iters"]` LM iterations -> (cams, points, full Huber cost,
    accept decisions). `cfg` holds BAConfig's fields."""
    cams, points = cams.to(dtype), points.to(dtype)
    uv, w = uv.to(dtype), w.to(dtype)
    lam = cfg["lm_lambda0"]
    accepted = []
    for _ in range(cfg["lm_iters"]):
        cams, points, lam, a = step(cams, points, cam_idx, lm_idx, uv, w,
                                    cfg, lam, dtype, rnd)
        accepted.append(a)
    r = project(cams[cam_idx.long()], points[lm_idx.long()]) - uv
    r2 = torch.sum(r * r, dim=-1)
    cost = torch.sum(w * huber_weights(r2, cfg["huber_delta"]) * r2)
    return cams, points, cost, accepted
