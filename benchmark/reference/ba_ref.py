"""Plain reference of the standalone bundle adjustment
(`ba.bundle_adjust`, no pose priors): Levenberg-Marquardt over camera
poses (camera 0 held, each moved on the right, T exp(delta)) and world
points, stereo residuals [u_left, v_left, u_right] with the depth
clamped at 1e-3, Huber IRLS weights, the graduated outlier cut
outlier_px * 2 ** max(3 - t, 0) of iteration t, acceptance on the
truncated cost at that cut, the damping H + lam diag(H) + 1e-6 I, and
lam divided by lm_lambda_down on acceptance and multiplied by
lm_lambda_up otherwise, clipped to [1e-9, 1e6]. Each step's reduced
camera system (landmarks eliminated) is built densely and solved as
the configuration states: exactly where the problem has at most
`DIRECT_MAX_CAMS` camera rows, else by `cg_iters` iterations of
conjugate gradients from zero, preconditioned by the inverse of each
camera's damped 6x6 block, updates frozen once r.z falls to 1e-12.
Plain PyTorch, in float64 by default; cameras that no observation
touches stay where they are.
"""

from __future__ import annotations

import torch

from benchmark.yardstick import se3

Z_MIN = 1e-3
DIRECT_MAX_CAMS = 16
CG_EPS = 1e-12


def huber_weights(r2, delta):
    d2 = delta * delta
    return torch.where(r2 <= d2, torch.ones_like(r2),
                       torch.sqrt(d2 / torch.clamp(r2, min=1e-12)))


def _same(x):
    return x


def residuals(poses, points, cam_idx, lm_idx, uv, ur, cam, rnd=_same):
    """(O,3) residuals, camera-frame points (O,3) and the unclamped-depth
    mask (O,). `rnd` rounds the operands of every product (the identity
    but in the controls)."""
    T = poses[cam_idx]
    R = T[:, :3, :3]
    Xc = (rnd(points[lm_idx] - T[:, :3, 3])[:, None, :] @ rnd(R))[:, 0]
    free = Xc[:, 2] > Z_MIN
    z = torch.clamp(Xc[:, 2], min=Z_MIN)
    r = torch.stack([cam.fx * Xc[:, 0] / z + cam.cx - uv[:, 0],
                     cam.fy * Xc[:, 1] / z + cam.cy - uv[:, 1],
                     cam.fx * (Xc[:, 0] - cam.baseline) / z + cam.cx - ur],
                    dim=-1)
    return r, Xc, free


def jacobians(poses, cam_idx, Xc, free, cam, rnd=_same):
    """d r / d camera twist (O,3,6) and d r / d point (O,3,3): with
    Xc = R^T (X - t), d Xc / d twist = [-I | hat(Xc)], d Xc / d X = R^T;
    the depth's derivative is 0 below the clamp."""
    z = torch.clamp(Xc[:, 2], min=Z_MIN)
    dz = free.to(Xc.dtype) / (z * z)
    zero = torch.zeros_like(z)
    Jp = torch.stack([
        torch.stack([cam.fx / z, zero, -cam.fx * Xc[:, 0] * dz], -1),
        torch.stack([zero, cam.fy / z, -cam.fy * Xc[:, 1] * dz], -1),
        torch.stack([cam.fx / z, zero,
                     -cam.fx * (Xc[:, 0] - cam.baseline) * dz], -1)], -2)
    Jp = rnd(Jp)
    Jc = torch.cat([-Jp, Jp @ se3.hat(rnd(Xc))], dim=-1)
    Jl = Jp @ rnd(poses[cam_idx][:, :3, :3].transpose(-1, -2))
    return rnd(Jc), rnd(Jl)


def full_cost(poses, points, cam_idx, lm_idx, uv, ur, w, cam, delta,
              dtype=torch.float64):
    """The full Huber cost sum_i w_i huber(r_i) at (poses, points)."""
    r, _, _ = residuals(poses.to(dtype), points.to(dtype), cam_idx.long(),
                        lm_idx.long(), uv.to(dtype), ur.to(dtype), cam)
    r2 = torch.sum(r * r, dim=-1)
    return torch.sum(w.to(dtype) * huber_weights(r2, delta) * r2)


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest): what a TF32
    tensor-core product reads of a float32 operand."""
    x = x.float().contiguous()
    i = x.view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def pcg(S, b, Minv, iters: int, rnd=_same):
    """`iters` iterations of conjugate gradients on S x = b from x = 0,
    preconditioned by the (n,6,6) blocks Minv; the updates stop once
    r.z falls to CG_EPS."""
    def precond(v):
        return torch.einsum("cij,cj->ci", Minv, v.reshape(-1, 6)).reshape(-1)

    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        if not bool(rz > CG_EPS):
            break
        Ap = rnd(S) @ rnd(p)
        denom = torch.dot(p, Ap)
        alpha = rz / (denom if bool(torch.abs(denom) >= CG_EPS) else CG_EPS)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def lm(poses, points, cam_idx, lm_idx, uv, ur, w, cam, cfg: dict,
       dtype=torch.float64, rnd=_same):
    """`cfg["lm_iters"]` LM iterations -> (poses, points, full Huber
    cost). `cfg` holds BAConfig's fields; `cam` any object with fx, fy,
    cx, cy and baseline; `rnd` rounds the operands of every product
    (`tf32` for the control, in float32)."""
    P = poses.to(dtype)
    X = points.to(dtype)
    uv, ur, w = uv.to(dtype), ur.to(dtype), w.to(dtype)
    ci, li = cam_idx.long(), lm_idx.long()
    dev = P.device
    live = torch.unique(ci)                 # cameras observations touch
    n_live = live.shape[0]
    slot = torch.full((P.shape[0],), -1, dtype=torch.long, device=dev)
    slot[live] = torch.arange(n_live, device=dev)
    cs = slot[ci]                           # live slot of each observation
    L = X.shape[0]
    delta, lam = cfg["huber_delta"], cfg["lm_lambda0"]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    gauge = int(slot[0]) if int(slot[0]) >= 0 else None

    def costs(P_, X_, cap):
        r, _, _ = residuals(P_, X_, ci, li, uv, ur, cam, rnd)
        r2 = torch.sum(r * r, dim=-1)
        c = huber_weights(r2, delta) * r2
        trunc = c if cap is None else torch.minimum(c, cap)
        return torch.sum(w * c), torch.sum(w * trunc)

    for t in range(cfg["lm_iters"]):
        r, Xc, free = residuals(P, X, ci, li, uv, ur, cam, rnd)
        r2 = torch.sum(r * r, dim=-1)
        hw = huber_weights(r2, delta)
        wt = w * hw
        cap = None
        if cfg["outlier_px"]:
            cut = cfg["outlier_px"] * 2.0 ** max(3 - t, 0)
            wt = wt * (r2 < cut * cut).to(dtype)
            cap = huber_weights(torch.tensor(cut * cut, dtype=dtype),
                                delta) * cut * cut
        _, cost_cur = costs(P, X, cap)
        Jc, Jl = jacobians(P, ci, Xc, free, cam, rnd)
        w3 = wt[:, None, None]
        Hcc = torch.zeros((n_live, 6, 6), dtype=dtype, device=dev)
        Hcc.index_add_(0, cs, torch.einsum("oai,oaj->oij", Jc, Jc) * w3)
        Hll = torch.zeros((L, 3, 3), dtype=dtype, device=dev)
        Hll.index_add_(0, li, torch.einsum("oai,oaj->oij", Jl, Jl) * w3)
        W = torch.einsum("oai,oaj->oij", Jc, Jl) * w3           # (O,6,3)
        rw = r * wt[:, None]
        bc = torch.zeros((n_live, 6), dtype=dtype, device=dev)
        bc.index_add_(0, cs, -torch.einsum("oai,oa->oi", Jc, rw))
        bl = torch.zeros((L, 3), dtype=dtype, device=dev)
        bl.index_add_(0, li, -torch.einsum("oai,oa->oi", Jl, rw))
        Hcc = Hcc + lam * (Hcc * eye6) + 1e-6 * eye6
        Hll_inv = torch.linalg.inv(Hll + lam * (Hll * eye3) + 1e-6 * eye3)
        # Reduced camera system S dc = btil, landmarks eliminated:
        # S = Hcc - B^T Hll^-1 B with B (3L, 6C) holding W^T by blocks.
        B = torch.zeros((L, n_live, 3, 6), dtype=dtype, device=dev)
        B.index_put_((li, cs), W.transpose(1, 2), accumulate=True)
        B = B.transpose(1, 2).reshape(L * 3, n_live * 6)
        G = (rnd(Hll_inv) @ rnd(B.reshape(L, 3, -1))).reshape(L * 3, -1)
        S = -(rnd(B).T @ rnd(G))
        del G
        S.view(n_live, 6, n_live, 6)[torch.arange(n_live), :,
                                     torch.arange(n_live), :] += Hcc
        btil = bc.reshape(-1) - B.T @ (Hll_inv @ bl[..., None]).reshape(-1)
        del B
        if gauge is not None:
            g = slice(6 * gauge, 6 * gauge + 6)
            S[g, :] = 0.0
            S[:, g] = 0.0
            S[g, g] = eye6
            btil[g] = 0.0
        if P.shape[0] <= DIRECT_MAX_CAMS:
            dc = torch.linalg.solve(S, btil).reshape(n_live, 6)
        else:
            dc = pcg(S, btil, torch.linalg.inv(Hcc), cfg["cg_iters"], rnd)
            dc = dc.reshape(n_live, 6)
        del S
        u = torch.zeros((L, 3), dtype=dtype, device=dev)
        u.index_add_(0, li, torch.einsum("oij,oi->oj", W, dc[cs]))
        dl = (Hll_inv @ (bl - u)[..., None])[..., 0]
        P_new = P.clone()
        P_new[live] = rnd(P[live]) @ rnd(se3.exp_se3(dc))
        X_new = X + dl
        _, cost_new = costs(P_new, X_new, cap)
        if bool(cost_new < cost_cur):
            P, X, lam = P_new, X_new, lam / cfg["lm_lambda_down"]
        else:
            lam = lam * cfg["lm_lambda_up"]
        lam = min(max(lam, 1e-9), 1e6)
    full, _ = costs(P, X, None)
    return P, X, full
