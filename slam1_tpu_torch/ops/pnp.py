"""PnP pose estimation: batched-hypothesis RANSAC + Gauss-Newton refine
(counterpart of `slam1_tpu/ops/pnp.py`).

K hypotheses are refined in parallel as a written-out batch dimension,
scored by inlier count over the full masked correspondence set, and
the winner is polished with Huber-IRLS GN. The reference takes its
Jacobians with `jax.jacfwd` (`pnp.py:56`); here the same forward-mode
derivative is written out: the 6 unit tangents of the twist are carried
through exp_se3 -> transform -> project as one extra tensor dimension
(the small-angle branches differentiate as their Taylor forms, as
autodiff through `where` does). That is ~10x fewer small kernels per GN
iteration than `vmap(jacfwd)`, whose dispatch dominated the frame.

Convention: solves T_ba minimizing || proj(T_ba @ X_a) - uv_b ||.

RANSAC sampling draws a (K, N) uniform array in [1e-9, 1) — from a
`torch.Generator`, or passed in as `u` (tests hand both sides the
reference's exact draws) — and takes a Gumbel top-k over the mask. A
leading batch axis runs B problems at once (the reference's `vmap`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam1_tpu_torch.config import TrackingConfig
from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.ops.camera import StereoCamera, project
from slam1_tpu_torch.ops.kmeans import gumbel_top
from slam1_tpu_torch.ops.lsq import huber_weights, solve_spd6

U_MIN = 1e-9


class PnPResult(NamedTuple):
    T: torch.Tensor            # (4,4) best T_ba
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # () int64
    mean_err: torch.Tensor     # () float32 mean inlier reprojection error px
    ok: torch.Tensor           # () bool — enough support to trust T


def _exp_se3_jvp(xi):
    """exp_se3 of (K,6) twists and its derivative along the 6 unit
    tangents: R (K,3,3), t (K,3), dR (K,6,3,3), dt (K,6,3). Same
    formulas and small-angle branches as ops.se3.exp_se3."""
    rho, phi = xi[:, :3], xi[:, 3:]
    eye6 = torch.eye(6, dtype=xi.dtype, device=xi.device)
    drho, dphi = eye6[:, :3], eye6[:, 3:]                 # (6,3)

    def mat(v):                                           # (K,)->(K,1,1)
        return v[:, None, None]

    def tan(v):                                           # (K,6)->(K,6,1,1)
        return v[:, :, None, None]

    th2 = torch.sum(phi * phi, dim=-1)                    # (K,)
    dth2 = 2.0 * phi @ dphi.T                             # (K,6)
    small = th2 < 1e-8
    sm = small[:, None]
    theta = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    dtheta = torch.where(sm, torch.zeros_like(dth2), dth2 / (2.0 * theta[:, None]))
    s, c = torch.sin(theta), torch.cos(theta)
    th, st, ct, t2 = theta[:, None], s[:, None], c[:, None], th2[:, None]

    a = torch.where(small, 1.0 - th2 / 6.0, s / theta)
    da = torch.where(sm, -dth2 / 6.0, (ct * th - st) * dtheta / (th * th))
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - c) / th2)
    db = torch.where(sm, -dth2 / 24.0,
                     (st * dtheta * t2 - (1.0 - ct) * dth2) / (t2 * t2))
    q = th2 * theta
    cv = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (theta - s) / q)
    dq = dth2 * th + t2 * dtheta
    dcv = torch.where(sm, -dth2 / 120.0,
                      ((1.0 - ct) * dtheta * q[:, None] - (th - st) * dq)
                      / (q[:, None] * q[:, None]))

    K = se3.hat(phi)                                      # (K,3,3)
    K2 = K @ K
    dK = se3.hat(dphi)[None]                              # (1,6,3,3)
    dK2 = dK @ K[:, None] + K[:, None] @ dK               # (K,6,3,3)
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye3 + mat(a) * K + mat(b) * K2
    V = eye3 + mat(b) * K + mat(cv) * K2
    dR = (tan(da) * K[:, None] + mat(a)[:, None] * dK
          + tan(db) * K2[:, None] + mat(b)[:, None] * dK2)
    dV = (tan(db) * K[:, None] + mat(b)[:, None] * dK
          + tan(dcv) * K2[:, None] + mat(cv)[:, None] * dK2)
    t = (V @ rho[..., None])[..., 0]
    dt = (dV @ rho[:, None, :, None])[..., 0] + drho @ V.transpose(-1, -2)
    return R, t, dR, dt


def _residuals_and_jacobian(xi, X, uv, cam):
    """Reprojection residuals r (K,2n), their Jacobian J (K,2n,6) with
    respect to the twist, and the in-front mask (K,n), for a batch of
    twists xi (K,6) and point sets X (K,n,3), uv (K,n,2)."""
    R, t, dR, dt = _exp_se3_jvp(xi)
    Xc = X @ R.transpose(-1, -2) + t[:, None, :]                   # (K,n,3)
    dXc = (X[:, None] @ dR.transpose(-1, -2)) + dt[:, :, None, :]  # (K,6,n,3)
    uv_hat, front = project(cam, Xc)
    z = Xc[..., 2]
    zs = torch.where(front, z, torch.ones_like(z))[:, None]        # (K,1,n)
    dzs = torch.where(front[:, None], dXc[..., 2],
                      torch.zeros_like(dXc[..., 2]))
    du = cam.fx * (dXc[..., 0] * zs - Xc[:, None, :, 0] * dzs) / (zs * zs)
    dv = cam.fy * (dXc[..., 1] * zs - Xc[:, None, :, 1] * dzs) / (zs * zs)
    n = X.shape[1]
    J = torch.stack([du, dv], dim=-1).permute(0, 2, 3, 1).reshape(-1, 2 * n, 6)
    r = (uv_hat - uv).reshape(-1, 2 * n)
    return r, J, front


def _reproj_err2(xi, X, uv, cam):
    """(..., N) squared reprojection error; inf behind the camera."""
    Xc = se3.transform_points(se3.exp_se3(xi), X)
    uv_hat, in_front = project(cam, Xc)
    e2 = torch.sum((uv_hat - uv) ** 2, dim=-1)
    return torch.where(in_front, e2, torch.full_like(e2, float("inf")))


def _gn_refine(xi0, X, uv, w_pt, cam, iters: int, extra_weights=None):
    """Fixed-iteration damped GN on a batch of 6-dof twists.

    xi0: (K,6); X: (K,n,3); uv: (K,n,2); w_pt: (K,n).
    """
    eye = torch.eye(6, dtype=xi0.dtype, device=xi0.device)
    xi = xi0
    for _ in range(iters):
        r, J, front = _residuals_and_jacobian(xi, X, uv, cam)
        w = (front.to(xi.dtype) * w_pt).repeat_interleave(2, dim=-1)
        if extra_weights is not None:
            w = w * extra_weights(xi)
        Jw = J * w[..., None]
        H = J.transpose(-1, -2) @ Jw
        g = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
        dx = solve_spd6(H + 1e-5 * eye, g)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        xi = xi - dx
    return xi


def uniform(shape, generator: torch.Generator, device):
    """Uniform draws in [1e-9, 1) of `shape` (the reference's
    `jax.random.uniform(..., minval=1e-9, maxval=1.0)`)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u * (1.0 - U_MIN) + U_MIN


def draw_uniform(k: int, n: int, generator: torch.Generator, device):
    """(K,N) uniform draws in [1e-9, 1) for the Gumbel sampling."""
    return uniform((k, n), generator, device)


def _take(a, idx):
    """a[b, idx[b]] for a (B,K,...) and idx (B,): gather on the device
    (indexing with a 0-d tensor would read it back to the host)."""
    shape = (a.shape[0], 1) + a.shape[2:]
    i = idx.reshape((-1, 1) + (1,) * (a.dim() - 2)).expand(shape)
    return torch.gather(a, 1, i)[:, 0]


def ransac_pnp(X, uv, mask, cam: StereoCamera, cfg: TrackingConfig,
               xi_init=None, point_weights=None, *, generator=None,
               u=None) -> PnPResult:
    """RANSAC PnP over masked correspondences, optionally over a leading
    batch axis of B independent problems (the reference vmaps it over a
    loop-verification slate).

    Args:
      X:    (N,3) or (B,N,3) 3D points in camera frame A.
      uv:   (N,2) or (B,N,2) observed pixels in camera B.
      mask: (N,)  or (B,N) valid correspondences.
      xi_init: optional (6,) / (B,6) twist prior seeding every hypothesis.
      point_weights: optional (N,) / (B,N) soft weights for the polish.
      generator / u: source of the (K,N) / (B,K,N) sampling draws;
        exactly one.
    Returns a PnPResult with the same leading axes.
    """
    single = X.dim() == 2
    if single:
        X, uv, mask = X[None], uv[None], mask[None]
        xi_init = None if xi_init is None else xi_init[None]
        point_weights = (None if point_weights is None
                         else point_weights[None])
        u = None if u is None else u[None]
    res = _ransac_batched(X, uv, mask, cam, cfg, xi_init, point_weights,
                          generator, u)
    if single:
        res = PnPResult(*[v[0] for v in res])
    return res


def _ransac_batched(X, uv, mask, cam, cfg, xi_init, point_weights,
                    generator, u) -> PnPResult:
    b, n = mask.shape
    k = cfg.ransac_iters
    s = cfg.ransac_sample
    dev, dt = X.device, X.dtype
    if xi_init is None:
        xi_init = torch.zeros((b, 6), dtype=dt, device=dev)
    if u is None:
        if generator is None:
            raise ValueError("ransac_pnp needs a generator or draws u")
        u = uniform((b, k, n), generator, dev)
    if u.shape != (b, k, n):
        raise ValueError(f"draws u: expected {(b, k, n)}, "
                         f"got {tuple(u.shape)}")

    # Sample s valid indices per hypothesis (Gumbel top-k over the mask;
    # a stable sort sends ties — masked -inf rows — to the lowest index).
    samples = gumbel_top(u.to(device=dev, dtype=dt), mask[:, None, :], s)
    rows = torch.arange(b, device=dev)[:, None, None]
    xi0 = xi_init[:, None, :].expand(b, k, 6).reshape(b * k, 6)
    xis = _gn_refine(xi0, X[rows, samples].reshape(b * k, s, 3),
                     uv[rows, samples].reshape(b * k, s, 2),
                     mask[rows, samples].to(dt).reshape(b * k, s),
                     cam, cfg.gn_iters_hypo).reshape(b, k, 6)

    # Score all hypotheses over the full set.
    e2 = _reproj_err2(xis, X[:, None], uv[:, None], cam)        # (B,K,N)
    thresh2 = cfg.ransac_px_thresh ** 2
    inl = (e2 < thresh2) & mask[:, None, :]
    counts = torch.sum(inl, dim=2)
    best = torch.argmax(counts, dim=1)          # first occurrence on ties
    xi_best = _take(xis, best)
    inl_best = _take(inl, best)
    cnt_best = _take(counts, best)

    pw = (torch.ones_like(mask, dtype=dt) if point_weights is None
          else point_weights)

    def polish_weights(xi):
        e2p = _reproj_err2(xi, X, uv, cam)
        hw = huber_weights(e2p, cfg.huber_delta)
        return (hw * inl_best * pw).repeat_interleave(2, dim=-1)

    xi_pol = _gn_refine(xi_best, X, uv, mask.to(dt), cam,
                        cfg.gn_iters_polish, extra_weights=polish_weights)

    e2_pol = _reproj_err2(xi_pol, X, uv, cam)
    inliers = (e2_pol < thresh2) & mask
    num = torch.sum(inliers, dim=1)
    # Keep the polished pose only if it didn't lose support.
    use_pol = num >= cnt_best
    xi_final = torch.where(use_pol[:, None], xi_pol, xi_best)
    inliers = torch.where(use_pol[:, None], inliers, inl_best)
    num = torch.maximum(num, cnt_best)
    e2_fin = _reproj_err2(xi_final, X, uv, cam)
    mean_err = torch.sqrt(
        torch.sum(torch.where(inliers, e2_fin, torch.zeros_like(e2_fin)),
                  dim=1) / torch.clamp(num, min=1)).to(dt)
    ok = num >= cfg.min_track_points
    return PnPResult(T=se3.exp_se3(xi_final), inliers=inliers,
                     num_inliers=num, mean_err=mean_err, ok=ok)
