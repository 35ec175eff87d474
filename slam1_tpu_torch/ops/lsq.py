"""Nonlinear least squares and small closed-form solvers (counterpart
of `slam1_tpu/ops/lsq.py`).

`gauss_newton` and `levenberg_marquardt` minimise ||w * r(x)||^2 for a
caller's residual function over a fixed number of iterations (a plain
loop where the reference scans), with the Jacobian of the residual by
forward mode (`torch.func.jacfwd`, as the reference takes `jax.jacfwd`):
the residual function must be functional (no in-place ops, no reads of
a tensor's value on the host). Neither reads a value back to the host.

The 3x3 adjugate inverse and the 6x6 blockwise Schur inverse are kept
instead of `torch.linalg.solve`, so the numbers follow the reference's
arithmetic and batched GN over thousands of tiny systems stays
elementwise work.
"""

from __future__ import annotations

from typing import Callable

import torch


def weighted_normal_eqs(J, r, w):
    """H = J^T W J, g = J^T W r for (M,P) Jacobian, (M,) residual/weights."""
    Jw = J * w[:, None]
    return J.T @ Jw, Jw.T @ r


def _jacobian(residual_fn: Callable, x):
    """(M,P) Jacobian of residual_fn(x)[0] at x (forward mode), in x's
    dtype: PyTorch's forward mode makes float64 tangents for some ops on
    0-d float32 values (a power of an element, a clamp)."""
    return torch.func.jacfwd(lambda z: residual_fn(z)[0])(x).to(x.dtype)


def _finite(dx):
    """A non-finite step (a singular system, every residual masked) is
    no step."""
    return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))


def _solve(A, b):
    """A^-1 b without the error check (and so without a read-back); a
    singular A gives non-finite values, which `_finite` zeroes."""
    return torch.linalg.solve_ex(A, b[:, None])[0][:, 0]


def gauss_newton(residual_fn: Callable, x0, iters: int = 10,
                 damping: float = 1e-6):
    """Minimise ||w * r(x)||^2 with fixed-iteration damped Gauss-Newton.

    residual_fn(x) -> (r (M,), w (M,)); w may encode validity masks.
    Returns (x, final cost ())."""
    eye = torch.eye(x0.shape[-1], dtype=x0.dtype, device=x0.device)
    x = x0
    for _ in range(iters):
        r, w = residual_fn(x)
        H, g = weighted_normal_eqs(_jacobian(residual_fn, x), r, w)
        x = x - _finite(_solve(H + damping * eye, g))
    r, w = residual_fn(x)
    return x, torch.sum(w * r * r)


def levenberg_marquardt(residual_fn: Callable, x0, iters: int = 15,
                        lambda0: float = 1e-3, lambda_up: float = 4.0,
                        lambda_down: float = 2.0):
    """Levenberg-Marquardt with multiplicative damping and accept/reject
    steps; the residual contract of gauss_newton. Fixed iteration count:
    a rejected step only grows lambda. Returns (x, final cost ())."""
    eye = torch.eye(x0.shape[-1], dtype=x0.dtype, device=x0.device)

    def cost(x):
        r, w = residual_fn(x)
        return torch.sum(w * r * r)

    x = x0
    lam = torch.full((), lambda0, dtype=x0.dtype, device=x0.device)
    c = cost(x0)
    for _ in range(iters):
        r, w = residual_fn(x)
        H, g = weighted_normal_eqs(_jacobian(residual_fn, x), r, w)
        dx = _finite(_solve(H + lam * (torch.diag(torch.diag(H))
                                       + 1e-9 * eye), g))
        x_new = x - dx
        c_new = cost(x_new)
        accept = c_new < c
        x = torch.where(accept, x_new, x)
        c = torch.where(accept, c_new, c)
        lam = torch.clamp(torch.where(accept, lam / lambda_down,
                                      lam * lambda_up), 1e-10, 1e8)
    return x, c


def huber_weights(r2, delta: float):
    """IRLS weights for the Huber loss given squared residual norms."""
    d2 = delta * delta
    return torch.where(r2 <= d2, torch.ones_like(r2),
                       torch.sqrt(d2 / torch.clamp(r2, min=1e-12)))


def inv3x3(m):
    """Batched closed-form 3x3 inverse via the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = c * h - b * i
    cc = b * f - c * e
    cd = f * g - d * i
    ce = a * i - c * g
    cf = c * d - a * f
    cg = d * h - e * g
    ch = b * g - a * h
    ci = a * e - b * d
    det = a * ca + b * cd + c * cg
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                                torch.full_like(det, 1e-30))
    adj = torch.stack([
        torch.stack([ca, cb, cc], -1),
        torch.stack([cd, ce, cf], -1),
        torch.stack([cg, ch, ci], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def inv_spd6(H):
    """Batched closed-form inverse of a 6x6 SPD matrix via the 3x3
    blockwise Schur complement. H = [[A, B], [B^T, D]]:
        S    = D - B^T A^-1 B
        Hinv = [[A^-1 + A^-1 B S^-1 B^T A^-1,  -A^-1 B S^-1],
                [-S^-1 B^T A^-1,                S^-1       ]]
    """
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    Ai = inv3x3(A)
    Bt = B.transpose(-1, -2)
    AiB = Ai @ B
    S = D - Bt @ AiB
    Si = inv3x3(S)
    top_right = -AiB @ Si
    top_left = Ai + AiB @ Si @ AiB.transpose(-1, -2)
    bot_left = top_right.transpose(-1, -2)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def solve_spd6(H, g):
    """Solve the 6x6 SPD system H x = g (batched) via inv_spd6."""
    return (inv_spd6(H) @ g[..., None])[..., 0]
