"""Preconditioned conjugate gradient with an implicit matvec
(counterpart of `slam1_tpu/ops/cg.py`).

The backend solvers never materialise their Hessians: CG consumes a
matvec closure built from per-edge gathers and scatter-adds. Fixed
iteration count and no data-dependent branch, so a solve never reads a
value back to the host.
"""

from __future__ import annotations

from typing import Callable

import torch


def cg(matvec: Callable, b, x0=None, iters: int = 64, precond=None,
       eps: float = 1e-12):
    """Solve A x = b; matvec / precond map a tensor to one of its shape."""
    x = torch.zeros_like(b) if x0 is None else x0
    if precond is None:
        precond = lambda v: v  # noqa: E731

    def dot(u, v):
        return torch.sum(u * v)

    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(torch.abs(denom) < eps,
                                 torch.full_like(denom, eps), denom)
        # freeze updates once the residual has vanished
        alive = rz > eps
        alpha = torch.where(alive, alpha, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(torch.abs(rz) < eps,
                                    torch.full_like(rz, eps), rz)
        beta = torch.where(alive, beta, zero)
        p = z + beta * p
        rz = rz_new
    return x
