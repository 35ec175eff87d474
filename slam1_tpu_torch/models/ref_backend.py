"""Reference-parity pose-only backend (counterpart of
`slam1_tpu/models/ref_backend.py`): motion-prior regularised segment
optimisation with a loop-endpoint constraint.

The trajectory segment between the two frames of a loop is re-optimised
so that (a) each frame's relative twist stays near its odometry value
under per-axis motion-prior weights and (b) the composed chain matches
the loop-closure measurement under a large endpoint weight. Solved by
`lsq.levenberg_marquardt` on the segment's flattened twists, the chain
composed by a sequential loop of products in the reference's scan
order. The segment length is static: padding rows carry valid = False,
get zero weight and stay fixed.
"""

from __future__ import annotations

import torch

from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.ops.lsq import levenberg_marquardt

# Per-axis motion-prior costs (translation xyz, rotation xyz) and the
# endpoint weight, as the reference's backend sets them.
REF_MOTION_WEIGHTS = (1.0, 1.0, 5e-4, 0.5, 0.05, 1.0)
REF_ENDPOINT_WEIGHT = 1000.0


def _chain(T, twists, valid):
    """T @ exp(twists[0]) @ exp(twists[1]) @ ... over the valid rows
    (padding rows compose the identity), one product at a time in the
    reference's scan order: the (S,4,4) running products. The steps'
    exponentials are independent and taken in one batch; under
    `jacfwd` a chain of S steps is then S launches of one product each,
    not S exponentials."""
    eye = torch.eye(4, dtype=twists.dtype, device=twists.device)
    steps = torch.where(valid[:, None, None], se3.exp_se3(twists), eye)
    out = []
    for step in torch.unbind(steps):
        T = T @ step
        out.append(T)
    return torch.stack(out)


def optimize_segment(rel_twists, valid, Z_loop,
                     motion_weights=REF_MOTION_WEIGHTS,
                     endpoint_weight=REF_ENDPOINT_WEIGHT,
                     iters: int = 20, with_loop: bool = True):
    """Optimise a segment of per-frame relative twists.

    Args:
      rel_twists: (S,6) odometry twists frame k -> k+1 over the segment.
      valid: (S,) bool mask (padding rows get zero weight, stay fixed).
      Z_loop: (4,4) measured transform from segment start to segment end
        (from loop-closure verification).
    Returns:
      (optimised twists (S,6), final cost ()).
    """
    s = rel_twists.shape[0]
    dt, dev = rel_twists.dtype, rel_twists.device
    w_axis = torch.sqrt(torch.as_tensor(motion_weights, dtype=dt,
                                        device=dev))
    w_prior = valid.to(dt).repeat_interleave(6)
    w_end = torch.sqrt(torch.as_tensor(endpoint_weight, dtype=dt,
                                       device=dev))
    Z_inv = se3.inverse(Z_loop)
    eye = torch.eye(4, dtype=dt, device=dev)

    def residual(flat):
        xi = flat.reshape(s, 6)
        prior = ((xi - rel_twists) * w_axis[None, :]).reshape(-1)
        if not with_loop:
            return prior, w_prior
        T_chain = _chain(eye, xi, valid)[-1]
        end = w_end * se3.log_se3((Z_inv @ T_chain)[None])[0]
        return (torch.cat([prior, end]),
                torch.cat([w_prior, torch.ones(6, dtype=dt, device=dev)]))

    x, cost = levenberg_marquardt(residual, rel_twists.reshape(-1),
                                  iters=iters)
    return x.reshape(s, 6), cost


def recompose(T_start, rel_twists, valid):
    """Chain optimised twists back into absolute poses (S+1,4,4)."""
    return torch.cat([T_start[None], _chain(T_start, rel_twists, valid)])
