"""Segment sums in float64, rounded once.

CUDA's `index_add_` adds in the order its atomics land, and a float32
sum that depends on that order flips strict LM accept decisions between
two runs of the same clip; summing in float64 and rounding once to the
working dtype makes the sum independent of that order in practice.
Bundle adjustment (`models/ba.py`, `models/bal.py`) and the plain twins
of its reduced-system kernels (`ops/cuda_kernels.py`) sum this way.
"""

from __future__ import annotations

import torch


def seg_sum(n: int, idx, vals):
    """(n, ...) sums of `vals` (O, ...) by segment id `idx` (O,),
    accumulated in float64 and rounded once to vals' dtype."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, idx, vals.double())
    return out.to(vals.dtype)
