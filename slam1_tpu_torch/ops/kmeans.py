"""Lloyd-iteration k-means for visual vocabularies (counterpart of
`slam1_tpu/ops/kmeans.py`).

Descriptors as {-1,+1}^D vectors make the assignment step one matrix
product (argmax of the dot product = argmin of the Euclidean distance
on constant-norm rows) and the update a one-hot segment mean. Fixed
iteration count. The initial centroids are a Gumbel top-k over the
mask, from (M,) uniform draws `u` in [1e-9, 1) that the caller passes
in (tests hand the port the reference's exact draws).
"""

from __future__ import annotations

import torch


def gumbel_top(u, mask, k: int):
    """Indices of the k largest Gumbel scores -log(-log(u)) among the
    valid entries of the last axis; invalid entries score -inf and ties
    go to the lowest index (a stable sort, as lax.top_k orders them)."""
    g = -torch.log(-torch.log(u))
    scores = torch.where(mask, g, torch.full_like(g, float("-inf")))
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def assign_words(x, centroids):
    """(..., M, D) x (k, D) -> (..., M) nearest-centroid ids (dot-product
    metric; the first index on ties)."""
    return torch.argmax(x @ centroids.T, dim=-1).to(torch.int32)


def kmeans_pm1(x, mask, k: int, iters: int = 12, *, u):
    """k-means over (M,D) float rows of constant norm (e.g. +-1).

    x: (M,D) float32; mask: (M,) validity; u: (M,) uniform draws.
    Returns (centroids (k,D) float32, assignments (M,) int32).
    """
    cent = x[gumbel_top(u.to(x.device, x.dtype), mask, k)]
    wm = mask.to(x.dtype)
    for _ in range(iters):
        assign = torch.argmax(x @ cent.T, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        onehot = onehot * wm[:, None]
        sums = onehot.T @ x                                 # (k,D)
        counts = torch.sum(onehot, dim=0)[:, None]          # (k,1)
        new_cent = sums / torch.clamp(counts, min=1.0)
        # Empty clusters keep their previous centroid.
        cent = torch.where(counts > 0, new_cent, cent)
    return cent, assign_words(x, cent)
