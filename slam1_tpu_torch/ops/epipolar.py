"""Two-view epipolar geometry (counterpart of `slam1_tpu/ops/epipolar.py`):
the fundamental matrix by 8-point RANSAC, and the relative pose of a
monocular pair through the essential matrix.

K hypotheses are solved at once (normalised 8-point through a batched
SVD of the design matrices, rank-2 projection), scored by Sampson
distance over all correspondences, best by inlier count, then polished
on the winner's inliers. The samples are the top 8 Gumbel scores of
(K, N) uniform draws that the caller passes in (`u`, as the reference's
`jax.random.uniform` would draw them) or that a `torch.Generator` makes;
ties, which masked -inf scores make when fewer than 8 points are valid,
go to the lowest index (a stable sort).

Singular vectors are defined up to sign: F is scaled by its (2,2) entry
and the pose is chosen by the cheirality vote, so neither depends on
the signs the SVD returns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slam1_tpu_torch.ops.kmeans import gumbel_top
from slam1_tpu_torch.ops.pnp import draw_uniform


class FMatResult(NamedTuple):
    F: torch.Tensor            # (3,3)
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # () int
    ok: torch.Tensor           # () bool


class PoseFromE(NamedTuple):
    T: torch.Tensor            # (4,4) camera2-from-camera1, |t| = 1
    inliers: torch.Tensor      # (N,) epipolar inliers used for the vote
    num_inliers: torch.Tensor
    ok: torch.Tensor


def _normalize(uv, mask):
    """Hartley normalisation: zero mean, sqrt(2) RMS distance (masked)."""
    w = mask.to(uv.dtype)[:, None]
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(uv * w, dim=0) / n
    d = torch.sqrt(torch.sum(torch.sum((uv - mean) ** 2 * w, dim=-1)) / n)
    s = 2.0 ** 0.5 / torch.clamp(d, min=1e-6)
    zero = torch.zeros_like(s)
    T = torch.stack([torch.stack([s, zero, -s * mean[0]]),
                     torch.stack([zero, s, -s * mean[1]]),
                     torch.stack([zero, zero, torch.ones_like(s)])])
    return (uv - mean) * s, T


def _null_vector(A):
    """Right singular vector of the smallest singular value of (..., M, 9)
    design matrices. Fewer than 9 rows are padded with zero rows, which
    leave A^T A, and so the right singular vectors, unchanged."""
    m = A.shape[-2]
    if m < 9:
        A = torch.cat([A, A.new_zeros(A.shape[:-2] + (9 - m, 9))], dim=-2)
    return torch.linalg.svd(A, full_matrices=False).Vh[..., 8, :]


def _eight_point(uv1n, uv2n, T1, T2, w):
    """F from >= 8 weighted normalised correspondences, over any leading
    batch axes: uv (..., M, 2), w (..., M) -> F (..., 3, 3)."""
    x1, y1 = uv1n[..., 0], uv1n[..., 1]
    x2, y2 = uv2n[..., 0], uv2n[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1) * w[..., None]
    F = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    # rank-2 projection
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = (U * S[..., None, :]) @ Vh
    F = T2.T @ F @ T1
    f22 = F[..., 2:3, 2:3]
    return F / (f22 + torch.where(torch.abs(f22) < 1e-12,
                                  torch.full_like(f22, 1e-12),
                                  torch.zeros_like(f22)))


def sampson_distance(F, uv1, uv2):
    """First-order geometric error of x2^T F x1 = 0: F (..., 3, 3),
    uv (N,2) -> (..., N)."""
    ones = torch.ones_like(uv1[:, :1])
    x1 = torch.cat([uv1, ones], dim=-1)
    x2 = torch.cat([uv2, ones], dim=-1)
    Fx1 = x1 @ F.transpose(-1, -2)          # (..., N, 3)
    Ftx2 = x2 @ F                           # (..., N, 3)
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def _at(a, i):
    """a[i] for a 0-d index tensor i, without reading i on the host."""
    return a.index_select(0, i.reshape(1))[0]


def _draws(u, generator, k: int, n: int, device):
    if (u is None) == (generator is None):
        raise ValueError("pass exactly one of u (draws) and generator")
    if u is None:
        return draw_uniform(k, n, generator, device)
    if tuple(u.shape) != (k, n):
        raise ValueError(f"draws of shape {tuple(u.shape)}, want {(k, n)}")
    return u.to(device)


def ransac_fundamental(uv1, uv2, mask, iters: int = 128,
                       px_thresh: float = 1.5, min_inliers: int = 12, *,
                       u=None, generator: Optional[torch.Generator] = None
                       ) -> FMatResult:
    """8-point RANSAC over masked correspondences uv1, uv2 (N,2).
    `u` (iters, N) uniform draws in [1e-9, 1) or `generator`: exactly
    one."""
    n = uv1.shape[0]
    dt = uv1.dtype
    uv1n, T1 = _normalize(uv1, mask)
    uv2n, T2 = _normalize(uv2, mask)
    u = _draws(u, generator, iters, n, uv1.device)
    samples = gumbel_top(u.to(dt), mask[None, :], 8)            # (K,8)

    Fs = _eight_point(uv1n[samples], uv2n[samples], T1, T2,
                      mask[samples].to(dt))                       # (K,3,3)
    d = sampson_distance(Fs, uv1, uv2)                            # (K,N)
    t2 = px_thresh * px_thresh
    inl = (d < t2) & mask[None, :]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)
    inl_best, count_best = _at(inl, best), _at(counts, best)
    # Final polish: 8-point on all inliers of the best model.
    F = _eight_point(uv1n, uv2n, T1, T2, inl_best.to(dt))
    inliers = (sampson_distance(F, uv1, uv2) < t2) & mask
    num = torch.sum(inliers)
    use_polished = num >= count_best
    F = torch.where(use_polished, F, _at(Fs, best))
    inliers = torch.where(use_polished, inliers, inl_best)
    num = torch.maximum(num, count_best)
    return FMatResult(F=F, inliers=inliers, num_inliers=num,
                      ok=num >= min_inliers)


def decompose_essential(E):
    """E -> (R1, R2, t) candidate factors (Hartley & Zisserman 9.6.2)."""
    U, _, Vh = torch.linalg.svd(E)
    # Proper rotations: flip the sign of the singular vector blocks.
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vh, U @ W.T @ Vh, U[:, 2]


def _triangulate_pair(R, t, x1, x2):
    """Midpoint two-view triangulation in normalised coordinates (P1 =
    [I|0], P2 = [R|t]) over candidates R (C,3,3), t (C,3) and
    correspondences x (N,3): depths (z1, z2), each (C,N)."""
    # [x1, -R^T x2] [z1 z2]^T = -R^T t, by 2x2 normal equations.
    a = x1[None]                                      # (1,N,3)
    b = -(x2[None] @ R)                               # rows R^T x2 (C,N,3)
    rhs = -(t[:, None, :] @ R)                        # (C,1,3)
    aa = torch.sum(a * a, -1)
    ab = torch.sum(a * b, -1)
    bb = torch.sum(b * b, -1)
    ar = torch.sum(a * rhs, -1)
    br = torch.sum(b * rhs, -1)
    det = aa * bb - ab * ab
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    z1 = (bb * ar - ab * br) / det
    # depth in camera 2 of the camera-1 point: (R X1 + t).z
    X1 = x1[None] * z1[..., None]
    d2 = (X1 @ R.transpose(-1, -2) + t[:, None, :])[..., 2]
    return z1, d2


def recover_pose_2d2d(uv1, uv2, mask, K, iters: int = 256,
                      px_thresh: float = 1.5, min_inliers: int = 12, *,
                      u=None, generator: Optional[torch.Generator] = None
                      ) -> PoseFromE:
    """Relative pose from 2D-2D correspondences (x2 ~ R x1 + t, |t| = 1):
    RANSAC-F -> E = K^T F K -> the four (R, t) candidates -> the
    cheirality vote (correspondences with positive depth in both
    cameras, among the epipolar inliers)."""
    fres = ransac_fundamental(uv1, uv2, mask, iters=iters,
                              px_thresh=px_thresh, min_inliers=min_inliers,
                              u=u, generator=generator)
    E = K.T @ fres.F @ K
    # project onto the essential manifold: singular values (1, 1, 0)
    U, _, Vh = torch.linalg.svd(E)
    E = U @ torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype,
                                    device=E.device)) @ Vh
    R1, R2, t = decompose_essential(E)

    Kinv = torch.linalg.inv_ex(K)[0]
    ones = torch.ones_like(uv1[:, :1])
    x1 = torch.cat([uv1, ones], -1) @ Kinv.T
    x2 = torch.cat([uv2, ones], -1) @ Kinv.T

    Rs = torch.stack([R1, R1, R2, R2])                   # (4,3,3)
    ts = torch.stack([t, -t, t, -t])                     # (4,3)
    z1, z2 = _triangulate_pair(Rs, ts, x1, x2)           # (4,N) each
    good = (z1 > 0) & (z2 > 0) & fres.inliers[None, :]
    votes = torch.sum(good, dim=1)
    best = torch.argmax(votes)
    T = torch.eye(4, dtype=uv1.dtype, device=uv1.device)
    T = torch.cat([torch.cat([_at(Rs, best), _at(ts, best)[:, None]], dim=1),
                   T[3:]])
    ok = fres.ok & (_at(votes, best) >= min_inliers)
    return PoseFromE(T=T, inliers=fres.inliers,
                     num_inliers=fres.num_inliers, ok=ok)
