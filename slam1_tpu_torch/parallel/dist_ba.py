"""Distributed Schur-complement bundle adjustment (counterpart of
`slam1_tpu/parallel/dist_ba.py`).

Landmarks and their observations are partitioned into blocks along the
mesh axis "lm"; camera states are replicated. Each rank

  - linearises its local observations,
  - eliminates its local landmark 3x3 blocks (closed-form inverses),
  - contributes its camera-side reductions by all_reduce over "lm": the
    cost, Hcc, the gradient bc, the Schur correction of the right-hand
    side, and one (C,6) vector per CG matvec.

So communication is O(C) per CG iteration whatever the observation
count. Every sum that is reduced across ranks is accumulated in float64
on the rank and all_reduced in float64 before it is rounded once to the
working dtype (and the LM costs stay float64): on one rank the numbers
are those of the single-device `models/ba.py`, and across ranks only
the order of a few float64 additions differs, so the accept decisions
repeat from run to run.

`lm_idx` holds LOCAL indices into each shard's landmark block (the
partitioners keep observations with their landmark); cameras may be
observed from any shard. The problems carry no pose priors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models.ba import (BAProblem, _diag_only, _linearize,
                                       _obs_residual, make_problem)
from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.cg import cg
from slam1_tpu_torch.ops.lsq import huber_weights, inv3x3, inv_spd6
from slam1_tpu_torch.parallel import mesh as mesh_mod
from slam1_tpu_torch.parallel.mesh import Mesh

_SHARDED = ("cam_idx", "lm_idx", "uv", "w", "ur", "wr")


def partition_problem_device(problem: BAProblem, n_shards: int,
                             obs_per_shard: int = 0
                             ) -> Tuple[BAProblem, torch.Tensor,
                                        torch.Tensor]:
    """Landmark partitioner on the problem's device, without a host
    round trip. Landmarks are block-partitioned by index (shard s owns
    rows [s*Lk, (s+1)*Lk)); observations go to their landmark's shard by
    a stable sort and a per-shard rank, into `obs_per_shard` slots a
    shard (default ceil(2 O / n_shards)). Weight-0 observations take no
    slot; observations past a shard's capacity are dropped and counted.

    Returns (problem with a leading shard axis on points and the
    observation arrays, (n_shards, Lk) original landmark row of each
    shard row, () count of dropped observations)."""
    dev = problem.uv.device
    L = problem.points.shape[0]
    Lk = -(-L // n_shards)
    O = problem.uv.shape[0]
    Ok = obs_per_shard or max(-(-2 * O // n_shards), 1)

    lm = problem.lm_idx.long()
    is_real = (problem.w > 0) | (problem.wr > 0)
    shard_of = torch.where(is_real, torch.clamp(lm // Lk, 0, n_shards - 1),
                           torch.full_like(lm, n_shards))
    order = torch.sort(shard_of, stable=True).indices
    sorted_shard = shard_of[order]
    start = torch.searchsorted(sorted_shard,
                               torch.arange(n_shards, device=dev))
    rank = (torch.arange(O, device=dev)
            - start[torch.clamp(sorted_shard, max=n_shards - 1)])
    keep = (rank < Ok) & (sorted_shard < n_shards)
    # Dropped and unweighted observations land in one extra row that is
    # cut off below.
    row = torch.where(keep, sorted_shard * Ok + rank,
                      torch.full_like(rank, n_shards * Ok))
    n_dropped = torch.sum(~keep & (sorted_shard < n_shards))

    def scatter(x):
        flat = x.new_zeros((n_shards * Ok + 1,) + tuple(x.shape[1:]))
        flat[row] = x[order]
        return flat[:-1].reshape((n_shards, Ok) + tuple(x.shape[1:]))

    lm_local = lm - torch.clamp(shard_of, max=n_shards - 1) * Lk
    cols = dict(cam_idx=scatter(problem.cam_idx), lm_idx=scatter(lm_local),
                uv=scatter(problem.uv), w=scatter(problem.w),
                ur=scatter(problem.ur), wr=scatter(problem.wr))
    pad = n_shards * Lk - L
    pts = torch.cat([problem.points,
                     problem.points.new_zeros((pad, 3))]).reshape(
        n_shards, Lk, 3)
    orig = torch.arange(n_shards * Lk, dtype=torch.int32,
                        device=dev).reshape(n_shards, Lk)
    return problem._replace(points=pts, **cols), orig, n_dropped


def partition_problem(problem: BAProblem, n_shards: int
                      ) -> Tuple[BAProblem, torch.Tensor]:
    """Host partitioner (numpy), exact: every observation is kept and
    the shards are padded to the largest one. The oracle of
    `partition_problem_device` in the tests, and fine for one-shot
    setup. Returns (problem with a leading shard axis, (n_shards, Lk)
    original landmark row of each shard row)."""
    dev = problem.uv.device
    L = problem.points.shape[0]
    Lk = -(-L // n_shards)
    lm = problem.lm_idx.cpu().numpy()
    shard_of = lm // Lk
    per_shard = [np.nonzero(shard_of == s)[0] for s in range(n_shards)]
    Ok = max(max((len(p) for p in per_shard), default=1), 1)

    src = {k: getattr(problem, k).cpu().numpy() for k in _SHARDED}
    out = {k: np.zeros((n_shards, Ok) + v.shape[1:], v.dtype)
           for k, v in src.items()}
    for s, rows in enumerate(per_shard):
        k = len(rows)
        for name in _SHARDED:
            out[name][s, :k] = src[name][rows]
        out["lm_idx"][s, :k] -= s * Lk

    pts = np.zeros((n_shards, Lk, 3), np.float32)
    flat = problem.points.cpu().numpy()
    orig = np.zeros((n_shards, Lk), np.int32)
    for s in range(n_shards):
        lo, hi = s * Lk, min((s + 1) * Lk, L)
        pts[s, :hi - lo] = flat[lo:hi]
        orig[s, :hi - lo] = np.arange(lo, hi)

    t = {k: torch.as_tensor(v, device=dev) for k, v in out.items()}
    return (make_problem(poses=problem.poses,
                         points=torch.as_tensor(pts, device=dev), **t),
            torch.as_tensor(orig, device=dev))


def _seg_sum64(n: int, idx, vals):
    """(n, ...) float64 sums of `vals` (O, ...) by segment id `idx`."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(0, idx, vals.double())


def _psum(mesh: Mesh, partial64, dt):
    """all_reduce over "lm" of a float64 partial sum, rounded once."""
    return mesh_mod.all_reduce(mesh, partial64).to(dt)


def _local_irls(local: BAProblem, cam: StereoCamera, huber_delta: float):
    """Squared residual norms (O,) and Huber weights (O,) of the local
    observations at the local problem's estimate."""
    T = local.poses[local.cam_idx.long()]
    X = local.points[local.lm_idx.long()]
    r = _obs_residual(T, X, local.uv, local.ur, local.wr, cam)
    r2 = torch.sum(r * r, dim=-1)
    return r2, huber_weights(r2, huber_delta)


def _local_shard_step(mesh: Mesh, local: BAProblem, cam: StereoCamera,
                      lam, cut, cfg: BAConfig):
    """One damped Gauss-Newton step on this rank's shard `local` (poses
    replicated, points and observations the shard's). `cut` is the
    iteration's graduated outlier cut in px (inf disables): observations
    beyond it get zero weight for the step. Returns (camera step (C,6),
    landmark step (Lk,3), float64 cost () of the step's weights)."""
    C = local.poses.shape[0]
    Lk = local.points.shape[0]
    dt = local.uv.dtype
    ci, li = local.cam_idx.long(), local.lm_idx.long()

    r2, hw = _local_irls(local, cam, cfg.huber_delta)
    w_irls = local.w * hw * (r2 < cut * cut).to(dt)
    cost = mesh_mod.all_reduce(mesh, torch.sum((w_irls * r2).double()))

    r, Jc, Jl, _ = _linearize(local, cam, w_irls)
    w2 = w_irls[:, None, None]
    rw = r * w_irls[:, None]
    Hcc = _psum(mesh, _seg_sum64(C, ci, torch.einsum(
        "oai,oaj->oij", Jc, Jc) * w2), dt)
    Hll = _seg_sum64(Lk, li, torch.einsum(
        "oai,oaj->oij", Jl, Jl) * w2).to(dt)
    W = torch.einsum("oai,oaj->oij", Jc, Jl) * w2                # (O,6,3)
    bc = -_psum(mesh, _seg_sum64(C, ci, torch.einsum(
        "oai,oa->oi", Jc, rw)), dt)
    bl = -_seg_sum64(Lk, li, torch.einsum("oai,oa->oi", Jl, rw)).to(dt)

    eye6 = torch.eye(6, dtype=dt, device=r.device)
    eye3 = torch.eye(3, dtype=dt, device=r.device)
    Hcc_d = Hcc + lam * _diag_only(Hcc) + 1e-6 * eye6
    Hll_inv = inv3x3(Hll + lam * _diag_only(Hll) + 1e-6 * eye3)

    corr = _psum(mesh, _seg_sum64(C, ci, torch.einsum(
        "oij,oj->oi", W, torch.einsum("lij,lj->li", Hll_inv, bl)[li])), dt)
    btil = bc - corr
    btil[0].zero_()                                              # gauge

    def matvec(x):
        u = torch.einsum("oij,oi->oj", W, x[ci])
        v = torch.einsum("lij,lj->li", Hll_inv,
                         _seg_sum64(Lk, li, u).to(dt))
        y = _psum(mesh, _seg_sum64(C, ci, torch.einsum(
            "oij,oj->oi", W, v[li])), dt)          # one (C,6) all_reduce
        out = torch.einsum("cij,cj->ci", Hcc_d, x) - y
        out[0] = x[0]
        return out

    Minv = inv_spd6(Hcc_d)
    dc = cg(matvec, btil, iters=cfg.cg_iters,
            precond=lambda v: torch.einsum("cij,cj->ci", Minv, v))
    dc[0].zero_()
    u = torch.einsum("oij,oi->oj", W, dc[ci])
    dl = torch.einsum("lij,lj->li", Hll_inv,
                      bl - _seg_sum64(Lk, li, u).to(dt))
    return dc, dl, cost


def _local_cost(mesh: Mesh, local: BAProblem, cam: StereoCamera, cap,
                cfg: BAConfig):
    """The float64 robust cost over all shards, each observation's
    contribution saturated at `cap` (inf: plain Huber): the candidate
    pricing of the LM accept test, without Jacobians or a solve."""
    r2, hw = _local_irls(local, cam, cfg.huber_delta)
    contrib = torch.minimum(hw * r2, cap)
    return mesh_mod.all_reduce(mesh, torch.sum((local.w * contrib).double()))


def _cut_cap(cfg: BAConfig, t: int, dt, dev):
    """The graduated outlier cut of LM iteration t and the saturation
    cap of the objective it is judged on, as models/ba.bundle_adjust
    makes them (inf, inf without an outlier cut)."""
    if not cfg.outlier_px:
        inf = torch.full((), float("inf"), dtype=dt, device=dev)
        return inf, inf
    cut = torch.full((), cfg.outlier_px * max(1.0, 8.0 * 0.5 ** t),
                     dtype=dt, device=dev)
    cut2 = cut * cut
    return cut, huber_weights(cut2, cfg.huber_delta) * cut2


def distributed_bundle_adjust(problem: BAProblem, cam: StereoCamera,
                              cfg: BAConfig, mesh: Mesh,
                              return_trace: bool = False):
    """LM around the sharded Gauss-Newton step, the same graduated cut,
    cap, accept / reject and damping schedule as models/ba.bundle_adjust.
    `problem` comes from a partitioner with n_shards == the mesh's "lm"
    size; every rank passes the whole partitioned problem and works on
    its own shard on `mesh.device`.

    Returns (problem with the optimised poses and all shards' points,
    final cost ()), plus the (lm_iters,) accepted full-Huber cost trace
    when `return_trace`."""
    n_lm = mesh.shape["lm"]
    if problem.points.shape[0] != n_lm:
        raise ValueError(f"problem has {problem.points.shape[0]} shards, "
                         f"the mesh's lm axis {n_lm}")
    dev = mesh.device
    local = problem._replace(
        poses=mesh_mod.replicated(mesh, problem.poses),
        points=mesh_mod.lm_shard(mesh, problem.points)[0],
        **{k: mesh_mod.lm_shard(mesh, getattr(problem, k))[0]
           for k in _SHARDED})
    dt = local.uv.dtype
    cam = cam.to(dev)
    poses, points = local.poses, local.points
    lam = torch.full((), cfg.lm_lambda0, dtype=dt, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    costs = []
    for t in range(cfg.lm_iters):
        cut, cap = _cut_cap(cfg, t, dt, dev)
        cur = local._replace(poses=poses, points=points)
        cost_cur = _local_cost(mesh, cur, cam, cap, cfg)
        dc, dl, _ = _local_shard_step(mesh, cur, cam, lam, cut, cfg)
        dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
        dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
        new_poses = poses @ se3.exp_se3(dc)
        new_points = points + dl
        cost_new = _local_cost(mesh, local._replace(
            poses=new_poses, points=new_points), cam, cap, cfg)
        accept = cost_new < cost_cur
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam / cfg.lm_lambda_down,
                                      lam * cfg.lm_lambda_up), 1e-9, 1e6)
        # The full Huber cost of the accepted point, comparable across
        # iterations and with the single-device trace.
        costs.append(_local_cost(mesh, local._replace(
            poses=poses, points=points), cam, inf, cfg).to(dt))
    all_points = mesh_mod.gather_blocks(mesh, points[None])
    out = problem._replace(poses=poses, points=all_points)
    cost = costs[-1] if costs else _local_cost(mesh, local, cam, inf,
                                               cfg).to(dt)
    if return_trace:
        return out, cost, torch.stack(costs)
    return out, cost
