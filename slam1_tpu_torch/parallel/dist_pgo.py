"""Keyframe-axis sharded pose-graph optimisation with a ring halo
(counterpart of `slam1_tpu/parallel/dist_pgo.py`).

Each rank of a mesh axis owns a contiguous block of B poses and the
odometry edges that start in it. The chain couples blocks only at their
boundaries, handled on the ring of the axis's ranks:

  - every Gauss-Newton and CG step sends each rank's first pose / delta
    to its left neighbour (`mesh.ring_shift`), and the boundary edge's
    gradient contribution rides the reverse shift;
  - loop-closure edges (fixed capacity, replicated) get their endpoint
    states by a masked gather and one all_reduce per step, and scatter
    their Hessian contributions into the rows a rank owns;
  - the PCG dot products are all_reduced (float64 partial dots).

Each rank preconditions its block with the exact square-root chain
solve of `posegraph._chain_sqrt_solve` (the `chain_prepare` /
`chain_sweep` kernels on CUDA tensors), so CG only has to carry the
cross-boundary edges and the loop edges.
"""

from __future__ import annotations

from typing import Optional

import torch

from slam1_tpu_torch.models.posegraph import (_chain_sqrt_solve, _inv6,
                                              _jacobians)
from slam1_tpu_torch.ops import dispatch, se3
from slam1_tpu_torch.ops.lsq import inv_spd6
from slam1_tpu_torch.parallel import mesh as mesh_mod
from slam1_tpu_torch.parallel.mesh import Mesh


def _masked_terms(T_i, T_j, Z, w):
    """Residuals (E,6) and Jacobians (E,6,6) x 2 of edges, zero where the
    weight is 0 (a disabled edge's terms can be NaN, and 0 * NaN would
    poison the solve)."""
    r, Ji, Jj = _jacobians(T_i, T_j, Z)
    ok = (w > 0)[:, None]
    return (torch.where(ok, r, torch.zeros_like(r)),
            torch.where(ok[..., None], Ji, torch.zeros_like(Ji)),
            torch.where(ok[..., None], Jj, torch.zeros_like(Jj)))


def _local_pgo(mesh: Mesh, axis: str, poses_blk, z_blk, w_blk, le_i, le_j,
               le_z, le_w, *, iters: int, cg_iters: int, damping: float,
               n_live: int):
    """Gauss-Newton on this rank's block. poses_blk (B,4,4); z_blk,
    w_blk (B,4,4), (B,): edge k goes from global pose lo+k to lo+k+1,
    the last one into the right neighbour's block (the final global slot
    is weight-0 padding). Loop-edge arrays are replicated. `n_live`:
    rows of the block from which on no chain edge lives. Returns (the
    block's poses, the global cost ())."""
    B = poses_blk.shape[0]
    s = mesh.index(axis)
    lo = s * B
    E = le_i.shape[0]
    dt, dev = poses_blk.dtype, poses_blk.device
    eye6 = torch.eye(6, dtype=dt, device=dev)

    own_i = (le_i >= lo) & (le_i < lo + B)
    own_j = (le_j >= lo) & (le_j < lo + B)
    li_loc = torch.clamp(le_i - lo, 0, B - 1)
    lj_loc = torch.clamp(le_j - lo, 0, B - 1)
    # Loop-edge rows this rank does not own go to a dropped extra row.
    li_row = torch.where(own_i, li_loc, torch.full_like(li_loc, B))
    lj_row = torch.where(own_j, lj_loc, torch.full_like(lj_loc, B))

    def gather_loop(x):
        """The replicated (E, ...) endpoint values of a block-sharded
        per-pose array: one all_reduce of both ends."""
        shp = (E,) + (1,) * (x.dim() - 1)
        both = torch.stack([
            torch.where(own_i.reshape(shp), x[li_loc], torch.zeros_like(
                x[li_loc])),
            torch.where(own_j.reshape(shp), x[lj_loc], torch.zeros_like(
                x[lj_loc]))])
        both = mesh_mod.all_reduce(mesh, both, axis)
        return both[0], both[1]

    def halo_first(x):
        """The right neighbour's first row."""
        return mesh_mod.ring_shift(mesh, x[0], -1, axis)

    def pin(outv, val_row0):
        """Gauge: global pose 0 (rank 0, row 0)."""
        if s == 0:
            outv = torch.cat([val_row0[None], outv[1:]])
        return outv

    def residuals(poses):
        T_j = torch.cat([poses[1:], halo_first(poses)[None]])
        Tle_i, Tle_j = gather_loop(poses)
        return (_masked_terms(poses, T_j, z_blk, w_blk),
                _masked_terms(Tle_i, Tle_j, le_z, le_w))

    w = w_blk[:, None]
    wl = le_w[:, None]
    poses = poses_blk
    for _ in range(iters):
        (r0, Ji, Jj), (rl, Jli, Jlj) = residuals(poses)

        def scatter(y_odo, y_loop, Ji=Ji, Jj=Jj, Jli=Jli, Jlj=Jlj):
            """(B,6) per-pose sums of the odometry edges' (B,6) and the
            loop edges' (E,6) contributions, with the boundary halo."""
            out = torch.einsum("eab,ea->eb", Ji, y_odo)
            out = out + torch.cat([torch.zeros_like(out[:1]), torch.einsum(
                "eab,ea->eb", Jj[:-1], y_odo[:-1])])
            recv = mesh_mod.ring_shift(
                mesh, torch.einsum("ab,a->b", Jj[-1], y_odo[-1]), +1, axis)
            out = out + torch.cat([recv[None], torch.zeros_like(out[1:])])
            loop = torch.zeros((B + 1, 6), dtype=torch.float64, device=dev)
            loop.index_add_(0, li_row, torch.einsum(
                "eab,ea->eb", Jli, y_loop).double())
            loop.index_add_(0, lj_row, torch.einsum(
                "eab,ea->eb", Jlj, y_loop).double())
            return out + loop[:B].to(dt)

        b = pin(-scatter(r0 * w, rl * wl), torch.zeros(6, dtype=dt,
                                                       device=dev))

        def matvec(x, Ji=Ji, Jj=Jj, Jli=Jli, Jlj=Jlj, scatter=scatter):
            xj = torch.cat([x[1:], halo_first(x)[None]])
            y = (torch.einsum("eab,eb->ea", Ji, x)
                 + torch.einsum("eab,eb->ea", Jj, xj)) * w
            xle_i, xle_j = gather_loop(x)
            yl = (torch.einsum("eab,eb->ea", Jli, xle_i)
                  + torch.einsum("eab,eb->ea", Jlj, xle_j)) * wl
            return pin(scatter(y, yl) + damping * x, x[0])

        # Per-block chain preconditioner: the exact square-root chain
        # solve over the block's own odometry edges (row k holds edge
        # k-1 -> k; row 0's edge belongs to the left neighbour).
        JiC = torch.cat([torch.zeros_like(Ji[:1]), Ji[:B - 1]])
        JjC = torch.cat([eye6[None], Jj[:B - 1]])
        wC = torch.cat([torch.zeros_like(w_blk[:1]), w_blk[:B - 1]])
        dead = (wC <= 0)[:, None, None]
        JiC = torch.where(dead, torch.zeros_like(JiC), JiC)
        JjC = torch.where(dead, eye6.expand_as(JjC), JjC)
        JjInv = _inv6(JjC)
        winv = 1.0 / (wC + damping)
        # Row 0 has no chain edge in this block but does carry its own
        # outgoing edge's Ji^T Ji: that block (plus damping) stands in
        # for its row of M, where damping alone (a 1e4 row scale) would
        # stall float32 PCG.
        D0inv = inv_spd6(w_blk[0] * (Ji[0].T @ Ji[0]) + damping * eye6)
        prep = dispatch.chain_prepare(JjInv, JiC, n_live)

        def precond(v, JjInv=JjInv, JiC=JiC, winv=winv, D0inv=D0inv,
                    prep=prep):
            x = _chain_sqrt_solve(JjInv, JiC, winv, v, n_live, prep)
            row0 = v[0] if s == 0 else D0inv @ v[0]
            return torch.cat([row0[None], x[1:]])

        def pdot(a, c):
            return mesh_mod.all_reduce(
                mesh, torch.sum((a * c).double()), axis).to(dt)

        x = torch.zeros((B, 6), dtype=dt, device=dev)
        rr = b
        p = precond(b)
        rz = pdot(b, p)
        for _ in range(cg_iters):
            Ap = matvec(p)
            alpha = rz / (pdot(p, Ap) + 1e-30)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = pdot(rr, z)
            p = z + (rz_new / (rz + 1e-30)) * p
            rz = rz_new
        delta = pin(x, torch.zeros(6, dtype=dt, device=dev))
        poses = poses @ se3.exp_se3(delta)

    # Final cost: odometry edges on their rank, loop edges on rank 0.
    (r, _, _), (rl, _, _) = residuals(poses)
    c = torch.sum((w_blk * torch.sum(r * r, dim=-1)).double())
    if s == 0:
        c = c + torch.sum((le_w * torch.sum(rl * rl, dim=-1)).double())
    return poses, mesh_mod.all_reduce(mesh, c, axis).to(dt)


def optimize_sharded(poses, z_odo, w_odo, le_i, le_j, le_z, le_w,
                     mesh: Mesh, axis: str = "lm", iters: int = 10,
                     cg_iters: int = 50, damping: float = 1e-4,
                     n_live: Optional[int] = None):
    """Pose-graph Gauss-Newton with the poses split into contiguous
    blocks over the ranks of `axis`; every rank passes the whole arrays.

    Args:
      poses: (F,4,4); F must divide by the axis's size.
      z_odo: (F,4,4) odometry measurements, z_odo[k] = T_k^-1 T_{k+1};
        slot F-1 is padding with w_odo[F-1] == 0.
      w_odo: (F,) edge weights (0 disables).
      le_*: fixed-capacity loop-closure edges (replicated).
      n_live: optional count of leading poses that edges touch (as in
        posegraph.optimize): each block's chain sweeps stop there.

    Returns (optimised poses (F,4,4) on every rank, final cost ())."""
    f = poses.shape[0]
    S = mesh.shape[axis]
    if f % S:
        raise ValueError(f"{f} poses do not split over {S} ranks")
    B = f // S
    dev = mesh.device
    eye = torch.eye(4, dtype=poses.dtype, device=dev)
    z_odo, w_odo, le_z, le_w = (x.to(dev) for x in (z_odo, w_odo, le_z,
                                                   le_w))
    # Disabled edges take the identity measurement: padding (often all
    # zeros, hence singular) must not make NaNs before the weight masks.
    z_odo = torch.where((w_odo > 0)[:, None, None], z_odo, eye)
    le_z = torch.where((le_w > 0)[:, None, None], le_z, eye)
    lo = mesh.index(axis) * B
    live = B if n_live is None else min(max(n_live - lo, 1), B)
    blk = slice(lo, lo + B)
    out, cost = _local_pgo(
        mesh, axis, poses[blk].to(dev), z_odo[blk], w_odo[blk],
        le_i.to(dev).long(), le_j.to(dev).long(), le_z, le_w, iters=iters,
        cg_iters=cg_iters, damping=damping, n_live=live)
    return mesh_mod.gather_blocks(mesh, out, axis), cost
