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

`optimize_sharded` is a loop over `dist_gn_step`, one Gauss-Newton
iteration that reads nothing back to the host, and `dist_cost`; on a
card under NCCL it replays them as captured CUDA graphs, collectives
and chain kernels inside.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slam1_tpu_torch.models.posegraph import (_chain_sqrt_solve, _inv6,
                                              _jacobians)
from slam1_tpu_torch.ops import dispatch, se3
from slam1_tpu_torch.ops.lsq import inv_spd6
from slam1_tpu_torch.parallel import mesh as mesh_mod
from slam1_tpu_torch.parallel.mesh import Mesh
from slam1_tpu_torch.utils import graphs as graph_mod


def _masked_terms(T_i, T_j, Z, w):
    """Residuals (E,6) and Jacobians (E,6,6) x 2 of edges, zero where the
    weight is 0 (a disabled edge's terms can be NaN, and 0 * NaN would
    poison the solve)."""
    r, Ji, Jj = _jacobians(T_i, T_j, Z)
    ok = (w > 0)[:, None]
    return (torch.where(ok, r, torch.zeros_like(r)),
            torch.where(ok[..., None], Ji, torch.zeros_like(Ji)),
            torch.where(ok[..., None], Jj, torch.zeros_like(Jj)))


class _BlockEdges(NamedTuple):
    """The edges of this rank's block as a Gauss-Newton step reads them:
    its odometry edges z (B,4,4), w (B,) (edge k from block row k to
    k+1, the last into the right neighbour's block), the replicated loop
    edges le_z (E,4,4), le_w (E,), and where each loop edge's ends lie:
    own_i / own_j (E,) whether this rank holds the end, li_loc / lj_loc
    (E,) its row in the block (clamped), li_row / lj_row (E,) that row,
    or B (a dropped extra row) where another rank holds the end."""
    z: torch.Tensor
    w: torch.Tensor
    le_z: torch.Tensor
    le_w: torch.Tensor
    own_i: torch.Tensor
    own_j: torch.Tensor
    li_loc: torch.Tensor
    lj_loc: torch.Tensor
    li_row: torch.Tensor
    lj_row: torch.Tensor


def _block_edges(z_blk, w_blk, le_i, le_j, le_z, le_w, lo: int
                 ) -> _BlockEdges:
    """_BlockEdges of the block of B = len(w_blk) poses from global row
    `lo`."""
    B = w_blk.shape[0]
    own_i = (le_i >= lo) & (le_i < lo + B)
    own_j = (le_j >= lo) & (le_j < lo + B)
    li_loc = torch.clamp(le_i - lo, 0, B - 1)
    lj_loc = torch.clamp(le_j - lo, 0, B - 1)
    # Loop-edge rows this rank does not own go to a dropped extra row.
    li_row = torch.where(own_i, li_loc, torch.full_like(li_loc, B))
    lj_row = torch.where(own_j, lj_loc, torch.full_like(lj_loc, B))
    return _BlockEdges(z_blk, w_blk, le_z, le_w, own_i, own_j, li_loc,
                       lj_loc, li_row, lj_row)


def _gather_loop(mesh: Mesh, axis: str, e: _BlockEdges, x):
    """The replicated (E, ...) endpoint values of a block-sharded
    per-pose array: one all_reduce of both ends."""
    shp = (e.le_w.shape[0],) + (1,) * (x.dim() - 1)
    both = torch.stack([
        torch.where(e.own_i.reshape(shp), x[e.li_loc], torch.zeros_like(
            x[e.li_loc])),
        torch.where(e.own_j.reshape(shp), x[e.lj_loc], torch.zeros_like(
            x[e.lj_loc]))])
    both = mesh_mod.all_reduce(mesh, both, axis)
    return both[0], both[1]


def _halo_first(mesh: Mesh, axis: str, x):
    """The right neighbour's first row."""
    return mesh_mod.ring_shift(mesh, x[0], -1, axis)


def _pin(mesh: Mesh, axis: str, outv, val_row0):
    """Gauge: global pose 0 (rank 0, row 0)."""
    if mesh.index(axis) == 0:
        outv = torch.cat([val_row0[None], outv[1:]])
    return outv


def _residuals(mesh: Mesh, axis: str, e: _BlockEdges, poses):
    """The masked terms of the block's odometry edges and of the loop
    edges at `poses`."""
    T_j = torch.cat([poses[1:], _halo_first(mesh, axis, poses)[None]])
    Tle_i, Tle_j = _gather_loop(mesh, axis, e, poses)
    return (_masked_terms(poses, T_j, e.z, e.w),
            _masked_terms(Tle_i, Tle_j, e.le_z, e.le_w))


def dist_gn_step(mesh: Mesh, axis: str, poses_blk, edges: _BlockEdges, *,
                 cg_iters: int, damping: float, n_live: int):
    """One Gauss-Newton iteration on this rank's block poses_blk (B,4,4)
    -> the block's new poses: the PCG solve with the block's chain
    preconditioner, the halo, loop-edge gathers and dots over `axis`.
    `n_live`: rows of the block from which on no chain edge lives.
    Nothing is read back to the host."""
    B = poses_blk.shape[0]
    s = mesh.index(axis)
    dt, dev = poses_blk.dtype, poses_blk.device
    e = edges
    eye6 = torch.eye(6, dtype=dt, device=dev)
    w = e.w[:, None]
    wl = e.le_w[:, None]
    (r0, Ji, Jj), (rl, Jli, Jlj) = _residuals(mesh, axis, e, poses_blk)

    def scatter(y_odo, y_loop):
        """(B,6) per-pose sums of the odometry edges' (B,6) and the loop
        edges' (E,6) contributions, with the boundary halo."""
        out = torch.einsum("eab,ea->eb", Ji, y_odo)
        out = out + torch.cat([torch.zeros_like(out[:1]), torch.einsum(
            "eab,ea->eb", Jj[:-1], y_odo[:-1])])
        recv = mesh_mod.ring_shift(
            mesh, torch.einsum("ab,a->b", Jj[-1], y_odo[-1]), +1, axis)
        out = out + torch.cat([recv[None], torch.zeros_like(out[1:])])
        loop = torch.zeros((B + 1, 6), dtype=torch.float64, device=dev)
        loop.index_add_(0, e.li_row, torch.einsum(
            "eab,ea->eb", Jli, y_loop).double())
        loop.index_add_(0, e.lj_row, torch.einsum(
            "eab,ea->eb", Jlj, y_loop).double())
        return out + loop[:B].to(dt)

    b = _pin(mesh, axis, -scatter(r0 * w, rl * wl),
             torch.zeros(6, dtype=dt, device=dev))

    def matvec(x):
        xj = torch.cat([x[1:], _halo_first(mesh, axis, x)[None]])
        y = (torch.einsum("eab,eb->ea", Ji, x)
             + torch.einsum("eab,eb->ea", Jj, xj)) * w
        xle_i, xle_j = _gather_loop(mesh, axis, e, x)
        yl = (torch.einsum("eab,eb->ea", Jli, xle_i)
              + torch.einsum("eab,eb->ea", Jlj, xle_j)) * wl
        return _pin(mesh, axis, scatter(y, yl) + damping * x, x[0])

    # Per-block chain preconditioner: the exact square-root chain solve
    # over the block's own odometry edges (row k holds edge k-1 -> k; row
    # 0's edge belongs to the left neighbour).
    JiC = torch.cat([torch.zeros_like(Ji[:1]), Ji[:B - 1]])
    JjC = torch.cat([eye6[None], Jj[:B - 1]])
    wC = torch.cat([torch.zeros_like(e.w[:1]), e.w[:B - 1]])
    dead = (wC <= 0)[:, None, None]
    JiC = torch.where(dead, torch.zeros_like(JiC), JiC)
    JjC = torch.where(dead, eye6.expand_as(JjC), JjC)
    JjInv = _inv6(JjC)
    winv = 1.0 / (wC + damping)
    # Row 0 has no chain edge in this block but does carry its own
    # outgoing edge's Ji^T Ji: that block (plus damping) stands in for
    # its row of M, where damping alone (a 1e4 row scale) would stall
    # float32 PCG.
    D0inv = inv_spd6(e.w[0] * (Ji[0].T @ Ji[0]) + damping * eye6)
    prep = dispatch.chain_prepare(JjInv, JiC, n_live)

    def precond(v):
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
    delta = _pin(mesh, axis, x, torch.zeros(6, dtype=dt, device=dev))
    return poses_blk @ se3.exp_se3(delta)


def dist_cost(mesh: Mesh, axis: str, poses_blk, edges: _BlockEdges):
    """The global cost () at the blocks' poses: odometry edges on their
    rank, loop edges on rank 0, one all_reduce."""
    (r, _, _), (rl, _, _) = _residuals(mesh, axis, edges, poses_blk)
    c = torch.sum((edges.w * torch.sum(r * r, dim=-1)).double())
    if mesh.index(axis) == 0:
        c = c + torch.sum((edges.le_w * torch.sum(rl * rl, dim=-1)).double())
    return mesh_mod.all_reduce(mesh, c, axis).to(poses_blk.dtype)


class _PGOCarry(NamedTuple):
    """The state of the `dpg_gn` and `dpg_cost` graphs: the block's
    poses and the edges they read."""
    poses: torch.Tensor
    edges: _BlockEdges


def _graphed_gn(mesh: Mesh, axis: str, cg_iters: int, damping: float,
                n_live: int):
    """dist_gn_step as a graph's function: (_PGOCarry) -> (the carry one
    iteration on, ())."""
    def step(carry):
        return carry._replace(poses=dist_gn_step(
            mesh, axis, carry.poses, carry.edges, cg_iters=cg_iters,
            damping=damping, n_live=n_live)), ()
    return step


def _graphed_cost(mesh: Mesh, axis: str):
    """The end of optimize_sharded as a graph's function: (_PGOCarry) ->
    (the same carry, (every block's poses, the global cost))."""
    def step(carry):
        cost = dist_cost(mesh, axis, carry.poses, carry.edges)
        return carry, (mesh_mod.gather_blocks(mesh, carry.poses, axis),
                       cost)
    return step


def optimize_sharded(poses, z_odo, w_odo, le_i, le_j, le_z, le_w,
                     mesh: Mesh, axis: str = "lm", iters: int = 10,
                     cg_iters: int = 50, damping: float = 1e-4,
                     n_live: Optional[int] = None, graphs: bool = True):
    """Pose-graph Gauss-Newton with the poses split into contiguous
    blocks over the ranks of `axis`; every rank passes the whole arrays:
    `iters` calls of `dist_gn_step` on the rank's block, then
    `dist_cost`.

    Args:
      poses: (F,4,4); F must divide by the axis's size.
      z_odo: (F,4,4) odometry measurements, z_odo[k] = T_k^-1 T_{k+1};
        slot F-1 is padding with w_odo[F-1] == 0.
      w_odo: (F,) edge weights (0 disables).
      le_*: fixed-capacity loop-closure edges (replicated).
      n_live: optional count of leading poses that edges touch (as in
        posegraph.optimize): each block's chain sweeps stop there.

    It runs through `utils/graphs.iterate`: `dpg_gn` (one
    `dist_gn_step`, `iters` times) then `dpg_cost` (the final cost and
    the gather of the blocks) on a _PGOCarry. On a card under NCCL
    (`utils/graphs.graphed`) each is a replay of a captured CUDA graph
    with the collectives inside, kept in the graph registry under the
    kind "dist_pgo" by the device, the axis's group, its size and this
    rank's index in it, the block's shapes and dtypes and, for `dpg_gn`,
    `cg_iters`, `damping` and this rank's live rows. On the CPU, under
    gloo, and with `graphs=False`, the same functions run eagerly.

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
    poses_blk = poses[blk].to(dev)
    edges = _block_edges(z_odo[blk], w_odo[blk], le_i.to(dev).long(),
                         le_j.to(dev).long(), le_z, le_w, lo)
    size = f"[{B},{edges.le_w.shape[0]}]"
    static = (mesh.group(axis), S, mesh.index(axis))
    return graph_mod.iterate(
        graph_mod.Stage("dist_pgo", (*static, cg_iters, damping, live),
                        "dpg_gn" + size,
                        _graphed_gn(mesh, axis, cg_iters, damping, live)),
        graph_mod.Stage("dist_pgo", static, "dpg_cost" + size,
                        _graphed_cost(mesh, axis)),
        _PGOCarry(poses_blk, edges), iters, keep=lambda c, out: out,
        graphed=graph_mod.graphed(poses_blk, mesh, wanted=graphs),
        counters=mesh.comm)
