"""Pose-graph optimisation with loop-closure constraints (counterpart of
`slam1_tpu/models/posegraph.py`).

Gauss-Newton on SE(3) poses: every edge's residual is the SE(3) log of
its cycle error, its 6x6 Jacobians come from `torch.func.jacfwd` at the
identity perturbation (PGO runs per accepted loop, not per frame), and
the normal equations are solved matrix-free by CG whose matvec is
gather -> per-edge 6x6 products -> scatter-add (accumulated in float64,
so the result does not depend on the order of CUDA's atomic adds). CG
is preconditioned
with the exact inverse of the odometry chain in square-root form, two
sequential sweeps that run as one launch of `csrc/chain_sweep.cu` on
CUDA tensors (`dispatch.chain_sweep`), on 6x6 blocks that one more
launch fuses once per Gauss-Newton iteration (`dispatch.chain_prepare`).
Edge arrays are fixed capacity with weight masks.

`optimize` is a loop over `gn_step`, one Gauss-Newton iteration that
reads nothing back to the host (its `n_live` may be a 0-d int32 device
tensor), and `cost`. On CUDA tensors `optimize` replays them as
captured CUDA graphs, as the reference jits it: `pg_gn` (one `gn_step`,
replayed `iters` times) and `pg_cost`, kept in the graph registry of
`utils/graphs.py`.
`SlamSystem` captures `gn_step` in graphs of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam1_tpu_torch.ops import dispatch, se3
from slam1_tpu_torch.ops.cg import cg
from slam1_tpu_torch.ops.lsq import inv3x3
from slam1_tpu_torch.utils import graphs as graph_mod


class PoseGraph(NamedTuple):
    poses: torch.Tensor   # (F,4,4) T_world_frame
    ei: torch.Tensor      # (E,) int64 edge source
    ej: torch.Tensor      # (E,) int64 edge target
    z: torch.Tensor       # (E,4,4) measured T_i_j = inv(T_i) @ T_j
    w: torch.Tensor       # (E,) float32 edge weight (0 = disabled)


def odometry_edges(poses, rel_twists, mask):
    """Chain edges from per-frame relative twists (i -> i+1)."""
    f = poses.shape[0]
    ei = torch.arange(f - 1, device=poses.device)
    return ei, ei + 1, se3.exp_se3(rel_twists), mask.to(torch.float32)


def _edge_residual(delta_i, delta_j, T_i, T_j, Z):
    Ti = T_i @ se3.exp_se3(delta_i)
    Tj = T_j @ se3.exp_se3(delta_j)
    return se3.log_se3(se3.inverse(Z) @ (se3.inverse(Ti) @ Tj))


def _inv6(M):
    """Batched closed-form general 6x6 inverse via the 3x3 block Schur
    complement (assumes an invertible upper-left block, which holds for
    the chain-edge Jacobians, J = I + O(residual))."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv3x3(A)
    Si = inv3x3(D - C @ Ai @ B)
    AiB = Ai @ B
    CAi = C @ Ai
    top = torch.cat([Ai + AiB @ Si @ CAi, -AiB @ Si], dim=-1)
    bot = torch.cat([-Si @ CAi, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _chain_sqrt_solve(JjInv, Ji, winv, v, n_live=None, prep=None):
    """M^-1 v for the odometry-chain part M = A^T W A of the normal
    matrix, in factored form: A^-1 W^-1 A^-T v as a backward and a
    forward bidiagonal sweep around an elementwise scale (substitution
    growth is bounded by the chain adjoint, where a block-LDL^T of M
    overflows float32 on a 2000-pose chain). Row i in [1, F) holds chain
    edge (i-1, i); row 0 (gauge) is 0. Rows from `n_live` (an int or a
    0-d int32 tensor) on must carry no chain edge (default: all F rows
    are swept). `prep` is dispatch.chain_prepare's value for these
    JjInv, Ji and n_live."""
    f = v.shape[0]
    return dispatch.chain_sweep(JjInv, Ji, winv, v,
                                f if n_live is None else n_live, prep)


def _jacobians(T_i, T_j, Z):
    """Residuals (E,6) and the Jacobians (E,6,6) with respect to the
    perturbations of T_i and T_j, at zero perturbation."""
    zero = torch.zeros(T_i.shape[0], 1, 6, dtype=T_i.dtype,
                       device=T_i.device)
    r0 = _edge_residual(zero, zero, T_i[:, None], T_j[:, None],
                        Z[:, None])[:, 0]
    # Each edge keeps a unit batch axis inside the transforms: forward-mode
    # clamp of a 0-d value yields a float64 tangent in PyTorch.
    jac = torch.func.jacfwd(_edge_residual, argnums=(0, 1))
    Ji, Jj = torch.func.vmap(jac)(zero, zero, T_i[:, None], T_j[:, None],
                                  Z[:, None])
    return r0, Ji[:, 0, :, 0], Jj[:, 0, :, 0]


def _linearize(graph: PoseGraph, poses):
    """Residuals (E,6) and Jacobians (E,6,6) x 2 of every edge at
    `poses`, zero on disabled edges. Masked before any weighting: a w=0
    edge to an identity padding row can sit at the log map's
    singularity, where the residual and Jacobians are NaN and 0 * NaN
    would poison the solve."""
    ei, ej = graph.ei.long(), graph.ej.long()
    r0, Ji, Jj = _jacobians(poses[ei], poses[ej], graph.z)
    evalid = (graph.w > 0)[:, None]
    r0 = torch.where(evalid, r0, torch.zeros_like(r0))
    Ji = torch.where(evalid[..., None], Ji, torch.zeros_like(Ji))
    Jj = torch.where(evalid[..., None], Jj, torch.zeros_like(Jj))
    return r0, Ji, Jj


def _chain_blocks(graph: PoseGraph, Ji, Jj, damping: float):
    """The chain preconditioner's operands (JjInv (F,6,6), JiC (F,6,6),
    winv (F,)): chain edges in pose-indexed rows (row ej holds edge
    (ej-1, ej)); rows without one keep the identity edge (Ji = 0,
    Jj = I, w = 0 -> winv = 1/damping)."""
    f = graph.poses.shape[0]
    dt, dev = Ji.dtype, Ji.device
    ei, ej = graph.ei.long(), graph.ej.long()
    eye = torch.eye(6, dtype=dt, device=dev)
    is_chain = (ej == ei + 1) & (graph.w > 0)
    rows = torch.where(is_chain, ej, 0)
    gate = is_chain[:, None, None]
    zero66 = torch.zeros_like(Ji)
    JiC = torch.zeros((f, 6, 6), dtype=dt, device=dev).index_add_(
        0, rows, torch.where(gate, Ji, zero66))
    JjC = eye.repeat(f, 1, 1).index_add_(
        0, rows, torch.where(gate, Jj - eye, zero66))
    wC = torch.zeros(f, dtype=dt, device=dev).index_add_(
        0, rows, torch.where(is_chain, graph.w, torch.zeros_like(graph.w)))
    return _inv6(JjC), JiC, 1.0 / (wC + damping)


def chain_operands(graph: PoseGraph, damping: float = 1e-4):
    """(JjInv, JiC, winv) of the graph linearised at its own poses: what
    the first Gauss-Newton iteration of `optimize` hands to the chain
    preconditioner."""
    _, Ji, Jj = _linearize(graph, graph.poses)
    return _chain_blocks(graph, Ji, Jj, damping)


def gn_step(graph: PoseGraph, poses, cg_iters: int = 50,
            damping: float = 1e-4, chain_precond: bool = True, n_live=None):
    """One Gauss-Newton iteration of `optimize` from `poses` (F,4,4) ->
    the updated poses, pose 0 gauge-fixed. `n_live`: None, an int, or a
    0-d int32 tensor on the poses' device (see `optimize`)."""
    f = poses.shape[0]
    ei, ej = graph.ei.long(), graph.ej.long()
    dt, dev = poses.dtype, poses.device
    w = graph.w[:, None]
    live = f if n_live is None else n_live

    def scatter(vals_i, vals_j):
        # Summed in float64, whose sum of a pose's few float32 terms is
        # exact in any order: CUDA's atomic adds then give the same
        # float32 result on every run.
        out = torch.zeros((f, 6), dtype=torch.float64, device=dev)
        out.index_add_(0, ei, vals_i.double())
        out.index_add_(0, ej, vals_j.double())
        return out.to(dt)

    r0, Ji, Jj = _linearize(graph, poses)

    rw = r0 * w
    b = -scatter(torch.einsum("eab,ea->eb", Ji, rw),
                 torch.einsum("eab,ea->eb", Jj, rw))
    b[0].zero_()

    def matvec(x):
        y = (torch.einsum("eab,eb->ea", Ji, x[ei])
             + torch.einsum("eab,eb->ea", Jj, x[ej])) * w
        out = scatter(torch.einsum("eab,ea->eb", Ji, y),
                      torch.einsum("eab,ea->eb", Jj, y))
        out = out + damping * x
        out[0] = x[0]                      # gauge: pin pose 0
        return out

    precond = None
    if chain_precond:
        JjInv, JiC, winv = _chain_blocks(graph, Ji, Jj, damping)
        # Fixed for this iteration's ~cg_iters applications.
        prep = dispatch.chain_prepare(JjInv, JiC, live)

        def precond(v):
            x = _chain_sqrt_solve(JjInv, JiC, winv, v, live, prep)
            x[0] = v[0]
            return x

    delta = cg(matvec, b, iters=cg_iters, precond=precond)
    delta = torch.where(torch.isfinite(delta), delta,
                        torch.zeros_like(delta))
    delta[0].zero_()
    return poses @ se3.exp_se3(delta)


def cost(graph: PoseGraph, poses):
    """The weighted cost sum_e w_e |r_e|^2 of the graph at `poses`, ()."""
    ei, ej = graph.ei.long(), graph.ej.long()
    zero = torch.zeros((ei.shape[0], 6), dtype=poses.dtype,
                       device=poses.device)
    r = _edge_residual(zero, zero, poses[ei], poses[ej], graph.z)
    return torch.sum(graph.w * torch.sum(r * r, dim=-1))


def _graphed_gn(cg_iters: int, damping: float, chain_precond: bool,
                n_live):
    """gn_step as a graph's function: (poses, graph, *live) -> (the poses
    one iteration on, ()). `live` holds n_live where it is a device
    tensor; else n_live (None or an int) is built into the graph."""
    def step(poses, graph, *live):
        return gn_step(graph, poses, cg_iters, damping, chain_precond,
                       live[0] if live else n_live), ()
    return step


def _graphed_cost(poses, graph):
    """cost as a graph's function: (poses, graph) -> (poses, cost)."""
    return poses, cost(graph, poses)


def optimize(graph: PoseGraph, iters: int = 10, cg_iters: int = 50,
             damping: float = 1e-4, chain_precond: bool = True,
             n_live=None, graphs: bool = True):
    """Gauss-Newton pose-graph relaxation with pose 0 gauge-fixed:
    `iters` calls of `gn_step` from graph.poses.

    chain_precond preconditions each GN step's CG with the exact inverse
    of the odometry chain (see _chain_sqrt_solve), so CG converges in
    ~O(loop edges) iterations independent of trajectory length.
    n_live: optional count of leading poses that edges touch (an int or
    a 0-d int32 tensor); later poses only ride along (they are solved
    without the sweeps).
    Returns (optimised poses (F,4,4), final weighted cost ()).

    It runs through `utils/graphs.iterate`: `pg_gn` (one `gn_step`,
    `iters` times) then `pg_cost` (the final cost). On CUDA tensors each
    is a replay of a captured CUDA graph, as the reference runs one
    compiled program, kept in the graph registry under the kind
    "posegraph" by the device, the graph's shapes and dtypes and, for
    `pg_gn`, `cg_iters`, `damping`, `chain_precond` and how `n_live` is
    given (None, an int's value, or a device tensor, which is a graph
    input). On the CPU, and with `graphs=False`, the same functions run
    eagerly. With iters == 0 the poses returned are graph.poses.
    """
    f, e = graph.poses.shape[0], graph.ei.shape[0]
    on_device = isinstance(n_live, torch.Tensor)
    gn = graph_mod.Stage(
        "posegraph", (cg_iters, damping, chain_precond,
                      "tensor" if on_device else n_live),
        f"pg_gn[{f},{e}]", _graphed_gn(cg_iters, damping, chain_precond,
                                       n_live))
    end = graph_mod.Stage("posegraph", (), f"pg_cost[{f},{e}]",
                          _graphed_cost)
    poses, total = graph_mod.iterate(
        gn, end, graph.poses, iters, inputs=(graph, n_live) if on_device
        else (graph,), end_inputs=(graph,),
        graphed=graph_mod.graphed(graph.poses, wanted=graphs))
    return (poses if iters else graph.poses), total


def distribute_error_linear(poses, idx: int, i: int, T_corrected):
    """Reference-parity fallback: linearly smear the translation error of
    frame i over frames idx..i (frames after i take all of it)."""
    err = T_corrected[:3, 3] - poses[i, :3, 3]
    f = poses.shape[0]
    t = torch.arange(f, dtype=poses.dtype, device=poses.device)
    frac = torch.clamp((t - idx) / max(i - idx, 1), 0.0, 1.0)
    frac = torch.where(t > i, torch.ones_like(frac), frac)
    out = poses.clone()
    out[:, :3, 3] += frac[:, None] * err[None, :]
    return out
