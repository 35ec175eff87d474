"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt
(counterpart of `slam1_tpu/models/ba.py`).

  - reprojection residuals of stereo observations [u_left, v_left,
    right-u] with per-observation camera (3x6) and landmark (3x3)
    Jacobians, written out by hand (the reference takes `jax.jacfwd` of
    `_obs_residual`; `vmap(jacfwd)` costs hundreds of small launches per
    linearisation on a GPU);
  - Hessian blocks by scatter-add: Hcc (C,6,6), Hll (L,3,3), coupling W
    (O,6,3) per observation;
  - per-landmark elimination with batched closed-form 3x3 inverses;
  - the reduced camera system solved densely for a local window
    (C <= 16, `_schur_solve_direct`) and matrix-free with block-Jacobi
    preconditioned CG otherwise (`_schur_solve`), whose product with
    the system is two hand-written kernels on the card
    (`csrc/ba_schur.cu`: a landmark half and a camera half, through
    `ops/dispatch.py`) and their plain twins on the CPU;
  - outer Levenberg-Marquardt with accept/reject damping, Huber IRLS
    weights and a graduated outlier cut, fixed iteration counts, no
    value read back to the host: `lm_step` is one iteration (the
    reference's scan body, the iteration a device scalar) and
    `bundle_adjust` a loop over it. On the card `bundle_adjust` replays
    `lm_step` as a captured CUDA graph, as the reference jits it:
    `ba_lm` (one iteration, `_graphed_ba_lm`, replayed `lm_iters` times)
    and `ba_cost` (the final cost), cached in `BA_GRAPHS`;
    `global_ba_step` (`models/pipeline.py`) replays the same `ba_lm`
    function between graphs of its own.

Every scatter-add accumulates in float64 and rounds once to the working
dtype (`ops/segment.seg_sum`): CUDA's `index_add_` adds in the order
its atomics land, and a float32 sum that depends on that order flips
strict LM accept decisions between two runs of the same clip. The
reduced-system kernels sum in float64 too, in a fixed order.

Camera 0 is gauge-fixed. Intrinsics are fixed (`models/bal.py` is the
variant with 9-parameter cameras).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import posegraph
from slam1_tpu_torch.ops import cuda_kernels, dispatch, se3
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.cg import cg
from slam1_tpu_torch.ops.lsq import huber_weights, inv3x3, inv_spd6
from slam1_tpu_torch.ops.segment import seg_sum
from slam1_tpu_torch.utils.graphs import StepGraph, copy_out
from slam1_tpu_torch.utils.metrics import traced
from slam1_tpu_torch.utils.tree import flatten

DIRECT_MAX_CAMS = 16       # dense reduced system up to this many cameras
Z_MIN = 1e-3               # depth clamp of the projection


class BAProblem(NamedTuple):
    poses: torch.Tensor    # (C,4,4) T_world_cam
    points: torch.Tensor   # (L,3) world landmarks
    cam_idx: torch.Tensor  # (O,) integer camera row of each observation
    lm_idx: torch.Tensor   # (O,) integer landmark row
    uv: torch.Tensor       # (O,2) observed pixels (left camera)
    w: torch.Tensor        # (O,) observation weight; 0 = padding
    ur: torch.Tensor       # (O,) observed right-camera u (stereo)
    wr: torch.Tensor       # (O,) stereo weight; 0 = monocular
    # Pose-prior edges (odometry chain + verified loop closures) with
    # residual log(Z^-1 Ti^-1 Tj) between camera rows: they carry the
    # pose graph into the BA objective, which otherwise pins camera 0
    # only. Empty (E = 0) arrays disable them.
    pe_i: torch.Tensor     # (E,) integer camera row i
    pe_j: torch.Tensor     # (E,) integer camera row j
    pe_z: torch.Tensor     # (E,4,4) measured T_i_j
    pe_w: torch.Tensor     # (E,) weight; 0 = padding


def make_problem(poses, points, cam_idx, lm_idx, uv, w, ur=None, wr=None,
                 pe_i=None, pe_j=None, pe_z=None, pe_w=None) -> BAProblem:
    """BAProblem constructor; omitted ur/wr default to monocular,
    omitted pe_* to no pose priors."""
    o = uv.shape[0]
    dt, dev = uv.dtype, uv.device
    if ur is None:
        ur = torch.zeros(o, dtype=dt, device=dev)
    if wr is None:
        wr = torch.zeros(o, dtype=dt, device=dev)
    if pe_i is None:
        pe_i = torch.zeros(0, dtype=torch.int64, device=dev)
        pe_j = torch.zeros(0, dtype=torch.int64, device=dev)
        pe_z = torch.zeros((0, 4, 4), dtype=dt, device=dev)
        pe_w = torch.zeros(0, dtype=dt, device=dev)
    return BAProblem(poses=poses, points=points, cam_idx=cam_idx,
                     lm_idx=lm_idx, uv=uv, w=w, ur=ur, wr=wr,
                     pe_i=pe_i, pe_j=pe_j, pe_z=pe_z, pe_w=pe_w)


def _project(Xc, uv, ur, wr, cam: StereoCamera):
    """Residuals (O,3) of camera-frame points Xc (O,3), the clamped
    depth z (O,) and the unclamped-depth mask (O,)."""
    free = Xc[:, 2] > Z_MIN
    z = torch.clamp(Xc[:, 2], min=Z_MIN)
    u = cam.fx * Xc[:, 0] / z + cam.cx
    v = cam.fy * Xc[:, 1] / z + cam.cy
    u_r = cam.fx * (Xc[:, 0] - cam.baseline) / z + cam.cx
    r = torch.stack([u - uv[:, 0], v - uv[:, 1], wr * (u_r - ur)], dim=-1)
    return r, z, free


def _obs_residual(T, X, uv, ur, wr, cam: StereoCamera):
    """Residuals (O,3) of stereo observations at camera poses T (O,4,4)
    and world points X (O,3): [u_left, v_left, right-u] errors. The third
    component is gated by the stereo weight `wr` (0 = monocular); stereo
    observations anchor the metric scale."""
    Xc = ((X - T[:, :3, 3])[:, None, :] @ T[:, :3, :3])[:, 0]   # R^T (X - t)
    return _project(Xc, uv, ur, wr, cam)[0]


def _obs_terms(T, X, uv, ur, wr, cam: StereoCamera):
    """Residuals (O,3) and their Jacobians at zero perturbation with
    respect to the camera twist dc (O,3,6), T <- T exp(dc), and to the
    landmark dl (O,3,3), X <- X + dl.

    With Xc = R^T (X - t): dXc/ddc = [-I | hat(Xc)] in the twist order
    [rho, phi] of `se3.exp_se3`, dXc/ddl = R^T. Below the depth clamp the
    depth's derivative is 0 (forward mode through a maximum)."""
    R = T[:, :3, :3]
    Xc = ((X - T[:, :3, 3])[:, None, :] @ R)[:, 0]
    r, z, free = _project(Xc, uv, ur, wr, cam)
    dz = free.to(Xc.dtype)
    zero = torch.zeros_like(z)
    fxz, fyz = cam.fx / z, cam.fy / z
    iz2 = dz / (z * z)
    # d[u, v, wr * u_r] / dXc
    Jp = torch.stack([
        torch.stack([fxz, zero, -cam.fx * Xc[:, 0] * iz2], dim=-1),
        torch.stack([zero, fyz, -cam.fy * Xc[:, 1] * iz2], dim=-1),
        torch.stack([wr * fxz, zero,
                     -wr * cam.fx * (Xc[:, 0] - cam.baseline) * iz2],
                    dim=-1)], dim=-2)                            # (O,3,3)
    Jc = torch.cat([-Jp, Jp @ se3.hat(Xc)], dim=-1)              # (O,3,6)
    Jl = Jp @ R.transpose(-1, -2)                                # (O,3,3)
    return r, Jc, Jl


def _prior_terms(problem: BAProblem, poses):
    """Residuals (E,6) and Jacobians (E,6,6) x 2 of the pose-prior edges
    at `poses`, masked on the weight before any weighting: a padding row
    can sit at the log map's singularity."""
    r, Ji, Jj = posegraph._jacobians(poses[problem.pe_i.long()],
                                     poses[problem.pe_j.long()],
                                     problem.pe_z)
    ok = (problem.pe_w > 0)[:, None]
    r = torch.where(ok, r, torch.zeros_like(r))
    Ji = torch.where(ok[..., None], Ji, torch.zeros_like(Ji))
    Jj = torch.where(ok[..., None], Jj, torch.zeros_like(Jj))
    return r, Ji, Jj, problem.pe_w


def _prior_cost(problem: BAProblem, poses):
    """() quadratic cost of the pose-prior edges at `poses`."""
    if problem.pe_i.shape[0] == 0:
        return torch.zeros((), dtype=problem.uv.dtype,
                           device=problem.uv.device)
    T_i = poses[problem.pe_i.long()]
    T_j = poses[problem.pe_j.long()]
    r = se3.log_se3(se3.inverse(problem.pe_z) @ (se3.inverse(T_i) @ T_j))
    r = torch.where((problem.pe_w > 0)[:, None], r, torch.zeros_like(r))
    return torch.sum(problem.pe_w * torch.sum(r * r, dim=-1))


def _linearize(problem: BAProblem, cam: StereoCamera, w_irls):
    """Residuals + per-observation Jacobian blocks at the estimate."""
    T = problem.poses[problem.cam_idx.long()]
    X = problem.points[problem.lm_idx.long()]
    r, Jc, Jl = _obs_terms(T, X, problem.uv, problem.ur, problem.wr, cam)
    return r, Jc, Jl, w_irls


def _diag_only(blocks):
    n = blocks.shape[-1]
    return blocks * torch.eye(n, dtype=blocks.dtype, device=blocks.device)


def _normal_blocks(problem, r, Jc, Jl, w):
    """The blocks both solvers share: Hcc (C,6,6), Hll (L,3,3), W
    (O,6,3), bc (C,6), bl (L,3), with the pose priors' gradient and
    diagonal curvature folded into bc and Hcc (LM damping and the
    block-Jacobi preconditioner must see the dominant curvature), and
    the prior terms (None without priors) for the cross blocks."""
    C = problem.poses.shape[0]
    L = problem.points.shape[0]
    ci, li = problem.cam_idx.long(), problem.lm_idx.long()
    w2 = w[:, None, None]
    rw = r * w[:, None]
    Hcc = seg_sum(C, ci, torch.einsum("oai,oaj->oij", Jc, Jc) * w2)
    Hll = seg_sum(L, li, torch.einsum("oai,oaj->oij", Jl, Jl) * w2)
    W = torch.einsum("oai,oaj->oij", Jc, Jl) * w2                # (O,6,3)
    bc = -seg_sum(C, ci, torch.einsum("oai,oa->oi", Jc, rw))
    bl = -seg_sum(L, li, torch.einsum("oai,oa->oi", Jl, rw))
    prior = None
    if problem.pe_i.shape[0] > 0:
        rp, Jpi, Jpj, wp = _prior_terms(problem, problem.poses)
        pi, pj = problem.pe_i.long(), problem.pe_j.long()
        pij = torch.cat([pi, pj])
        rpw = rp * wp[:, None]
        wp3 = wp[:, None, None]
        bc = bc - seg_sum(C, pij, torch.cat([
            torch.einsum("eab,ea->eb", Jpi, rpw),
            torch.einsum("eab,ea->eb", Jpj, rpw)]))
        Hcc = Hcc + seg_sum(C, pij, torch.cat([
            torch.einsum("eai,eaj->eij", Jpi, Jpi) * wp3,
            torch.einsum("eai,eaj->eij", Jpj, Jpj) * wp3]))
        prior = (pi, pj, Jpi, Jpj, wp)
    return Hcc, Hll, W, bc, bl, prior


def _damped(H, lam):
    n = H.shape[-1]
    return H + lam * _diag_only(H) + 1e-6 * torch.eye(
        n, dtype=H.dtype, device=H.device)


def _reduced_system(problem, r, Jc, Jl, w, lam):
    """The damped reduced camera system after landmark elimination,
    matrix-free: (matvec, btil (C,6), Minv (C,6,6), back), where
    matvec(x) is the landmark half then the camera half of the product
    (`dispatch.ba_schur_landmarks`, `ba_schur_cameras`: gather -> block
    products -> segment sums over the observations; nothing bigger than
    (C,6,6) is materialised), Minv the block-Jacobi preconditioner and
    back(dc) the landmark step (L,3) that goes with a camera step.
    Camera 0's block is the identity. The observations' ordering is made
    once here for every product (`dispatch.schur_order`; the kernels'
    leaves out the observations whose W block is zero)."""
    C = problem.poses.shape[0]
    L = problem.points.shape[0]
    Hcc, Hll, W, bc, bl, prior = _normal_blocks(problem, r, Jc, Jl, w)
    Hcc_d = _damped(Hcc, lam)
    Hll_inv = inv3x3(_damped(Hll, lam))                          # (L,3,3)
    order = dispatch.schur_order(problem.cam_idx, problem.lm_idx, C, L, W)

    btil = dispatch.ba_schur_cameras(
        W, dispatch.ba_schur_landmarks(W, Hll_inv, order, a=bl), order,
        b=bc)                                                    # gauge 0

    def matvec(x):
        v = dispatch.ba_schur_landmarks(W, Hll_inv, order, x=x)
        out = dispatch.ba_schur_cameras(W, v, order, hcc=Hcc_d, x=x)
        if prior is not None:
            # Cross blocks only: the diagonal blocks are inside Hcc_d.
            pi, pj, Jpi, Jpj, wp = prior
            wp2 = wp[:, None]
            out = out + seg_sum(C, torch.cat([pi, pj]), torch.cat([
                torch.einsum("eab,ea->eb", Jpi, wp2 * torch.einsum(
                    "eab,eb->ea", Jpj, x[pj])),
                torch.einsum("eab,ea->eb", Jpj, wp2 * torch.einsum(
                    "eab,eb->ea", Jpi, x[pi]))]))
            out[0] = x[0]                                        # gauge
        return out

    def back(dc):
        return dispatch.ba_schur_landmarks(W, Hll_inv, order, x=dc, a=bl)

    return matvec, btil, inv_spd6(Hcc_d), back


def _schur_solve(problem, r, Jc, Jl, w, lam, cg_iters: int):
    """One damped GN step via landmark elimination + PCG on the reduced
    camera system. Returns (delta_c (C,6), delta_l (L,3))."""
    matvec, btil, Minv, back = _reduced_system(problem, r, Jc, Jl, w, lam)
    dc = cg(matvec, btil, iters=cg_iters,
            precond=lambda v: torch.einsum("cij,cj->ci", Minv, v))
    dc[0].zero_()
    return dc, back(dc)


def _schur_solve_direct(problem, r, Jc, Jl, w, lam):
    """One damped GN step via landmark elimination + a dense solve of
    the (6C x 6C) reduced camera system: for a local window exact and
    far cheaper than CG sweeps over the observation arrays. The
    per-landmark coupling tensor U is (L,C,6,3)."""
    C = problem.poses.shape[0]
    L = problem.points.shape[0]
    ci, li = problem.cam_idx.long(), problem.lm_idx.long()
    dt, dev = r.dtype, r.device
    Hcc, Hll, W, bc, bl, prior = _normal_blocks(problem, r, Jc, Jl, w)
    Hcc_d = _damped(Hcc, lam)
    Hll_inv = inv3x3(_damped(Hll, lam))                          # (L,3,3)

    # U[l, c] = sum over the observations of l by c of W.
    U = seg_sum(L * C, li * C + ci, W).reshape(L, C, 6, 3)
    UH = torch.einsum("lcij,ljk->lcik", U, Hll_inv)              # (L,C,6,3)
    S = -torch.einsum("lcik,ldjk->cidj", UH, U)                  # (C,6,C,6)
    idx = torch.arange(C, device=dev)
    S[idx, :, idx, :] += Hcc_d
    btil = bc - torch.einsum("lcik,lk->ci", UH, bl)              # (C,6)

    if prior is not None:
        # Cross blocks only: diagonal blocks already damped in Hcc_d.
        pi, pj, Jpi, Jpj, wp = prior
        wp3 = wp[:, None, None]
        cross = seg_sum(C * C, torch.cat([pi * C + pj, pj * C + pi]),
                        torch.cat([
                            torch.einsum("eai,eaj->eij", Jpi, Jpj * wp3),
                            torch.einsum("eai,eaj->eij", Jpj, Jpi * wp3)]))
        S = S + cross.reshape(C, C, 6, 6).permute(0, 2, 1, 3)

    # Gauge: camera 0's block acts as the identity, as the CG path's.
    S[0].zero_()
    S[:, :, 0].zero_()
    S[0, :, 0, :] = torch.eye(6, dtype=dt, device=dev)
    btil[0].zero_()

    # solve_ex: no error check, so no read-back; a singular system gives
    # non-finite values that the caller zeroes.
    dc = torch.linalg.solve_ex(S.reshape(C * 6, C * 6),
                               btil.reshape(C * 6, 1))[0].reshape(C, 6)
    dc[0].zero_()
    # The landmark step: the landmark half's plain twin, on every device
    # (a local window's graph launches none of the CG path's kernels).
    return dc, cuda_kernels.ba_schur_landmarks_plain(
        W, Hll_inv, cuda_kernels.SchurOrder(ci, li), x=dc, a=bl)


def _cost(problem: BAProblem, cam: StereoCamera, huber_delta: float):
    """(Huber cost (), residuals (O,3), Huber weights (O,))."""
    T = problem.poses[problem.cam_idx.long()]
    X = problem.points[problem.lm_idx.long()]
    r = _obs_residual(T, X, problem.uv, problem.ur, problem.wr, cam)
    r2 = torch.sum(r * r, dim=-1)
    hw = huber_weights(r2, huber_delta)
    return torch.sum(problem.w * hw * r2), r, hw


class BATrace(NamedTuple):
    """Per-LM-iteration convergence diagnostics (BAConfig.lm_iters long).

    `cost` is the accepted full Huber cost after each iteration (flat
    segments = rejected steps); `n_obs` the observations surviving both
    the IRLS weight and the graduated outlier cut; `lam` the damping,
    `accept` the decision and `dc_norm` the largest camera-step norm
    (before acceptance) of the iteration."""
    cost: torch.Tensor     # (lm_iters,)
    n_obs: torch.Tensor    # (lm_iters,) int32
    lam: torch.Tensor      # (lm_iters,)
    accept: torch.Tensor   # (lm_iters,) bool
    dc_norm: torch.Tensor  # (lm_iters,)


def _trunc_cost(problem: BAProblem, hw, r2, cap):
    """The truncated robust cost sum_i w_i min(huber(r_i), cap); no cap
    (None) leaves it the full Huber cost."""
    contrib = hw * r2                          # huber(r): r2 or delta * r
    if cap is not None:
        contrib = torch.minimum(contrib, cap)
    return torch.sum(problem.w * contrib)


def graduated_cut(outlier_px: float, t, dtype):
    """The outlier cut of LM iteration `t` (a 0-d integer tensor), made
    on its device: outlier_px * max(1, 8 * 0.5 ** t), 8x loose at first
    and tightened to outlier_px. The power of two is an integer shift,
    exact on every device, so the value is the one the host computes."""
    return outlier_px * (1 << torch.clamp(3 - t, min=0)).to(dtype)


def lm_step(problem: BAProblem, cam: StereoCamera, cfg: BAConfig, poses,
            points, lam, t, trace: bool = True):
    """One Levenberg-Marquardt iteration, the reference's scan body:
    ((poses, points, lam), trace row). `t` is the iteration, a 0-d
    integer tensor on the device, from which the graduated cut is made
    there. The row is (accepted full cost, surviving observations, the
    damping used, accept, the largest camera-step norm), 0-d tensors;
    None with `trace=False`. Nothing is read back to the host."""
    dt = problem.uv.dtype
    p = problem._replace(poses=poses, points=points)
    full_cur, r, hw = _cost(p, cam, cfg.huber_delta)
    w = problem.w * hw
    r2 = torch.sum(r * r, dim=-1)
    cap = None
    if cfg.outlier_px:
        # Graduated rejection: the cut starts 8x loose and tightens to
        # outlier_px. The step zero-weights observations beyond the cut;
        # the objective saturates them at the cap.
        cut = graduated_cut(cfg.outlier_px, t, dt)
        cut2 = cut * cut
        w = w * (r2 < cut2).to(dt)
        cap = huber_weights(cut2, cfg.huber_delta) * cut2
    pc_cur = _prior_cost(problem, poses)
    cost_cur = _trunc_cost(problem, hw, r2, cap) + pc_cur
    full_cur = full_cur + pc_cur
    r_, Jc, Jl, w_ = _linearize(p, cam, w)
    if problem.poses.shape[0] <= DIRECT_MAX_CAMS:
        dc, dl = _schur_solve_direct(p, r_, Jc, Jl, w_, lam)
    else:
        dc, dl = _schur_solve(p, r_, Jc, Jl, w_, lam, cfg.cg_iters)
    dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
    dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
    new_poses = poses @ se3.exp_se3(dc)
    new_points = points + dl
    full_new, r_new, hw_new = _cost(
        problem._replace(poses=new_poses, points=new_points), cam,
        cfg.huber_delta)
    r2_new = torch.sum(r_new * r_new, dim=-1)
    pc_new = _prior_cost(problem, new_poses)
    cost_new = _trunc_cost(problem, hw_new, r2_new, cap) + pc_new
    full_new = full_new + pc_new
    accept = cost_new < cost_cur
    poses = torch.where(accept, new_poses, poses)
    points = torch.where(accept, new_points, points)
    lam = torch.clamp(torch.where(accept, lam / cfg.lm_lambda_down,
                                  lam * cfg.lm_lambda_up), 1e-9, 1e6)
    row = None
    if trace:
        # The reference rebuilds the damping it used from the clipped
        # value; kept as it is.
        lam_used = torch.where(accept, lam * cfg.lm_lambda_down,
                               lam / cfg.lm_lambda_up)
        row = (torch.where(accept, full_new, full_cur),
               torch.sum(w > 0).to(torch.int32), lam_used, accept,
               torch.max(torch.linalg.norm(dc, dim=-1)))
    return (poses, points, lam), row


def final_cost(problem: BAProblem, cam: StereoCamera, cfg: BAConfig, poses,
               points):
    """() full Huber cost plus the pose priors' at (poses, points)."""
    out = problem._replace(poses=poses, points=points)
    return _cost(out, cam, cfg.huber_delta)[0] + _prior_cost(problem, poses)


class _LMCarry(NamedTuple):
    """The state of the `ba_lm` graph: the problem and camera it reads,
    the (poses, points, lam) carry, the iteration `t` (a 0-d int64
    tensor) and the trace rows written so far (a BATrace of (lm_iters,)
    tensors, or () without the trace)."""
    problem: BAProblem
    cam: StereoCamera
    poses: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor
    t: torch.Tensor
    trace: tuple


def _lm_carry(prob: BAProblem, cam: StereoCamera, cfg: BAConfig,
              return_trace: bool) -> _LMCarry:
    """The carry of LM iteration 0: the problem's poses and points,
    lam = lm_lambda0, t = 0 and, with the trace, zeroed rows."""
    dt, dev = prob.uv.dtype, prob.uv.device
    trace = ()
    if return_trace:
        n = cfg.lm_iters
        trace = BATrace(*[torch.zeros(n, dtype=d, device=dev) for d in (
            dt, torch.int32, dt, torch.bool, dt)])
    return _LMCarry(prob, cam, prob.poses, prob.points,
                    torch.full((), cfg.lm_lambda0, dtype=dt, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev), trace)


def _graphed_ba_lm(cfg: BAConfig):
    """One `lm_step` as a graph's function: (_LMCarry) -> (the carry one
    iteration on, with `t` advanced and the iteration's trace row
    written at `t`, ())."""
    def step(carry):
        (poses, points, lam), row = lm_step(
            carry.problem, carry.cam, cfg, carry.poses, carry.points,
            carry.lam, carry.t, trace=bool(carry.trace))
        trace = carry.trace
        if row is not None:
            at = carry.t.reshape(1)
            trace = BATrace(*[buf.index_copy(0, at, x.reshape(1))
                              for buf, x in zip(trace, row)])
        return carry._replace(poses=poses, points=points, lam=lam,
                              t=carry.t + 1, trace=trace), ()
    return step


def _graphed_ba_cost(cfg: BAConfig):
    """`final_cost` as a graph's function: (_LMCarry) -> (the same
    carry, the cost ())."""
    def step(carry):
        return carry, final_cost(carry.problem, carry.cam, cfg, carry.poses,
                                 carry.points)
    return step


# The standalone bundle_adjust graphs by their static arguments, as
# jax.jit caches its programs: key -> {"ba_lm": ..., "ba_cost": ...}.
BA_GRAPHS: dict = {}


def _bundle_adjust_graphed(problem: BAProblem, cam: StereoCamera,
                           cfg: BAConfig, return_trace: bool):
    """bundle_adjust as `cfg.lm_iters` replays of `ba_lm` and one of
    `ba_cost`, each captured at its first call for its key; nothing is
    read back to the host between them. -> (poses, points, cost, trace),
    copied out of the graphs' pools."""
    shapes = tuple((tuple(x.shape), x.dtype) for x in flatten((problem, cam)))
    key = (problem.uv.device, cfg, return_trace,
           problem.poses.shape[0] <= DIRECT_MAX_CAMS, shapes)
    graphs = BA_GRAPHS.get(key)
    if graphs is None:
        size = (f"[{problem.poses.shape[0]},{problem.points.shape[0]},"
                f"{problem.uv.shape[0]}]")
        graphs = BA_GRAPHS[key] = {
            "ba_lm": StepGraph(_graphed_ba_lm(cfg), f"ba_lm{size}", key=key),
            "ba_cost": StepGraph(_graphed_ba_cost(cfg), f"ba_cost{size}",
                                 key=key)}
    carry = _lm_carry(problem, cam, cfg, return_trace)
    for _ in range(cfg.lm_iters):
        carry, _ = graphs["ba_lm"](carry)
    carry, cost = graphs["ba_cost"](carry)
    return copy_out((carry.poses, carry.points, cost, carry.trace))


@traced("host:ba.pass")
def bundle_adjust(problem: BAProblem, cam: StereoCamera, cfg: BAConfig,
                  return_trace: bool = False, graphs: bool = True):
    """Full LM bundle adjustment: `cfg.lm_iters` calls of `lm_step`.
    Camera 0 is gauge-fixed.

    Returns (optimised problem, final cost ()), plus a BATrace when
    `return_trace`. Nothing is read back to the host: decisions are
    device booleans applied with `where`.

    LM acceptance is judged on the objective the step was computed for,
    the truncated robust cost at the iteration's graduated cut, sum_i
    w_i min(huber(r_i), huber(cut)): excluded observations contribute
    the constant cap. The reported cost and trace stay the full Huber
    cost, comparable across iterations and runs.

    On CUDA tensors it replays two CUDA graphs, as the reference runs one
    compiled program: `ba_lm` (one `lm_step`, `cfg.lm_iters` times) and
    `ba_cost` (the final cost), kept in BA_GRAPHS by the device, `cfg`,
    `return_trace`, the dense-or-CG path and the problem's and camera's
    shapes and dtypes, and captured at the first call with a new key;
    their memory pools stay reserved until the graphs are dropped
    (`BA_GRAPHS.clear()`). The camera is a graph input. On the CPU, and
    with `graphs=False`, the same operations run eagerly (a caller that
    is itself being captured passes `graphs=False`). Each call is the
    span `host:ba.pass` (`utils/metrics.py`).
    """
    if graphs and dispatch.use_cuda(problem.uv):
        poses, points, cost, trace = _bundle_adjust_graphed(
            problem, cam, cfg, return_trace)
        out = problem._replace(poses=poses, points=points)
        return (out, cost, trace) if return_trace else (out, cost)
    dt, dev = problem.uv.dtype, problem.uv.device
    poses, points = problem.poses, problem.points
    lam = torch.full((), cfg.lm_lambda0, dtype=dt, device=dev)
    steps = torch.arange(cfg.lm_iters, device=dev)
    trace = []
    for t in range(cfg.lm_iters):
        (poses, points, lam), row = lm_step(problem, cam, cfg, poses, points,
                                            lam, steps[t], return_trace)
        trace.append(row)
    out = problem._replace(poses=poses, points=points)
    cost = final_cost(problem, cam, cfg, poses, points)
    if return_trace:
        return out, cost, BATrace(*[torch.stack(c) for c in zip(*trace)])
    return out, cost


def window_problem(poses, points, cam_idx, lm_idx, uv, w, first_cam: int,
                   n_cams: int, ur=None, wr=None) -> BAProblem:
    """Restrict a BA problem to the camera window [first, first + n):
    weights of out-of-window observations are zeroed; cameras outside
    stay fixed because their deltas receive no residual support."""
    in_win = (cam_idx >= first_cam) & (cam_idx < first_cam + n_cams)
    return make_problem(poses=poses, points=points, cam_idx=cam_idx,
                        lm_idx=lm_idx, uv=uv,
                        w=torch.where(in_win, w, torch.zeros_like(w)),
                        ur=ur, wr=wr)
