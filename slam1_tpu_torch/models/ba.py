"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt
(counterpart of `slam1_tpu/models/ba.py`).

  - reprojection residuals of stereo observations [u_left, v_left,
    right-u] with per-observation camera (3x6) and landmark (3x3)
    Jacobians, written out by hand, and their robust costs
    (`ops/ba_obs.py`);
  - Hessian blocks by scatter-add: Hcc (C,6,6), Hll (L,3,3), coupling W
    (O,6,3) per observation; on the CG path the whole observation pass
    (residual, Huber weight, cut, costs, Jacobians, blocks) is three
    hand-written kernels on the card (`csrc/ba_obs.cu`: cameras,
    landmarks, the cost after the step) and their plain twins on the
    CPU, through `ops/dispatch.py`;
  - per-landmark elimination with batched closed-form 3x3 inverses;
  - the reduced camera system solved densely for a local window
    (C <= 16, `_schur_solve_direct`) and matrix-free with block-Jacobi
    preconditioned CG otherwise (`_schur_solve`), whose product with
    the system is two hand-written kernels on the card
    (`csrc/ba_schur.cu`: a landmark half and a camera half, through
    `ops/dispatch.py`) and their plain twins on the CPU, and whose vector
    update after each product is one launch of `csrc/ba_cg.cu` (its
    plain twin on the CPU);
  - outer Levenberg-Marquardt with accept/reject damping, Huber IRLS
    weights and a graduated outlier cut, fixed iteration counts, no
    value read back to the host: `lm_step` is one iteration (the
    reference's scan body, the iteration a device scalar) and
    `bundle_adjust` a loop over it. On the card `bundle_adjust` replays
    `lm_step` as a captured CUDA graph, as the reference jits it:
    `ba_lm` (one iteration, `_graphed_ba_lm`, replayed `lm_iters` times)
    and `ba_cost` (the final cost), kept in the graph registry of
    `utils/graphs.py` (`BA_GRAPHS`); `global_ba_step`
    (`models/pipeline.py`) replays the same `ba_lm` graph between graphs
    of its own.

Every scatter-add accumulates in float64 and rounds once to the working
dtype (`ops/segment.seg_sum`): CUDA's `index_add_` adds in the order
its atomics land, and a float32 sum that depends on that order flips
strict LM accept decisions between two runs of the same clip. The
CG path's kernels sum in float64 too, in a fixed order.

Camera 0 is gauge-fixed. Intrinsics are fixed (`models/bal.py` is the
variant with 9-parameter cameras).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import posegraph
from slam1_tpu_torch.ops import ba_obs, cuda_kernels, dispatch, se3
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.lsq import huber_weights, inv3x3, inv_spd6
from slam1_tpu_torch.ops.segment import seg_sum
from slam1_tpu_torch.utils import graphs as graph_mod
from slam1_tpu_torch.utils.metrics import traced

DIRECT_MAX_CAMS = 16       # dense reduced system up to this many cameras

# The observation terms (`ops/ba_obs.py`) under the names the rest of the
# port and its tests use.
_obs_residual = ba_obs.obs_residual
_obs_terms = ba_obs.obs_terms
_cost = ba_obs.huber_cost


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
    (O,6,3), bc (C,6), bl (L,3), with the pose priors folded in
    (`_with_priors`), and the prior terms (None without priors) for the
    cross blocks."""
    W, Hcc, bc = ba_obs.camera_blocks(problem.poses.shape[0],
                                      problem.cam_idx.long(), r, Jc, Jl, w)
    Hll, bl = ba_obs.landmark_blocks(problem.points.shape[0],
                                     problem.lm_idx.long(), r, Jl, w)
    Hcc, bc, prior = _with_priors(problem, Hcc, bc)
    return Hcc, Hll, W, bc, bl, prior


def _with_priors(problem, Hcc, bc):
    """(Hcc, bc, prior): the observations' Hcc and bc with the pose
    priors' gradient and diagonal curvature folded in (LM damping and the
    block-Jacobi preconditioner must see the dominant curvature), and the
    prior terms (None without priors) for the cross blocks."""
    if problem.pe_i.shape[0] == 0:
        return Hcc, bc, None
    C = problem.poses.shape[0]
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
    return Hcc, bc, (pi, pj, Jpi, Jpj, wp)


def _damped(H, lam):
    n = H.shape[-1]
    return H + lam * _diag_only(H) + 1e-6 * torch.eye(
        n, dtype=H.dtype, device=H.device)


def _obs_order(problem):
    """The observations' ordering every kernel of the CG path reads
    (`dispatch.schur_order`, keyed on the observations' weights: the
    kernels' orderings leave out the rows of weight zero)."""
    return dispatch.schur_order(problem.cam_idx, problem.lm_idx,
                                problem.poses.shape[0],
                                problem.points.shape[0], w=problem.w)


def _reduced_system(problem, blocks, lam, order):
    """The damped reduced camera system after landmark elimination,
    matrix-free, from the normal blocks (Hcc, Hll, W, bc, bl, prior) of
    `_normal_blocks`: (matvec, btil (C,6), Minv (C,6,6), back), where
    matvec(x) is the landmark half then the camera half of the product
    (`dispatch.ba_schur_landmarks`, `ba_schur_cameras`: gather -> block
    products -> segment sums over the observations; nothing bigger than
    (C,6,6) is materialised), Minv the block-Jacobi preconditioner and
    back(dc) the landmark step (L,3) that goes with a camera step.
    Camera 0's block is the identity. Every product reads the
    observations' ordering `order` (`_obs_order`)."""
    C = problem.poses.shape[0]
    Hcc, Hll, W, bc, bl, prior = blocks
    Hcc_d = _damped(Hcc, lam)
    Hll_inv = inv3x3(_damped(Hll, lam))                          # (L,3,3)

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


def _cg_solve(problem, blocks, lam, cg_iters: int, order):
    """One damped GN step via landmark elimination + PCG on the reduced
    camera system of the normal blocks. Returns (delta_c (C,6),
    delta_l (L,3)).

    The PCG is `ops/cg.cg` from x = 0 with the block-Jacobi
    preconditioner z = Minv r, written out: after each product with the
    system the iteration's vector update (step length, x, r, z, r.z, the
    new direction) is `dispatch.ba_cg_step`, one launch of
    `csrc/ba_cg.cu` on the card and its plain twin (cg's own torch
    operations, to the bit) on the CPU; its start `dispatch.ba_cg_start`
    likewise."""
    matvec, btil, Minv, back = _reduced_system(problem, blocks, lam, order)
    dc = torch.zeros_like(btil)
    r = btil - matvec(dc)
    p, rz = dispatch.ba_cg_start(r, Minv)
    for _ in range(cg_iters):
        dc, r, p, rz = dispatch.ba_cg_step(p, matvec(p), dc, r, Minv, rz)
    dc[0].zero_()
    return dc, back(dc)


def _schur_solve(problem, r, Jc, Jl, w, lam, cg_iters: int):
    """`_cg_solve` from a linearisation (residuals, Jacobians, weights)."""
    return _cg_solve(problem, _normal_blocks(problem, r, Jc, Jl, w), lam,
                     cg_iters, _obs_order(problem))


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
    None with `trace=False`. Nothing is read back to the host.

    Past DIRECT_MAX_CAMS cameras (the CG path) the observation pass runs
    through `dispatch.ba_obs_cameras`, `ba_obs_landmarks` and
    `ba_obs_cost` (on the card the kernels of `csrc/ba_obs.cu`, which
    visit each observation once a launch, on the CPU their plain twins),
    over one ordering of the observations made at the top of the
    iteration and read by every kernel of it (`_obs_order`)."""
    dt = problem.uv.dtype
    delta = cfg.huber_delta
    p = problem._replace(poses=poses, points=points)
    cut2 = cap = None
    if cfg.outlier_px:
        # Graduated rejection: the cut starts 8x loose and tightens to
        # outlier_px. The step zero-weights observations beyond the cut;
        # the objective saturates them at the cap.
        cut = graduated_cut(cfg.outlier_px, t, dt)
        cut2 = cut * cut
        cap = huber_weights(cut2, delta) * cut2
    if problem.poses.shape[0] <= DIRECT_MAX_CAMS:
        full_cur, _, hw, r2, w = ba_obs.step_weights(p, cam, cut2, delta)
        trunc_cur = ba_obs.trunc_cost(problem, hw, r2, cap)
        n_kept = torch.sum(w > 0).to(torch.int32)
        dc, dl = _schur_solve_direct(p, *_linearize(p, cam, w), lam)

        def costs_at(q):
            return ba_obs.cost_plain(q, cam, None, cap, delta)
    else:
        order = _obs_order(problem)
        obs = dispatch.ba_obs_cameras(p, cam, order, cut2, cap, delta)
        Hll, bl = dispatch.ba_obs_landmarks(p, cam, order, cut2, delta)
        full_cur, trunc_cur, n_kept = obs.full, obs.trunc, obs.n_kept
        Hcc, bc, prior = _with_priors(p, obs.hcc, obs.bc)
        dc, dl = _cg_solve(p, (Hcc, Hll, obs.W, bc, bl, prior), lam,
                           cfg.cg_iters, order)

        def costs_at(q):
            return dispatch.ba_obs_cost(q, cam, order, cap, delta)
    pc_cur = _prior_cost(problem, poses)
    cost_cur = trunc_cur + pc_cur
    full_cur = full_cur + pc_cur
    dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
    dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
    new_poses = poses @ se3.exp_se3(dc)
    new_points = points + dl
    full_new, trunc_new = costs_at(
        problem._replace(poses=new_poses, points=new_points))
    pc_new = _prior_cost(problem, new_poses)
    cost_new = trunc_new + pc_new
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
        row = (torch.where(accept, full_new, full_cur), n_kept, lam_used,
               accept, torch.max(torch.linalg.norm(dc, dim=-1)))
    return (poses, points, lam), row


def final_cost(problem: BAProblem, cam: StereoCamera, cfg: BAConfig, poses,
               points):
    """() full Huber cost plus the pose priors' at (poses, points); on the
    CG path through `dispatch.ba_obs_cost`."""
    out = problem._replace(poses=poses, points=points)
    if problem.poses.shape[0] <= DIRECT_MAX_CAMS:
        cost = _cost(out, cam, cfg.huber_delta)[0]
    else:
        cost = dispatch.ba_obs_cost(out, cam, _obs_order(problem), None,
                                    cfg.huber_delta)[0]
    return cost + _prior_cost(problem, poses)


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


def _size(problem: BAProblem) -> str:
    return (f"[{problem.poses.shape[0]},{problem.points.shape[0]},"
            f"{problem.uv.shape[0]}]")


def lm_stage(cfg: BAConfig, problem: BAProblem) -> graph_mod.Stage:
    """`ba_lm`, one `lm_step` on an _LMCarry of `problem`'s shapes: the
    graph `bundle_adjust` and `pipeline.global_ba_step` share."""
    return graph_mod.Stage("ba", (cfg,), "ba_lm" + _size(problem),
                           _graphed_ba_lm(cfg))


# BA's graphs in the registry (`utils/graphs.py`): `BA_GRAPHS.clear()`
# drops them and frees their pools.
BA_GRAPHS = graph_mod.GRAPHS.of("ba")


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

    It runs through `utils/graphs.iterate`: `ba_lm` (one `lm_step`,
    `cfg.lm_iters` times) then `ba_cost` (the final cost) on an
    _LMCarry. On CUDA tensors each is a replay of a captured CUDA graph,
    as the reference runs one compiled program, kept in the graph
    registry under the kind "ba" (`BA_GRAPHS`) by the device, `cfg` and
    the carry's shapes and dtypes (which say whether there is a trace
    and which path, dense or CG, runs); the camera is a graph input. On
    the CPU, and with `graphs=False`, the same functions run eagerly (a
    caller that is itself being captured passes `graphs=False`). Each
    call is the span `host:ba.pass` (`utils/metrics.py`).
    """
    poses, points, cost, trace = graph_mod.iterate(
        lm_stage(cfg, problem),
        graph_mod.Stage("ba", (cfg,), "ba_cost" + _size(problem),
                        _graphed_ba_cost(cfg)),
        _lm_carry(problem, cam, cfg, return_trace), cfg.lm_iters,
        keep=lambda c, cost: (c.poses, c.points, cost, c.trace),
        graphed=graph_mod.graphed(problem.uv, wanted=graphs))
    out = problem._replace(poses=poses, points=points)
    return (out, cost, trace) if return_trace else (out, cost)


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
