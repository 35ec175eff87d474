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

The LM and its CG path take a camera model (`CameraModel`): `STEREO`,
the stereo rig above (6-dof SE(3) poses moved on the right by
`exp_se3`, fixed intrinsics, camera 0 held as the gauge, pose priors),
and `BAL`, the public BAL problems' cameras (`models/bal.py`: 9
parameters [w, t, f, k1, k2] moved additively, each camera's own
intrinsics refined, monocular observations, no camera held, no priors
and no outlier cut: LM damping holds BAL's 7-dof similarity gauge, and
Huber weights every observation, as the reference's `bal_adjust` does).
The model supplies its observation pass (three dispatch calls:
`csrc/ba_obs.cu` or `csrc/bal_obs.cu`), whose blocks set the camera
width D (6 or 9) of everything after it, its retraction, whether row 0
is held, whether the graduated outlier cut applies, its prior terms and
its preconditioner's block inverse; the reduced system's
product, its right side and the PCG's vector update are the same
kernels at either width (`csrc/ba_schur.cu`, `csrc/ba_cg.cu`). BAL
takes the CG path at every size; the dense path is the stereo rig's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import posegraph
from slam1_tpu_torch.ops import ba_obs, cuda_kernels, dispatch, se3
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.lsq import huber_weights, inv3x3, inv_spd6
from slam1_tpu_torch.ops.segment import seg_sum
from slam1_tpu_torch.utils import graphs as graph_mod
from slam1_tpu_torch.utils import metrics

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


class CameraModel(NamedTuple):
    """What the LM and its CG path read of a camera model (see the module
    docstring): `name` (its graphs `<name>_lm[...]` and `<name>_cost[...]`
    and its span `host:<name>.pass`), `held` (camera row 0 held as the
    gauge), `cut` (the graduated outlier cut of `cfg.outlier_px` applies;
    without it every observation keeps its Huber weight and the LM
    accepts on the full Huber cost), `field` (the problem's field
    of camera parameters), `retract(cams, dc)`, the observation pass
    `obs_cameras`, `obs_landmarks`, `obs_cost` (the signatures of
    `dispatch.ba_obs_cameras`, ...), `block_inverse` (the preconditioner's
    inverse of a damped DxD block), `priors` (the problem carries pose
    priors) and `dense_max` (most cameras solved densely; 0: never)."""
    name: str
    held: bool
    cut: bool
    field: str
    retract: Callable
    obs_cameras: Callable
    obs_landmarks: Callable
    obs_cost: Callable
    block_inverse: Callable
    priors: bool
    dense_max: int

    def cams(self, problem):
        return getattr(problem, self.field)

    def with_cams(self, problem, cams, points):
        return problem._replace(**{self.field: cams, "points": points})

    def dense(self, problem) -> bool:
        return self.cams(problem).shape[0] <= self.dense_max


def _right_exp(poses, dc):
    return poses @ se3.exp_se3(dc)


def _add(cams, dc):
    return cams + dc


def _inv_lu(H):
    """The inverse of each damped 9x9 block by LU, as the reference's
    `jnp.linalg.inv` (`slam1_tpu/models/bal.py` `_schur_solve9`); no error
    check, so no read-back. In float32 its product with the block is the
    identity to ~1e-5 in eigenvalue on a BAL camera whose block's diagonal
    spans ~10^8 (a rotation against a focal length of 10^3 pixels).
    Made contiguous once here: the PCG's launches read it 65 times."""
    return torch.linalg.inv_ex(H)[0].contiguous()


STEREO = CameraModel(
    "ba", True, True, "poses", _right_exp, dispatch.ba_obs_cameras,
    dispatch.ba_obs_landmarks, dispatch.ba_obs_cost, inv_spd6, True,
    DIRECT_MAX_CAMS)
BAL = CameraModel(
    "bal", False, False, "cams", _add, dispatch.bal_obs_cameras,
    dispatch.bal_obs_landmarks, dispatch.bal_obs_cost, _inv_lu, False, 0)


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


def _obs_order(problem, model: CameraModel = STEREO):
    """The observations' ordering every kernel of the CG path reads
    (`dispatch.schur_order`, keyed on the observations' weights: the
    kernels' orderings leave out the rows of weight zero)."""
    return dispatch.schur_order(problem.cam_idx, problem.lm_idx,
                                model.cams(problem).shape[0],
                                problem.points.shape[0], w=problem.w)


def _reduced_system(problem, blocks, lam, order,
                    model: CameraModel = STEREO):
    """The damped reduced camera system after landmark elimination,
    matrix-free, from the normal blocks (Hcc, Hll, W, bc, bl, prior) of
    `_normal_blocks` (or of a model's observation pass): (matvec, btil
    (C,D), Minv (C,D,D), back), where matvec(x) is the landmark half then
    the camera half of the product (`dispatch.ba_schur_landmarks`,
    `ba_schur_cameras`: gather -> block products -> segment sums over the
    observations; nothing bigger than (C,D,D) is materialised), Minv the
    block-Jacobi preconditioner (`model.block_inverse`) and back(dc) the
    landmark step (L,3) that goes with a camera step. Where the model
    holds camera 0, its block is the identity. Every product reads the
    observations' ordering `order` (`_obs_order`)."""
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
            C = Hcc.shape[0]
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

    return matvec, btil, model.block_inverse(Hcc_d), back


def _cg_solve(problem, blocks, lam, cg_iters: int, order,
              model: CameraModel = STEREO):
    """One damped GN step via landmark elimination + PCG on the reduced
    camera system of the normal blocks. Returns (delta_c (C,D),
    delta_l (L,3)); camera 0's step is zero where the model holds it.

    The PCG is `ops/cg.cg` from x = 0 with the block-Jacobi
    preconditioner z = Minv r, written out: after each product with the
    system the iteration's vector update (step length, x, r, z, r.z, the
    new direction) is `dispatch.ba_cg_step`, one launch of
    `csrc/ba_cg.cu` on the card and its plain twin (cg's own torch
    operations, to the bit) on the CPU; its start `dispatch.ba_cg_start`
    likewise."""
    matvec, btil, Minv, back = _reduced_system(problem, blocks, lam, order,
                                               model)
    dc = torch.zeros_like(btil)
    r = btil - matvec(dc)
    p, rz = dispatch.ba_cg_start(r, Minv)
    for _ in range(cg_iters):
        dc, r, p, rz = dispatch.ba_cg_step(p, matvec(p), dc, r, Minv, rz)
    if model.held:
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
            points, lam, t, trace: bool = True,
            model: CameraModel = STEREO):
    """One Levenberg-Marquardt iteration, the reference's scan body:
    ((poses, points, lam), trace row). `poses` are the model's camera
    parameters (the rig's (C,4,4) poses, BAL's (C,9) cameras; `cam` the
    rig's camera, () for BAL). `t` is the iteration, a 0-d integer tensor
    on the device, from which the graduated cut is made there. The row is
    (accepted full cost, surviving observations, the damping used,
    accept, the largest camera-step norm), 0-d tensors; None with
    `trace=False`. Nothing is read back to the host.

    On the CG path (past DIRECT_MAX_CAMS cameras for the rig, always for
    BAL) the observation pass runs through the model's three dispatch
    calls (`dispatch.ba_obs_cameras`, `ba_obs_landmarks`, `ba_obs_cost`,
    or the `bal_obs_*` ones: on the card the kernels of `csrc/ba_obs.cu`
    or `csrc/bal_obs.cu`, which visit each observation once a launch, on
    the CPU their plain twins), over one ordering of the observations
    made at the top of the iteration and read by every kernel of it
    (`_obs_order`)."""
    dt = problem.uv.dtype
    delta = cfg.huber_delta
    p = model.with_cams(problem, poses, points)
    cut2 = cap = None
    if cfg.outlier_px and model.cut:
        # Graduated rejection: the cut starts 8x loose and tightens to
        # outlier_px. The step zero-weights observations beyond the cut;
        # the objective saturates them at the cap.
        cut = graduated_cut(cfg.outlier_px, t, dt)
        cut2 = cut * cut
        cap = huber_weights(cut2, delta) * cut2
    if model.dense(problem):
        full_cur, _, hw, r2, w = ba_obs.step_weights(p, cam, cut2, delta)
        trunc_cur = ba_obs.trunc_cost(problem, hw, r2, cap)
        n_kept = torch.sum(w > 0).to(torch.int32)
        dc, dl = _schur_solve_direct(p, *_linearize(p, cam, w), lam)

        def costs_at(q):
            return ba_obs.cost_plain(q, cam, None, cap, delta)
    else:
        order = _obs_order(problem, model)
        obs = model.obs_cameras(p, cam, order, cut2, cap, delta)
        Hll, bl = model.obs_landmarks(p, cam, order, cut2, delta)
        full_cur, trunc_cur, n_kept = obs.full, obs.trunc, obs.n_kept
        Hcc, bc, prior = obs.hcc, obs.bc, None
        if model.priors:
            Hcc, bc, prior = _with_priors(p, Hcc, bc)
        dc, dl = _cg_solve(p, (Hcc, Hll, obs.W, bc, bl, prior), lam,
                           cfg.cg_iters, order, model)

        def costs_at(q):
            return model.obs_cost(q, cam, order, cap, delta)
    cost_cur = trunc_cur
    if model.priors:
        pc_cur = _prior_cost(problem, poses)
        cost_cur = trunc_cur + pc_cur
        full_cur = full_cur + pc_cur
    dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
    dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
    new_poses = model.retract(poses, dc)
    new_points = points + dl
    full_new, trunc_new = costs_at(
        model.with_cams(problem, new_poses, new_points))
    cost_new = trunc_new
    if model.priors:
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
               points, model: CameraModel = STEREO):
    """() full Huber cost plus the pose priors' (the rig's) at (poses,
    points); on the CG path through the model's cost pass
    (`dispatch.ba_obs_cost`, `bal_obs_cost`)."""
    out = model.with_cams(problem, poses, points)
    if model.dense(problem):
        cost = _cost(out, cam, cfg.huber_delta)[0]
    else:
        cost = model.obs_cost(out, cam, _obs_order(problem, model), None,
                              cfg.huber_delta)[0]
    if model.priors:
        cost = cost + _prior_cost(problem, poses)
    return cost


class _LMCarry(NamedTuple):
    """The state of the `ba_lm` (`bal_lm`) graph: the problem and camera
    it reads (BAL's: ()), the (poses, points, lam) carry (`poses` the
    model's camera parameters), the iteration `t` (a 0-d int64 tensor)
    and the trace rows written so far (a BATrace of (lm_iters,) tensors,
    or () without the trace)."""
    problem: BAProblem
    cam: StereoCamera
    poses: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor
    t: torch.Tensor
    trace: tuple


def _lm_carry(prob: BAProblem, cam: StereoCamera, cfg: BAConfig,
              return_trace: bool, model: CameraModel = STEREO) -> _LMCarry:
    """The carry of LM iteration 0: the problem's cameras and points,
    lam = lm_lambda0, t = 0 and, with the trace, zeroed rows."""
    dt, dev = prob.uv.dtype, prob.uv.device
    trace = ()
    if return_trace:
        n = cfg.lm_iters
        trace = BATrace(*[torch.zeros(n, dtype=d, device=dev) for d in (
            dt, torch.int32, dt, torch.bool, dt)])
    return _LMCarry(prob, cam, model.cams(prob), prob.points,
                    torch.full((), cfg.lm_lambda0, dtype=dt, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev), trace)


def _graphed_ba_lm(cfg: BAConfig, model: CameraModel = STEREO):
    """One `lm_step` as a graph's function: (_LMCarry) -> (the carry one
    iteration on, with `t` advanced and the iteration's trace row
    written at `t`, ())."""
    def step(carry):
        (poses, points, lam), row = lm_step(
            carry.problem, carry.cam, cfg, carry.poses, carry.points,
            carry.lam, carry.t, trace=bool(carry.trace), model=model)
        trace = carry.trace
        if row is not None:
            at = carry.t.reshape(1)
            trace = BATrace(*[buf.index_copy(0, at, x.reshape(1))
                              for buf, x in zip(trace, row)])
        return carry._replace(poses=poses, points=points, lam=lam,
                              t=carry.t + 1, trace=trace), ()
    return step


def _graphed_ba_cost(cfg: BAConfig, model: CameraModel = STEREO):
    """`final_cost` as a graph's function: (_LMCarry) -> (the same
    carry, the cost ())."""
    def step(carry):
        return carry, final_cost(carry.problem, carry.cam, cfg, carry.poses,
                                 carry.points, model)
    return step


def _size(problem: BAProblem, model: CameraModel = STEREO) -> str:
    return (f"[{model.cams(problem).shape[0]},{problem.points.shape[0]},"
            f"{problem.uv.shape[0]}]")


def lm_stage(cfg: BAConfig, problem: BAProblem,
             model: CameraModel = STEREO) -> graph_mod.Stage:
    """`ba_lm` (BAL's: `bal_lm`), one `lm_step` on an _LMCarry of
    `problem`'s shapes: the graph `bundle_adjust` and
    `pipeline.global_ba_step` share."""
    return graph_mod.Stage("ba", (cfg, model.name),
                           f"{model.name}_lm" + _size(problem, model),
                           _graphed_ba_lm(cfg, model))


# BA's graphs in the registry (`utils/graphs.py`): `BA_GRAPHS.clear()`
# drops them and frees their pools.
BA_GRAPHS = graph_mod.GRAPHS.of("ba")


def bundle_adjust(problem: BAProblem, cam: StereoCamera, cfg: BAConfig,
                  return_trace: bool = False, graphs: bool = True,
                  model: CameraModel = STEREO):
    """Full LM bundle adjustment: `cfg.lm_iters` calls of `lm_step` with
    the camera model `model` (`STEREO`: the rig's BAProblem and
    StereoCamera, camera 0 gauge-fixed; `BAL`: a `bal.BalProblem`, `cam`
    ()).

    Returns (optimised problem, final cost ()), plus a BATrace when
    `return_trace`. Nothing is read back to the host: decisions are
    device booleans applied with `where`.

    LM acceptance is judged on the objective the step was computed for,
    the truncated robust cost at the iteration's graduated cut, sum_i
    w_i min(huber(r_i), huber(cut)): excluded observations contribute
    the constant cap. The reported cost and trace stay the full Huber
    cost, comparable across iterations and runs. A model without the cut
    (`BAL`) computes and accepts its steps on the full Huber cost.

    It runs through `utils/graphs.iterate`: `ba_lm` (one `lm_step`,
    `cfg.lm_iters` times) then `ba_cost` (the final cost) on an
    _LMCarry; BAL's are `bal_lm` and `bal_cost`. On CUDA tensors each is a replay of a captured CUDA graph,
    as the reference runs one compiled program, kept in the graph
    registry under the kind "ba" (`BA_GRAPHS`) by the device, `cfg` and
    the carry's shapes and dtypes (which say whether there is a trace
    and which path, dense or CG, runs); the camera is a graph input. On
    the CPU, and with `graphs=False`, the same functions run eagerly (a
    caller that is itself being captured passes `graphs=False`). Each
    call is the span `host:ba.pass` (BAL's `host:bal.pass`;
    `utils/metrics.py`).
    """
    with metrics.span(f"host:{model.name}.pass"):
        poses, points, cost, trace = graph_mod.iterate(
            lm_stage(cfg, problem, model),
            graph_mod.Stage("ba", (cfg, model.name),
                            f"{model.name}_cost" + _size(problem, model),
                            _graphed_ba_cost(cfg, model)),
            _lm_carry(problem, cam, cfg, return_trace, model), cfg.lm_iters,
            keep=lambda c, cost: (c.poses, c.points, cost, c.trace),
            graphed=graph_mod.graphed(problem.uv, wanted=graphs))
    out = model.with_cams(problem, poses, points)
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
