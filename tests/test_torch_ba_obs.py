"""BA's observation pass on the CG path (`ops/ba_obs.py`, the plain twins
of `csrc/ba_obs.cu`'s kernels, through `ops/dispatch.py`), on the CPU:

  - `ba.lm_step` and `ba.final_cost` on the CG path, which now take the
    observation terms from the twins, give the bits of the composition
    they were written as before (`_cost`, `_trunc_cost`, `_linearize`,
    `_schur_solve`, copied below as it was), with and without pose
    priors, with and without the graduated cut; so does the dense path
    (C <= 16), which keeps that composition;
  - the visit the kernels take (csrc/ba_obs.cu: each camera's rows and
    each landmark's rows through the orderings, every observation's
    terms in float32 in the kernels' order of operations, the float64
    sums in the kernels' order: a camera's rows strided over 128 threads
    and a fixed shuffle tree, a landmark's rows in order, the costs'
    per-camera partials strided over 256 threads) gives the twins'
    W, Hcc, bc, Hll and bl within OBS_TOL of the terms' magnitude and
    their costs within COST_TOL; the cost launch's visit gives the
    cameras launch's costs to the bit; rows of weight zero (a bucket's
    padding, all on landmark 0) are left out and their W rows zeroed,
    observations beyond the cut add zeros, cameras and landmarks no
    observation touches get zero blocks.
tests/test_torch_kernels_cuda.py holds the kernels to the twins on the
card.
"""

import pytest
import torch

from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import ba
from slam1_tpu_torch.ops import ba_obs, dispatch, se3
from slam1_tpu_torch.ops import cuda_kernels as ck
from slam1_tpu_torch.ops.lsq import huber_weights
from slam1_tpu_torch.utils import synthetic
from torch_graph_helpers import same_bits
from torch_threads import one_torch_thread  # noqa: F401

# The kernels against their twins, per element, as a share of the terms'
# magnitude (the same terms in float64 on absolute values,
# `_magnitudes`): each observation's terms are the twin's bits (the same
# float32 operations in the same order), so what is left is the float64
# sums' association by camera, rounded once (half an ulp of the result,
# ~6e-8 of it). 1e-6 leaves sixteen times that.
OBS_TOL = 1e-6
# The costs against the twins' float32 sums over every observation
# (pairwise, ~log2(O) roundings of 2^-24 of the sum of |terms|).
COST_TOL = 1e-5
N_CAMS = ba.DIRECT_MAX_CAMS + 4
CAM_THREADS, SUM_THREADS = 128, 256      # csrc/ba_obs.cu


def _problem(shuffled=False, empty=False, priors=False, pad=0, seed=3,
             n_cams=N_CAMS):
    """A CG-path problem (20 cameras; fewer take the dense path); `empty`
    adds 6 camera rows and 40 landmark rows no observation touches,
    `shuffled` permutes the observations, `priors` adds five pose-prior
    edges (one padding), `pad` appends rows of weight zero on camera 0
    and landmark 0, as a bucket pads."""
    p, T_true, _, cam = synthetic.ba_problem(seed, n_cams=n_cams, n_pts=240,
                                             n_outliers=10, device="cpu")
    g = torch.Generator().manual_seed(seed)
    if empty:
        c_map = torch.arange(n_cams) + (torch.arange(n_cams) >= 7) * 3
        l_map = torch.arange(p.points.shape[0]) * 2
        poses = torch.eye(4).repeat(n_cams + 6, 1, 1)
        poses[c_map] = p.poses
        points = torch.randn(2 * p.points.shape[0], 3, generator=g) * 5
        points[l_map] = p.points
        p = p._replace(poses=poses, points=points,
                       cam_idx=c_map[p.cam_idx.long()],
                       lm_idx=l_map[p.lm_idx.long()])
        T_full = poses.clone()
        T_full[c_map] = T_true
        T_true = T_full
    if shuffled:
        perm = torch.randperm(p.uv.shape[0], generator=g)
        p = p._replace(cam_idx=p.cam_idx[perm], lm_idx=p.lm_idx[perm],
                       uv=p.uv[perm], w=p.w[perm], ur=p.ur[perm],
                       wr=p.wr[perm])
    if pad:
        zero = torch.zeros(pad, dtype=p.cam_idx.dtype)
        p = p._replace(
            cam_idx=torch.cat([p.cam_idx, zero]),
            lm_idx=torch.cat([p.lm_idx, zero.to(p.lm_idx.dtype)]),
            uv=torch.cat([p.uv, torch.rand(pad, 2, generator=g) * 100]),
            ur=torch.cat([p.ur, torch.rand(pad, generator=g) * 100]),
            wr=torch.cat([p.wr, torch.ones(pad)]),
            w=torch.cat([p.w, torch.zeros(pad)]))
    if priors:
        i = torch.tensor([0, 1, 2, 5, 0])
        j = torch.tensor([1, 2, 3, 6, p.poses.shape[0] - 1])
        z = se3.inverse(T_true[i]) @ T_true[j]
        p = p._replace(pe_i=i, pe_j=j, pe_z=z,
                       pe_w=torch.tensor([1e3, 1e3, 0.0, 1e3, 1e4]))
    return p, cam


def _lm_step_before(problem, cam, cfg, poses, points, lam, t):
    """`ba.lm_step` as it was written before the observation pass went
    through the twins (its trace row included)."""
    dt = problem.uv.dtype
    p = problem._replace(poses=poses, points=points)
    full_cur, r, hw = ba._cost(p, cam, cfg.huber_delta)
    w = problem.w * hw
    r2 = torch.sum(r * r, dim=-1)
    cap = None
    if cfg.outlier_px:
        cut = ba.graduated_cut(cfg.outlier_px, t, dt)
        cut2 = cut * cut
        w = w * (r2 < cut2).to(dt)
        cap = huber_weights(cut2, cfg.huber_delta) * cut2
    pc_cur = ba._prior_cost(problem, poses)
    cost_cur = ba_obs.trunc_cost(problem, hw, r2, cap) + pc_cur
    full_cur = full_cur + pc_cur
    r_, Jc, Jl, w_ = ba._linearize(p, cam, w)
    if problem.poses.shape[0] <= ba.DIRECT_MAX_CAMS:
        dc, dl = ba._schur_solve_direct(p, r_, Jc, Jl, w_, lam)
    else:
        dc, dl = ba._schur_solve(p, r_, Jc, Jl, w_, lam, cfg.cg_iters)
    dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
    dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
    new_poses = poses @ se3.exp_se3(dc)
    new_points = points + dl
    full_new, r_new, hw_new = ba._cost(
        problem._replace(poses=new_poses, points=new_points), cam,
        cfg.huber_delta)
    r2_new = torch.sum(r_new * r_new, dim=-1)
    pc_new = ba._prior_cost(problem, new_poses)
    cost_new = ba_obs.trunc_cost(problem, hw_new, r2_new, cap) + pc_new
    full_new = full_new + pc_new
    accept = cost_new < cost_cur
    poses = torch.where(accept, new_poses, poses)
    points = torch.where(accept, new_points, points)
    lam = torch.clamp(torch.where(accept, lam / cfg.lm_lambda_down,
                                  lam * cfg.lm_lambda_up), 1e-9, 1e6)
    lam_used = torch.where(accept, lam * cfg.lm_lambda_down,
                           lam / cfg.lm_lambda_up)
    row = (torch.where(accept, full_new, full_cur),
           torch.sum(w > 0).to(torch.int32), lam_used, accept,
           torch.max(torch.linalg.norm(dc, dim=-1)))
    return (poses, points, lam), row


def _final_cost_before(problem, cam, cfg, poses, points):
    out = problem._replace(poses=poses, points=points)
    return (ba._cost(out, cam, cfg.huber_delta)[0]
            + ba._prior_cost(problem, poses))


def _sum3(a, b, c):
    """A 3-long product's sum as the kernels form it: from 0, in order."""
    return ((torch.zeros_like(a) + a) + b) + c


def _row_terms(problem, cam, cams, lms, rows, cut2, cap, delta):
    """Every visited row's terms as csrc/ba_obs.cu forms them, float32
    operation by operation: (costs (n,3): full, truncated, kept; Jc
    (n,3,6); Jl (n,3,3); r (n,3); the step's weight (n,))."""
    f32 = torch.float32
    P = problem.poses[cams]
    R, t = P[:, :3, :3], P[:, :3, 3]
    d = problem.points[lms] - t
    Xc = [_sum3(d[:, 0] * R[:, 0, j], d[:, 1] * R[:, 1, j],
                d[:, 2] * R[:, 2, j]) for j in range(3)]
    zmin = torch.tensor(ba_obs.Z_MIN, dtype=f32)
    free = Xc[2] > zmin
    z = torch.where(Xc[2] < zmin, zmin, Xc[2])
    fx, fy, cx, cy, b = cam
    uv, ur = problem.uv[rows], problem.ur[rows]
    wr, pw = problem.wr[rows], problem.w[rows]
    u = fx * Xc[0] / z + cx
    v = fy * Xc[1] / z + cy
    u_r = fx * (Xc[0] - b) / z + cx
    r = [u - uv[:, 0], v - uv[:, 1], wr * (u_r - ur)]
    r2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    d2 = torch.tensor(delta * delta, dtype=f32)
    r2min = torch.tensor(1e-12, dtype=f32)
    hw = torch.where(r2 <= d2, torch.ones_like(r2),
                     torch.sqrt(d2 / torch.where(r2 < r2min, r2min, r2)))
    wt = pw * hw
    if cut2 is not None:
        wt = wt * torch.where(r2 < cut2, 1.0, 0.0)
    c = hw * r2
    if cap is not None:
        c = torch.where(c > cap, cap, c)
    costs = torch.stack([pw * hw * r2, pw * c, (wt > 0).to(f32)], -1)
    dz = free.to(f32)
    fxz, fyz = fx / z, fy / z
    iz2 = dz / (z * z)
    zero = torch.zeros_like(z)
    Jp = [[fxz, zero, -fx * Xc[0] * iz2],
          [zero, fyz, -fy * Xc[1] * iz2],
          [wr * fxz, zero, -wr * fx * (Xc[0] - b) * iz2]]
    H = [[zero, -Xc[2], Xc[1]], [Xc[2], zero, -Xc[0]],
         [-Xc[1], Xc[0], zero]]
    Jc = torch.stack([torch.stack(
        [-Jp[p][j] for j in range(3)]
        + [_sum3(Jp[p][0] * H[0][j], Jp[p][1] * H[1][j],
                 Jp[p][2] * H[2][j]) for j in range(3)], -1)
        for p in range(3)], -2)
    Jl = torch.stack([torch.stack(
        [_sum3(Jp[p][0] * R[:, j, 0], Jp[p][1] * R[:, j, 1],
               Jp[p][2] * R[:, j, 2]) for j in range(3)], -1)
        for p in range(3)], -2)
    return costs, Jc, Jl, torch.stack(r, -1), wt


def _products(A, B, wt=None):
    """(n,k,m) of sum_a A[:, a, i] B[:, a, j] in the kernels' order, times
    wt where given."""
    out = torch.stack([torch.stack([
        _sum3(A[:, 0, i] * B[:, 0, j], A[:, 1, i] * B[:, 1, j],
              A[:, 2, i] * B[:, 2, j]) for j in range(B.shape[2])], -1)
        for i in range(A.shape[2])], -2)
    return out if wt is None else out * wt[:, None, None]


def _strided_tree(vals, seg, pos, n_seg, threads):
    """float64 sums of `vals` (n,K), visited in order, by segment as the
    kernels reduce them: row `pos` of a segment into thread pos %
    threads, each warp's 32 threads by the xor shuffle tree (own value
    first), then the warps in order."""
    acc = torch.zeros(n_seg * threads, vals.shape[1], dtype=torch.float64)
    acc.index_add_(0, seg * threads + pos % threads, vals.double())
    acc = acc.view(n_seg, threads // 32, 32, -1)
    lanes = torch.arange(32)
    for d in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lanes ^ d]
    out = acc[:, 0, 0]
    for q in range(1, threads // 32):
        out = out + acc[:, q, 0]
    return out


def _mirror(upper, n):
    """(S, n(n+1)/2) float64 upper triangles, row by row -> (S,n,n)
    float32."""
    i, j = torch.triu_indices(n, n)
    out = torch.zeros(upper.shape[0], n, n, dtype=torch.float32)
    out[:, i, j] = upper.float()
    out[:, j, i] = upper.float()
    return out


def _kernel_visit(problem, cam, order, cut2, cap, delta):
    """The three launches of csrc/ba_obs.cu as they visit the rows ->
    (ObsTerms, (Hll, Bl), the cost launch's (full, trunc))."""
    C, L = problem.poses.shape[0], problem.points.shape[0]
    O = problem.uv.shape[0]
    n_c = int(order.cam_off[-1])
    rows = order.cam_rows.long()[:n_c]
    seg = torch.searchsorted(order.cam_off.long(), torch.arange(n_c),
                             right=True) - 1
    pos = torch.arange(n_c) - order.cam_off.long()[seg]
    costs, Jc, Jl, r, wt = _row_terms(problem, cam, seg,
                                      order.cam_lms.long()[:n_c], rows,
                                      cut2, cap, delta)
    iu, ju = torch.triu_indices(6, 6)
    hcc_rows = _products(Jc, Jc, wt)[:, iu, ju]
    bc_rows = _products(Jc, (r * wt[:, None])[:, :, None])[:, :, 0]
    W = torch.zeros(O, 6, 3)
    W[rows] = _products(Jc, Jl, wt)
    sums = _strided_tree(torch.cat([costs, hcc_rows, bc_rows], -1), seg,
                         pos, C, CAM_THREADS)

    def total(part):
        tot = _strided_tree(part, torch.zeros(C, dtype=torch.long),
                            torch.arange(C), 1, SUM_THREADS)[0]
        return tot[0].float(), tot[1].float(), tot[2].int()
    full, trunc, n_kept = total(sums[:, :3])
    obs = ba_obs.ObsTerms(W, _mirror(sums[:, 3:24], 6),
                          -sums[:, 24:].float(), full, trunc, n_kept)
    cost_only = total(_strided_tree(costs, seg, pos, C, CAM_THREADS))[:2]

    n_l = int(order.lm_off[-1])
    rows = order.lm_rows.long()[:n_l]
    seg = torch.searchsorted(order.lm_off.long(), torch.arange(n_l),
                             right=True) - 1
    _, _, Jl, r, wt = _row_terms(problem, cam, order.lm_cams.long()[:n_l],
                                 seg, rows, cut2, None, delta)
    iu, ju = torch.triu_indices(3, 3)
    lm = torch.zeros(L, 9, dtype=torch.float64)
    lm.index_add_(0, seg, torch.cat([
        _products(Jl, Jl, wt)[:, iu, ju],
        _products(Jl, (r * wt[:, None])[:, :, None])[:, :, 0]], -1).double())
    return obs, (_mirror(lm[:, :6], 3), -lm[:, 6:].float()), cost_only


def _magnitudes(problem, cam, w):
    """The terms' magnitude: W (O,6,3), Hcc (C,6,6), bc (C,6), Hll
    (L,3,3), bl (L,3) worked out in float64 on the absolute value of
    every operand, the residual's as |u| + |uv| (it is a difference of
    pixel coordinates)."""
    f64 = torch.float64
    ci, li = problem.cam_idx.long(), problem.lm_idx.long()
    P = problem.poses.double()[ci]
    R, t = P[:, :3, :3].abs(), P[:, :3, 3].abs()
    d = problem.points.double()[li].abs() + t
    Xc = torch.einsum("oi,oij->oj", d, R)
    z = torch.clamp((problem.points.double()[li] - P[:, :3, 3]).unsqueeze(1)
                    .matmul(P[:, :3, :3]).squeeze(1)[:, 2], min=ba_obs.Z_MIN)
    fx, fy, cx, cy, b = [float(x) for x in cam]
    uv, ur = problem.uv.double().abs(), problem.ur.double().abs()
    wr = problem.wr.double().abs()
    r = torch.stack([fx * Xc[:, 0] / z + abs(cx) + uv[:, 0],
                     fy * Xc[:, 1] / z + abs(cy) + uv[:, 1],
                     wr * (fx * (Xc[:, 0] + b) / z + abs(cx) + ur)], -1)
    zero = torch.zeros_like(z)
    Jp = torch.stack([
        torch.stack([fx / z, zero, fx * Xc[:, 0] / z ** 2], -1),
        torch.stack([zero, fy / z, fy * Xc[:, 1] / z ** 2], -1),
        torch.stack([wr * fx / z, zero, wr * fx * (Xc[:, 0] + b) / z ** 2],
                    -1)], -2)
    Jc = torch.cat([Jp, Jp @ se3.hat(Xc).abs()], -1)
    Jl = Jp @ R.transpose(-1, -2)
    wa = w.double().abs()
    W, hcc, bc = ba_obs.camera_blocks(problem.poses.shape[0], ci, r, Jc, Jl,
                                      wa)
    hll, bl = ba_obs.landmark_blocks(problem.points.shape[0], li, r, Jl, wa)
    assert W.dtype == f64
    return W, hcc, bc.abs(), hll, bl.abs()


def _within(got, want, mag, tol):
    return bool(((got.double() - want.double()).abs()
                 <= tol * mag + 1e-30).all())


STEP_CASES = {"cut": (16.0, False), "cut-priors": (16.0, True),
              "no-cut": (0.0, False), "no-cut-priors": (0.0, True)}


@pytest.mark.parametrize("n_cams", [8, N_CAMS], ids=["dense", "cg"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_lm_step_and_final_cost_equal_the_composition_before(case, n_cams):
    """Three LM iterations and the final cost on the CPU against the
    composition they were written as before, to the bit: shuffled
    observations, unseen camera and landmark rows, padding rows."""
    outlier_px, priors = STEP_CASES[case]
    p, cam = _problem(shuffled=True, empty=True, priors=priors, pad=50,
                      n_cams=n_cams)
    cfg = BAConfig(lm_iters=3, cg_iters=20, outlier_px=outlier_px)
    state = before = (p.poses, p.points, torch.tensor(cfg.lm_lambda0))
    accepted = 0
    for t in range(3):
        state, row = ba.lm_step(p, cam, cfg, *state, torch.tensor(t))
        before, row0 = _lm_step_before(p, cam, cfg, *before, torch.tensor(t))
        assert same_bits((state, row), (before, row0)), t
        accepted += int(row[3])
    assert accepted >= 1
    assert same_bits(ba.final_cost(p, cam, cfg, *state[:2]),
                     _final_cost_before(p, cam, cfg, *state[:2]))


VISIT_CASES = {"shuffled": dict(shuffled=True),
               "empty-rows-padded": dict(empty=True, pad=300),
               "shuffled-empty-priors": dict(shuffled=True, empty=True,
                                             priors=True, pad=40)}


@pytest.mark.parametrize("cut", [True, False], ids=["cut", "no-cut"])
@pytest.mark.parametrize("case", list(VISIT_CASES))
def test_kernel_visit_order_gives_the_twins_values(case, cut):
    p, cam = _problem(**VISIT_CASES[case])
    delta = 2.0
    cut2 = torch.tensor(16.0 * 16.0) if cut else None
    cap = huber_weights(cut2, delta) * cut2 if cut else None
    C, L = p.poses.shape[0], p.points.shape[0]
    order = ck.schur_order(p.cam_idx, p.lm_idx, C, L, kernels=True, w=p.w)
    obs, (hll, bl), cost_only = _kernel_visit(p, cam, order, cut2, cap,
                                              delta)
    twin = ba_obs.cameras_plain(p, cam, order, cut2, cap, delta)
    hll_p, bl_p = ba_obs.landmarks_plain(p, cam, order, cut2, delta)
    w = ba_obs.step_weights(p, cam, cut2, delta)[4]
    m_W, m_hcc, m_bc, m_hll, m_bl = _magnitudes(p, cam, w)
    for got, want, mag in ((obs.W, twin.W, m_W), (obs.hcc, twin.hcc, m_hcc),
                           (obs.bc, twin.bc, m_bc), (hll, hll_p, m_hll),
                           (bl, bl_p, m_bl)):
        assert _within(got, want, mag, OBS_TOL)
    # Each row's terms are the twin's bits, and a landmark's rows sum in
    # the twin's order: W's visited rows, Hll and bl are the twin's bits
    # (a padding row's W is 0 where the twin's may be -0).
    kept = p.w != 0
    assert same_bits((obs.W[kept], hll, bl), (twin.W[kept], hll_p, bl_p))
    m_cost = ba_obs.cost_plain(p._replace(uv=p.uv.abs(), ur=p.ur.abs()),
                               cam, None, None, delta)[0]
    for got, want in ((obs.full, twin.full), (obs.trunc, twin.trunc)):
        assert abs(float(got) - float(want)) <= COST_TOL * float(m_cost)
    assert int(obs.n_kept) == int(twin.n_kept)
    assert same_bits(cost_only, (obs.full, obs.trunc))
    plain_cost = ba_obs.cost_plain(p, cam, order, cap, delta)
    assert same_bits(plain_cost, (twin.full, twin.trunc))
    # The padding's rows are left out and their W rows zero; unseen
    # cameras and landmarks get zero blocks.
    pad = p.w == 0
    assert int(order.cam_off[-1]) == int(order.lm_off[-1]) == int((~pad).sum())
    assert bool((obs.W[pad] == 0).all())
    if cut:
        beyond = ~pad & (w == 0)
        assert bool(beyond.any()) and bool((obs.W[beyond] == 0).all())
    lone_c = torch.bincount(p.cam_idx.long()[~pad], minlength=C) == 0
    lone_l = torch.bincount(p.lm_idx.long()[~pad], minlength=L) == 0
    if "empty" in case:
        assert bool(lone_c.any()) and bool(lone_l.any())
    assert bool((obs.hcc[lone_c] == 0).all() and (obs.bc[lone_c] == 0).all())
    assert bool((hll[lone_l] == 0).all() and (bl[lone_l] == 0).all())


def test_dispatch_takes_the_twins_on_the_cpu():
    """On CPU tensors the dispatch gives the twins' values, and the
    ordering keyed on the weights is the indices alone."""
    p, cam = _problem(shuffled=True, pad=10)
    C, L = p.poses.shape[0], p.points.shape[0]
    order = dispatch.schur_order(p.cam_idx, p.lm_idx, C, L, w=p.w)
    assert order.cam_rows is None and order.lm_off is None
    cut2 = torch.tensor(100.0)
    assert same_bits(dispatch.ba_obs_cameras(p, cam, order, cut2, None, 2.0),
                     ba_obs.cameras_plain(p, cam, order, cut2, None, 2.0))
    assert same_bits(dispatch.ba_obs_landmarks(p, cam, order, cut2, 2.0),
                     ba_obs.landmarks_plain(p, cam, order, cut2, 2.0))
    assert same_bits(dispatch.ba_obs_cost(p, cam, order, None, 2.0),
                     ba_obs.cost_plain(p, cam, order, None, 2.0))
