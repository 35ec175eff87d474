"""BA's reduced-system product as two halves (`ops/cuda_kernels.py`:
`ba_schur_landmarks_*`, `ba_schur_cameras_*`, `schur_order`), on the
CPU:

  - the plain twins, through `ba._reduced_system`, give the product, the
    right side and the back-substitution of the composition of einsums
    and float64 segment sums they replaced (copied below as it was) to
    the bit: shuffled observations, cameras and landmarks no observation
    touches, with and without pose priors; the dense path's landmark
    step (the landmark half's twin) gives its former back-substitution;
  - `segment_order`'s offsets equal a bincount and a cumulative sum, its
    rows are a stable sort, and `schur_order` reads nothing back to the
    host (it runs inside the `ba_lm` graph on the card); given W, it
    leaves out the observations whose block is zero, which changes no
    bit of the kernels' visit;
  - the visit order the kernels take (csrc/ba_schur.cu: the rows of each
    landmark and of each camera through the orderings, float32 products,
    float64 sums in that order) gives the twins' values within 1e-6 of
    the terms' magnitude: the orderings cover every observation once,
    with the right camera and landmark beside each row.
tests/test_torch_kernels_cuda.py holds the kernels to the twins on the
card.
"""

import numpy as np
import pytest
import torch

from slam1_tpu_torch.models import ba
from slam1_tpu_torch.ops import cuda_kernels as ck
from slam1_tpu_torch.ops import dispatch, se3
from slam1_tpu_torch.ops.lsq import inv3x3
from slam1_tpu_torch.ops.segment import seg_sum
from slam1_tpu_torch.utils import synthetic
from torch_graph_helpers import HostReads, same_bits
from torch_threads import one_torch_thread  # noqa: F401

N_CAMS = ba.DIRECT_MAX_CAMS + 4


def _problem(shuffled: bool, empty: bool, priors: bool, seed: int = 3,
             n_cams: int = N_CAMS):
    """A CG-path problem (20 cameras; fewer take the dense path); `empty`
    adds 6 camera rows and 40 landmark rows no observation touches,
    `shuffled` permutes the observations, `priors` adds five pose-prior
    edges (one padding)."""
    p, T_true, _, _ = synthetic.ba_problem(seed, n_cams=n_cams, n_pts=240,
                                           n_outliers=10, device="cpu")
    g = torch.Generator().manual_seed(seed)
    if empty:
        # Padding rows between and after the real ones.
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
    if priors:
        i = torch.tensor([0, 1, 2, 5, 0])
        j = torch.tensor([1, 2, 3, 6, p.poses.shape[0] - 1])
        z = se3.inverse(T_true[i]) @ T_true[j]
        p = p._replace(pe_i=i, pe_j=j, pe_z=z,
                       pe_w=torch.tensor([1e3, 1e3, 0.0, 1e3, 1e4]))
    return p


def _linear_system(p):
    cam = synthetic.ba_problem(3, n_cams=N_CAMS, device="cpu")[3]
    _, r, hw = ba._cost(p, cam, 2.0)
    r_, Jc, Jl, w = ba._linearize(p, cam, p.w * hw)
    return r_, Jc, Jl, w


def _composition_before(problem, r, Jc, Jl, w, lam):
    """The product, right side and back-substitution of `_reduced_system`
    as they were written before the halves: einsums and float64 segment
    sums over the observations in their order."""
    seg = seg_sum
    C = problem.poses.shape[0]
    L = problem.points.shape[0]
    ci, li = problem.cam_idx.long(), problem.lm_idx.long()
    Hcc, Hll, W, bc, bl, prior = ba._normal_blocks(problem, r, Jc, Jl, w)
    Hcc_d = ba._damped(Hcc, lam)
    Hll_inv = inv3x3(ba._damped(Hll, lam))
    btil = bc - seg(C, ci, torch.einsum(
        "oij,oj->oi", W, torch.einsum("lij,lj->li", Hll_inv, bl)[li]))
    btil[0].zero_()

    def matvec(x):
        u = torch.einsum("oij,oi->oj", W, x[ci])
        v = torch.einsum("lij,lj->li", Hll_inv, seg(L, li, u))
        y = torch.einsum("oij,oj->oi", W, v[li])
        out = torch.einsum("cij,cj->ci", Hcc_d, x) - seg(C, ci, y)
        if prior is not None:
            pi, pj, Jpi, Jpj, wp = prior
            wp2 = wp[:, None]
            out = out + seg(C, torch.cat([pi, pj]), torch.cat([
                torch.einsum("eab,ea->eb", Jpi, wp2 * torch.einsum(
                    "eab,eb->ea", Jpj, x[pj])),
                torch.einsum("eab,ea->eb", Jpj, wp2 * torch.einsum(
                    "eab,eb->ea", Jpi, x[pi]))]))
        out[0] = x[0]
        return out

    def back(dc):
        u = torch.einsum("oij,oi->oj", W, dc[ci])
        return torch.einsum("lij,lj->li", Hll_inv, bl - seg(L, li, u))

    return matvec, btil, back


CASES = {"shuffled": (True, False, False), "empty-rows": (False, True, False),
         "shuffled-empty-priors": (True, True, True),
         "priors": (False, False, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_twins_equal_the_composition_they_replaced(case):
    p = _problem(*CASES[case])
    lin = _linear_system(p)
    lam = torch.tensor(1e-3)
    matvec, btil, _, back = ba._reduced_system(p, *lin, lam)
    matvec0, btil0, back0 = _composition_before(p, *lin, lam)
    g = torch.Generator().manual_seed(7)
    C = p.poses.shape[0]
    assert same_bits(btil, btil0)
    for _ in range(3):
        x = torch.randn(C, 6, generator=g)
        assert same_bits(matvec(x), matvec0(x))
        assert same_bits(back(x), back0(x))
    # and the whole CG solve built on them
    dc, dl = ba._schur_solve(p, *lin, lam, 20)
    assert torch.isfinite(dc).all() and torch.isfinite(dl).all()


@pytest.mark.parametrize("case", ["shuffled", "shuffled-empty-priors"])
def test_dense_path_landmark_step_is_the_composition_it_replaced(case):
    """The dense path (C <= 16) takes its landmark step from the landmark
    half's plain twin on every device: the back-substitution it was
    written as before, to the bit."""
    p = _problem(*CASES[case], n_cams=8)
    lin = _linear_system(p)
    lam = torch.tensor(1e-3)
    dc, dl = ba._schur_solve_direct(p, *lin, lam)
    _, Hll, W, _, bl, _ = ba._normal_blocks(p, *lin)
    Hll_inv = inv3x3(ba._damped(Hll, lam))
    ci, li = p.cam_idx.long(), p.lm_idx.long()
    u = torch.einsum("oij,oi->oj", W, dc[ci])
    want = torch.einsum("lij,lj->li", Hll_inv,
                        bl - seg_sum(p.points.shape[0], li, u))
    assert torch.isfinite(dc).all()
    assert same_bits(dl, want)


@pytest.mark.parametrize("o,n,seed", [(1, 1, 0), (1000, 17, 1),
                                      (4099, 2048, 2), (333, 400, 3)])
def test_segment_order_offsets_equal_bincount_cumsum(o, n, seed):
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, n, o))
    rows, off = ck.segment_order(idx, n)
    want = torch.cat([torch.zeros(1, dtype=torch.int64),
                      torch.cumsum(torch.bincount(idx, minlength=n), 0)])
    assert rows.dtype == off.dtype == torch.int32
    assert torch.equal(off.long(), want)
    # a stable sort: each segment's rows ascend and hold its value only
    assert torch.equal(torch.sort(rows.long()).values, torch.arange(o))
    for s in range(n):
        seg = rows[off[s]:off[s + 1]].long()
        assert bool((idx[seg] == s).all())
        assert bool((seg[1:] > seg[:-1]).all())


def test_schur_order_reads_nothing_back():
    """The kernels' orderings (made on the CPU here, as the `ba_lm` graph
    makes them on the card) read nothing back to the host; without the
    kernels the order is the indices alone."""
    p = _problem(True, True, False)
    C, L = p.poses.shape[0], p.points.shape[0]
    with HostReads() as rec:
        order = ck.schur_order(p.cam_idx, p.lm_idx, C, L, kernels=True)
    assert rec.ops == []
    assert order.lm_off.shape == (L + 1,) and order.cam_off.shape == (C + 1,)
    plain = dispatch.schur_order(p.cam_idx, p.lm_idx, C, L)
    assert plain.lm_rows is None and plain.cam_off is None
    assert torch.equal(plain.cam_idx, p.cam_idx.long())


def _by_segments(vals, off):
    """float64 sums of `vals` (already in the ordering's order) over the
    segments `off`, one segment at a time in that order."""
    n = off.shape[0] - 1
    seg = torch.searchsorted(off.long(), torch.arange(vals.shape[0]),
                             right=True) - 1
    out = torch.zeros((n,) + vals.shape[1:], dtype=torch.float64)
    return out.index_add_(0, seg, vals.double())


def _kernel_visit(W, hll_inv, hcc, order, x, a=None):
    """The landmark half and the camera half computed as the kernels
    visit the observations: rows, cameras and landmarks read through the
    orderings only."""
    n_l = int(order.lm_off[-1])             # rows past it are left out
    rows_l = order.lm_rows.long()[:n_l]
    u = torch.einsum("oij,oi->oj", W[rows_l],
                     x[order.lm_cams.long()[:n_l]])
    s = _by_segments(u, order.lm_off).float()
    t = s if a is None else a - s
    v = torch.einsum("lij,lj->li", hll_inv, t)
    n_c = int(order.cam_off[-1])
    rows_c = order.cam_rows.long()[:n_c]
    y = torch.einsum("oij,oj->oi", W[rows_c], v[order.cam_lms.long()[:n_c]])
    out = torch.einsum("cij,cj->ci", hcc, x) - _by_segments(
        y, order.cam_off).float()
    out[0] = x[0]
    return v, out


@pytest.mark.parametrize("case", ["shuffled", "empty-rows"])
def test_schur_order_leaves_zero_blocks_out(case):
    """Given W, the kernels' orderings leave out the observations whose
    block is all zero (a bucket's padding, all on camera 0 and landmark
    0, and a few cut rows): the offsets count the other rows alone, and
    the kernels' visit gives the bits it gives over every row."""
    p = _problem(*CASES[case])
    r, Jc, Jl, w = _linear_system(p)
    lam = torch.tensor(1e-3)
    Hcc, Hll, W, _, _, _ = ba._normal_blocks(p, r, Jc, Jl, w)
    Hcc_d = ba._damped(Hcc, lam)
    Hll_inv = inv3x3(ba._damped(Hll, lam))
    C, L = p.poses.shape[0], p.points.shape[0]
    pad = 300
    W = torch.cat([W, torch.zeros(pad, 6, 3)])
    W[torch.randperm(W.shape[0] - pad,
                     generator=torch.Generator().manual_seed(2))[:9]] = 0.0
    ci = torch.cat([p.cam_idx.long(), torch.zeros(pad, dtype=torch.int64)])
    li = torch.cat([p.lm_idx.long(), torch.zeros(pad, dtype=torch.int64)])
    every = ck.schur_order(ci, li, C, L, kernels=True)
    order = ck.schur_order(ci, li, C, L, kernels=True, W=W)
    kept = (W != 0).flatten(1).any(1)
    for off, idx, n in ((order.lm_off, li, L), (order.cam_off, ci, C)):
        want = torch.cumsum(torch.bincount(idx[kept], minlength=n), 0)
        assert torch.equal(off.long()[1:], want) and int(off[0]) == 0
    assert int(kept.sum()) == W.shape[0] - pad - 9
    x = torch.randn(C, 6, generator=torch.Generator().manual_seed(5))
    for got, ref in zip(_kernel_visit(W, Hll_inv, Hcc_d, order, x),
                        _kernel_visit(W, Hll_inv, Hcc_d, every, x)):
        assert same_bits(got, ref)


@pytest.mark.parametrize("case", ["shuffled", "empty-rows"])
def test_kernel_visit_order_gives_the_twins_values(case):
    p = _problem(*CASES[case])
    r, Jc, Jl, w = _linear_system(p)
    lam = torch.tensor(1e-3)
    Hcc, Hll, W, bc, bl, _ = ba._normal_blocks(p, r, Jc, Jl, w)
    Hcc_d = ba._damped(Hcc, lam)
    Hll_inv = inv3x3(ba._damped(Hll, lam))
    C, L = p.poses.shape[0], p.points.shape[0]
    order = ck.schur_order(p.cam_idx, p.lm_idx, C, L, kernels=True)
    x = torch.randn(C, 6, generator=torch.Generator().manual_seed(5))
    v_k, out_k = _kernel_visit(W, Hll_inv, Hcc_d, order, x)
    v_p = ck.ba_schur_landmarks_plain(W, Hll_inv, order, x=x)
    out_p = ck.ba_schur_cameras_plain(W, v_p, order, hcc=Hcc_d, x=x)
    # The terms' magnitude, in float64 on absolute values.
    ci, li = order.cam_idx, order.lm_idx
    W64, x64 = W.double().abs(), x.double().abs()
    m_s = seg_sum(L, li, torch.einsum("oij,oi->oj", W64, x64[ci]))
    m_v = torch.einsum("lij,lj->li", Hll_inv.double().abs(), m_s)
    m_out = (torch.einsum("cij,cj->ci", Hcc_d.double().abs(), x64)
             + seg_sum(C, ci, torch.einsum("oij,oj->oi", W64, m_v[li])))
    assert ((v_k - v_p).abs() <= 1e-6 * m_v + 1e-30).all()
    assert ((out_k - out_p).abs() <= 1e-6 * m_out + 1e-30).all()
    if case == "empty-rows":
        # Rows no observation touches: y = 0 and s = 0 exactly.
        lone_c = torch.bincount(ci, minlength=C) == 0
        lone_l = torch.bincount(li, minlength=L) == 0
        assert lone_c.any() and lone_l.any()
        assert same_bits(out_k[lone_c], (torch.einsum(
            "cij,cj->ci", Hcc_d, x))[lone_c])
        assert bool((v_k[lone_l] == 0).all())
