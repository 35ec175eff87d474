"""BA's PCG vector update (`ops/cuda_kernels.py`: `ba_cg_start_*`,
`ba_cg_step_*`; `dispatch.ba_cg_start`, `ba_cg_step`), on the CPU:

  - `ba._cg_solve`, which now loops over the twins, gives the bits of
    `ops/cg.cg` with the block-Jacobi preconditioner's einsum (as it was
    written before) on CG-path problems: shuffled observations, camera
    and landmark rows no observation touches (C = 26, no multiple of a
    warp or of the launch's blocks), pose priors; and on systems where
    r.z falls to eps and the updates freeze, and where p.Ap vanishes and
    the step length takes its guard;
  - the arithmetic of csrc/ba_cg.cu's launch (`torch_ba_cg_visit.py`:
    every camera visited once by the cluster's threads, the float64 sums
    in the kernel's order) gives the twins' values within CG_TOL of the
    terms' magnitude, at C that is and is not a multiple of the block or
    of the cluster, with a camera a thread and with several, and the
    twins' bits where the updates freeze;
  - the CG path's LM iterations against the JAX reference, with the
    tolerances `test_torch_ba.py` holds `bundle_adjust` to.
tests/test_torch_kernels_cuda.py holds the kernel to the twins, and to
the arithmetic here to the bit, on the card.
"""

import numpy as np
import pytest
import torch

from slam1_tpu.config import BAConfig as JBAConfig
from slam1_tpu.models import ba as jba
from slam1_tpu.ops.camera import StereoCamera as JCamera
from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import ba
from slam1_tpu_torch.ops import cuda_kernels as ck
from slam1_tpu_torch.ops import dispatch
from slam1_tpu_torch.ops.cg import cg
from test_torch_ba import rot_angle, to_jax, with_priors
from test_torch_ba_schur import CASES, _linear_system, _problem
from torch_ba_cg_visit import (cg_inputs, kernel_start, kernel_step,
                               magnitudes, within_tol)
from torch_graph_helpers import same_bits
from torch_threads import one_torch_thread  # noqa: F401


def _cg_before(matvec, btil, Minv, iters):
    """The solve as `_cg_solve` wrote it before the update was one
    launch: `ops/cg.cg` with the preconditioner's einsum, gauge zeroed."""
    dc = cg(matvec, btil, iters=iters,
            precond=lambda v: torch.einsum("cij,cj->ci", Minv, v))
    dc[0].zero_()
    return dc


@pytest.mark.parametrize("case", list(CASES))
def test_cg_solve_equals_ops_cg(case):
    """`_cg_solve` on a CG-path problem's reduced system (20 cameras, 26
    rows with the unobserved ones) against `ops/cg.cg`, to the bit: the
    camera step, the landmark step, 40 iterations."""
    p = _problem(*CASES[case])
    blocks = ba._normal_blocks(p, *_linear_system(p))
    lam = torch.tensor(1e-3)
    order = ba._obs_order(p)
    dc, dl = ba._cg_solve(p, blocks, lam, 40, order)
    matvec, btil, Minv, back = ba._reduced_system(p, blocks, lam, order)
    want = _cg_before(matvec, btil, Minv, 40)
    assert same_bits((dc, dl), (want, back(want)))
    assert bool((dc[0] == 0).all()) and bool(dc.abs().max() > 0)


def _system(c, seed, b_scale=1.0):
    """A block-diagonal SPD system over C rows (`cg_inputs`'s blocks)
    whose preconditioner is its inverse: (matvec, b, Minv)."""
    t = cg_inputs(c, seed)
    h = torch.linalg.inv(t["minv"].double()).float()
    return (lambda v: torch.einsum("cij,cj->ci", h, v), t["r"] * b_scale,
            t["minv"])


@pytest.mark.parametrize("what", ["frozen-at-start", "converged", "guard"])
def test_guards_as_ops_cg(monkeypatch, what):
    """The loop over the twins keeps cg's guards, to the bit: with b = 0
    (rz = 0 from the start) nothing moves; on a system whose Minv is its
    inverse, CG is exact after one iteration, r.z falls below eps and the
    updates freeze; where S p vanishes (S = 0), |p.Ap| < eps and the step
    length is rz / eps."""
    c, iters = 37, 12
    matvec, b, minv = _system(c, 5, 0.0 if what == "frozen-at-start"
                              else 1e-3)
    if what == "guard":
        matvec = torch.zeros_like

    def solve(n):
        monkeypatch.setattr(ba, "_reduced_system",
                            lambda *a: (matvec, b, minv, lambda dc: dc))
        return ba._cg_solve(None, None, None, n, None)[0]
    dc = solve(iters)
    assert same_bits(dc, _cg_before(matvec, b, minv, iters))
    p, rz = ck.ba_cg_start_plain(b, minv)
    if what == "frozen-at-start":
        assert float(rz) == 0.0 and bool((dc == 0).all())
    elif what == "converged":
        step = ck.ba_cg_step_plain(p, matvec(p), torch.zeros_like(b), b,
                                   minv, rz)
        assert float(rz) > ck.CG_EPS >= float(step[3])
        assert same_bits(dc, solve(1))
    else:
        want = (rz / torch.tensor(ck.CG_EPS)) * p
        want[0].zero_()
        assert same_bits(solve(1), want)


# (C, blocks, threads; None: ba_cg_launch's at the card's 16): a camera a
# thread at the benchmark's 2048 rows (1000 observed), C no multiple of
# the block or the cluster, and several cameras a thread.
VISIT_CASES = {"20": (20, None), "37": (37, None), "129": (129, None),
               "2048-1000-live": (2048, None), "2049": (2049, None),
               "8197": (8197, None), "2048-one-block": (2048, (1, 256)),
               "1000-3x64": (1000, (3, 64))}


@pytest.mark.parametrize("case", list(VISIT_CASES))
def test_kernel_arithmetic_gives_the_twins_values(case):
    c, shape = VISIT_CASES[case]
    blocks, threads = shape or ck.ba_cg_launch(c, 16)
    assert blocks * threads >= 32 and threads % 32 == 0
    live = 1000 if "live" in case else None
    t = cg_inputs(c, 7, live=live)
    p0, rz0 = kernel_start(t["r"], t["minv"], blocks, threads)
    p0_t, rz0_t = ck.ba_cg_start_plain(t["r"], t["minv"])
    m_z = torch.einsum("cij,cj->ci", t["minv"].double().abs(),
                       t["r"].double().abs())
    assert within_tol(p0, p0_t, m_z)
    assert within_tol(rz0, rz0_t, torch.sum(t["r"].double().abs() * m_z))
    args = [t[k] for k in ("p", "ap", "x", "r", "minv", "rz")]
    got = kernel_step(*args, blocks, threads)
    want = ck.ba_cg_step_plain(*args)
    denom = torch.sum(t["p"] * t["ap"])
    mags = magnitudes(t, t["rz"] / denom, want[3] / t["rz"])
    for name, a, b, m in zip("x r p rz".split(), got, want, mags):
        assert within_tol(a, b, m), name
    if live is not None:
        assert bool((got[2][live:] == 0).all())


def test_kernel_arithmetic_freezes_as_the_twins():
    """Once rz <= eps the step lengths are 0: x and r keep their bits,
    p is z, as the twins give them."""
    t = cg_inputs(129, 8)
    t["rz"] = torch.tensor(0.5 * ck.CG_EPS)
    args = [t[k] for k in ("p", "ap", "x", "r", "minv", "rz")]
    got = kernel_step(*args, *ck.ba_cg_launch(129, 16))
    want = ck.ba_cg_step_plain(*args)
    assert same_bits(got[:2], want[:2]) and same_bits(got[:2], tuple(args[2:4]))
    assert same_bits(got[2], kernel_start(t["r"], t["minv"],
                                         *ck.ba_cg_launch(129, 16))[0])


def test_dispatch_takes_the_twins_on_the_cpu():
    t = cg_inputs(40, 9)
    args = [t[k] for k in ("p", "ap", "x", "r", "minv", "rz")]
    before = ck.launch_counts()["ba_cg"]
    assert same_bits(dispatch.ba_cg_step(*args), ck.ba_cg_step_plain(*args))
    assert same_bits(dispatch.ba_cg_start(t["r"], t["minv"]),
                     ck.ba_cg_start_plain(t["r"], t["minv"]))
    assert ck.launch_counts()["ba_cg"] == before


@pytest.mark.parametrize("priors", [False, True])
def test_cg_path_bundle_adjust_matches_jax(priors):
    """bundle_adjust on the CG path (20 cameras), whose solves loop over
    the twins, against the reference: equal accept decisions and
    surviving observations, costs within 1e-3 relative, poses within
    1e-4 m and 1e-5 rad (`test_torch_ba.py`'s tolerances)."""
    from slam1_tpu_torch.utils import synthetic
    p, T_true, _, cam = synthetic.ba_problem(2, n_cams=20, n_pts=200,
                                             px_noise=0.3, n_outliers=10,
                                             device="cpu")
    if priors:
        p = with_priors(p, T_true)
    fields = dict(lm_iters=3, cg_iters=40, outlier_px=16.0)
    jout, jcost, jtr = jba.bundle_adjust(to_jax(p), JCamera.kitti_default(),
                                         JBAConfig(**fields),
                                         return_trace=True)
    out, cost, tr = ba.bundle_adjust(p, cam, BAConfig(**fields),
                                     return_trace=True)
    assert tr.accept.tolist() == np.asarray(jtr.accept).tolist()
    assert tr.n_obs.tolist() == np.asarray(jtr.n_obs).tolist()
    assert sum(tr.accept.tolist()) >= 1
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jtr.cost),
                               rtol=1e-3)
    assert abs(float(cost) - float(jcost)) <= 1e-3 * float(jcost)
    a, b = out.poses.numpy(), np.asarray(jout.poses)
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() <= 1e-4
    assert max(rot_angle(x[:3, :3], y[:3, :3]) for x, y in zip(a, b)) <= 1e-5
