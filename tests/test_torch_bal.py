"""The port's 9-parameter-camera bundle adjustment (`models/bal.py`:
`ba.bundle_adjust` with the camera model `ba.BAL`, the shared CG path)
against the JAX package's on the synthetic problem of tests/test_bal.py
(six cameras on an arc, 200 points, the start with focal lengths 5% off
and distortion zeroed) with 0.3 px of Gaussian noise on the
observations.

Tolerances: projection and cost within 1e-5 relative; one Schur step on
the reference's own Jacobians within 1e-3; after `bal_adjust` (10 LM
iterations of 100 CG iterations on both sides) f and the cost within
1e-3 relative, k1 and k2 within 1e-2 of the largest coefficient: the
distortion is weakly determined on the way down the valley (the two
sides' k1 differ by ~0.3% while every projection agrees to 0.02 px,
which a check holds); the cost after the first LM iteration and the
port's objective at the JAX side's estimate within 1e-3 too.

Why the noise: on exact observations the cost after 10 iterations
(~0.002 of a start of ~5e4) is not determined in float32. The end
still crawls down the focal-length valley (a free 7-dof gauge), and the
shared path ends 0.9% from the JAX side's cost while matching it within
7e-4 at every earlier iteration; the op-by-op port before it ended
between -1.1% and +12.9% of the JAX side's cost over 24 copies of the
start moved by one float32 rounding. With the noise the end is the
noise floor (~155): over four such copies the two sides' end costs
agree within 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import BAConfig as JBAConfig
from slam1_tpu.models import bal as jbal
from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import ba
from slam1_tpu_torch.models import bal as tbal
from slam1_tpu_torch.ops import ba_obs
from torch_threads import one_torch_thread  # noqa: F401

FIELDS = dict(lm_iters=10, cg_iters=100, huber_delta=1e9, outlier_px=0.0)


def _synthetic(seed=3, n_cams=6, n_pts=200, f=420.0, k1=-0.08, k2=0.01):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-6, 6, n_pts),
                    rng.uniform(-4, 4, n_pts)], -1).astype(np.float32)
    cams = np.asarray([np.concatenate([[0.02 * c, 0.03 * c, 0.0],
                                       [0.3 * c, -0.2 * c, 20.0],
                                       [f, k1, k2]])
                       for c in range(n_cams)], np.float32)
    ci, li = np.meshgrid(np.arange(n_cams), np.arange(n_pts), indexing="ij")
    ci, li = ci.reshape(-1), li.reshape(-1)
    uv = tbal.project(torch.as_tensor(cams)[ci],
                      torch.as_tensor(pts)[li]).numpy()
    keep = np.isfinite(uv).all(axis=1) & (np.abs(uv) < 600).all(axis=1)
    ci, li, uv = ci[keep], li[keep], uv[keep]
    uv = (uv + np.random.default_rng(11).normal(0, 0.3, uv.shape)).astype(
        np.float32)
    cams0 = cams.copy()
    cams0[:, :3] += rng.normal(0, 0.005, (n_cams, 3))
    cams0[:, 3:6] += rng.normal(0, 0.05, (n_cams, 3))
    cams0[:, 6] *= 1.05
    cams0[:, 7:] = 0.0
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return dict(cameras=cams0, points=pts0, cam_idx=ci, lm_idx=li, uv=uv), cams


@pytest.fixture(scope="module")
def problem():
    d, cams_gt = _synthetic()
    tp = tbal.from_bal_dict(d, device="cpu")
    jp = jbal.BalProblem(
        cams=jnp.asarray(d["cameras"]), points=jnp.asarray(d["points"]),
        cam_idx=jnp.asarray(d["cam_idx"], jnp.int32),
        lm_idx=jnp.asarray(d["lm_idx"], jnp.int32),
        uv=jnp.asarray(d["uv"]), w=jnp.ones(len(d["uv"]), jnp.float32))
    return tp, jp, cams_gt


def test_from_bal_dict(problem):
    tp, jp, _ = problem
    assert tp.cam_idx.dtype == tp.lm_idx.dtype == torch.int64
    assert tp.cams.shape == (6, 9) and tp.uv.shape[0] == tp.w.shape[0] > 1000
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_project_and_cost_match_jax(problem):
    tp, jp, _ = problem
    for c, l in ((0, 0), (3, 17), (5, 199)):
        a = tbal.project(tp.cams[c], tp.points[l]).numpy()
        b = np.asarray(jbal.project(jp.cams[c], jp.points[l]))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    tc, tr, _ = tbal._cost(tp, 1e9)
    jc, jr, _ = jbal._cost(jp, 1e9)
    assert abs(float(tc) - float(jc)) <= 1e-5 * float(jc)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-3)


def test_schur_solve9_matches_jax(problem):
    import jax
    tp, jp, _ = problem
    o = jp.uv.shape[0]
    args = (jnp.zeros((o, 9)), jnp.zeros((o, 3)), jp.cams[jp.cam_idx],
            jp.points[jp.lm_idx], jp.uv)
    r = jax.vmap(jbal._residual)(*args)
    Jc = jax.vmap(jax.jacfwd(jbal._residual, argnums=0))(*args)
    Jl = jax.vmap(jax.jacfwd(jbal._residual, argnums=1))(*args)
    jdc, jdl = jbal._schur_solve9(jp, r, Jc, Jl, jp.w, 1e-3, 32)
    r_, Jc_, Jl_ = [torch.as_tensor(np.array(x)) for x in (r, Jc, Jl)]
    # The shared solve at D = 9 (`ba._cg_solve` with the BAL model) on the
    # reference's own residuals and Jacobians.
    ci, li = tp.cam_idx, tp.lm_idx
    W, hcc, bc = ba_obs.camera_blocks(tp.cams.shape[0], ci, r_, Jc_, Jl_,
                                      tp.w)
    hll, bl = ba_obs.landmark_blocks(tp.points.shape[0], li, r_, Jl_, tp.w)
    dc, dl = ba._cg_solve(tp, (hcc, hll, W, bc, bl, None),
                          torch.tensor(1e-3), 32, ba._obs_order(tp, ba.BAL),
                          ba.BAL)
    for a, b in ((dc, jdc), (dl, jdl)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 5e-3 * np.abs(b).max()


def test_bal_adjust_matches_jax(problem):
    tp, jp, cams_gt = problem
    jout, jcost = jbal.bal_adjust(jp, JBAConfig(**FIELDS))
    tout, tcost = tbal.bal_adjust(tp, BAConfig(**FIELDS))
    a, b = tout.cams.numpy(), np.asarray(jout.cams)
    np.testing.assert_allclose(a[:, 6], b[:, 6], rtol=1e-3)
    scale = np.abs(b[:, 7:]).max()
    assert np.abs(a[:, 7:] - b[:, 7:]).max() <= 1e-2 * scale
    uv_t = tbal.project(tout.cams[tp.cam_idx], tout.points[tp.lm_idx])
    uv_j = tbal.project(torch.as_tensor(b)[tp.cam_idx],
                        torch.as_tensor(np.asarray(jout.points))[tp.lm_idx])
    assert float((uv_t - uv_j).abs().max()) <= 0.02
    assert abs(float(tcost) - float(jcost)) <= 1e-3 * float(jcost)
    at_j = ba.final_cost(tp, (), BAConfig(**FIELDS), torch.as_tensor(b),
                         torch.as_tensor(np.asarray(jout.points)), ba.BAL)
    assert abs(float(at_j) - float(jcost)) <= 1e-3 * float(jcost)
    one = dict(FIELDS, lm_iters=1)
    c1_t = tbal.bal_adjust(tp, BAConfig(**one))[1]
    c1_j = jbal.bal_adjust(jp, JBAConfig(**one))[1]
    assert abs(float(c1_t) - float(c1_j)) <= 1e-3 * float(c1_j)
    cost0 = float(tbal._cost(tp, 1e9)[0])
    assert float(tcost) < 1e-2 * cost0
    # towards the truth: focal lengths from 5% off to within 3%
    np.testing.assert_allclose(a[:, 6], cams_gt[:, 6], rtol=0.03)
