"""BAL's 9-parameter bundle adjustment on the port's shared CG path
(`ba.bundle_adjust` with the camera model `ba.BAL`), on the CPU, against
the plain reference `tests/bal_plain_reference.py` (plain torch, float32,
TF32 off) and against torch.autograd, on seeded random problems of at
most 16 cameras and a few hundred points:

  - the projection, the residual and the analytic Jacobians
    (`ops/bal_obs.obs_terms`, as `csrc/bal_obs.cu` writes them; the
    reference's from the right Jacobian of SO(3)) against autograd in
    float64, within 1e-9 of the largest entry (rounding alone);
  - the D = 9 twins (both halves of the reduced system's product, the
    PCG's vector update, the three observation launches) against plain
    einsums of autograd's Jacobians, within 1e-5 of the terms (float32
    against float64 sums);
  - one LM step and a whole pass of 15 LM iterations (`BAConfig()`'s
    settings; BAL's model cuts no observation) against the reference: the
    step within 1e-3 of its own size (two float32 PCGs of 64 iterations,
    summed in other orders, on a system whose 7-dof gauge only the
    damping holds; measured <= 1.1e-4 on five seeds); after the pass the
    full cost within 1e-4 and the camera centres, aligned by a
    similarity onto the reference's, within 1e-3 of the scene's depth
    (measured <= 5.2e-7 and <= 1.9e-5 on six seeds, every accept
    decision agreeing);
  - `benchmark/reference/bal_ref.py`, the benchmark's copy of the
    reference, equal to it to the bit on one problem;
  - `bal_adjust` runs through `graphs.iterate` (kind "ba", stages
    `bal_lm[C,L,O]` and `bal_cost[C,L,O]`), graphed equal to eager;
  - `utils/export.load_bal` reads a BAL file the test writes, and
    `slam-torch bal` refines it on the CPU, its `--trace` holding the
    spans `host:bal.load` and `host:bal.pass` and the counter
    `kernel_launches["bal_obs"]`.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import bal_plain_reference as ref
from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import ba, bal
from slam1_tpu_torch.ops import bal_obs, cuda_kernels, se3
from slam1_tpu_torch.ops.segment import seg_sum
from torch_graph_helpers import emulated_graphs, fresh_graphs  # noqa: F401
from torch_graph_helpers import by_base, same_bits
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = BAConfig()
CFG_DICT = {k: getattr(CFG, k) for k in (
    "lm_iters", "cg_iters", "lm_lambda0", "lm_lambda_up", "lm_lambda_down",
    "huber_delta")}
JAC_TOL = 1e-9
TWIN_TOL = 1e-5
STEP_TOL = 1e-3
COST_TOL = 1e-4
CAM_TOL = 1e-3


def bal_problem(seed, n_cams=12, n_pts=300, noise=1.0, outliers=6,
                dtype=torch.float32):
    """A seeded BAL problem: cameras on a ring 30-40 m from a ball of
    points 5 m across, looking at its centre, f 400-800 px, k1 within
    0.1, k2 within 0.02; each point seen by 2-6 cameras, observations
    ordered by point as BAL files are; `noise` px on each coordinate,
    `outliers` rows moved 20-60 px; the start's cameras and points
    perturbed. -> (the problem, the true cameras (C,9), the true points)."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g,
                                           dtype=torch.float64)

    def n(*shape, s=1.0):
        return s * torch.randn(*shape, generator=g, dtype=torch.float64)

    ang = 2 * torch.pi * torch.arange(n_cams, dtype=torch.float64) / n_cams
    rho = u(n_cams, lo=30.0, hi=40.0)
    centre = torch.stack([rho * torch.cos(ang), rho * torch.sin(ang),
                          u(n_cams, lo=-3.0, hi=3.0)], -1)
    z_axis = centre / torch.linalg.norm(centre, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64).expand_as(z_axis)
    x_axis = torch.linalg.cross(up, z_axis)
    x_axis = x_axis / torch.linalg.norm(x_axis, dim=-1, keepdim=True)
    y_axis = torch.linalg.cross(z_axis, x_axis)
    R = torch.stack([x_axis, y_axis, z_axis], -2)          # world -> camera
    cams = torch.cat([se3.log_so3(R), -(R @ centre[:, :, None])[:, :, 0],
                      u(n_cams, 1, lo=400.0, hi=800.0),
                      u(n_cams, 1, lo=-0.1, hi=0.1),
                      u(n_cams, 1, lo=-0.02, hi=0.02)], -1)
    pts = n(n_pts, 3)
    pts = 2.5 * pts / torch.linalg.norm(pts, dim=-1, keepdim=True) \
        * u(n_pts, 1) ** (1 / 3)
    ci, li = [], []
    for p in range(n_pts):
        k = int(torch.randint(2, 7, (1,), generator=g))
        cs = torch.randperm(n_cams, generator=g)[:k].sort().values
        ci.append(cs)
        li.append(torch.full((k,), p))
    ci, li = torch.cat(ci), torch.cat(li)
    uv = bal_obs.project(cams[ci], pts[li]) + n(ci.shape[0], 2, s=noise)
    bad = torch.randperm(ci.shape[0], generator=g)[:outliers]
    kick = n(outliers, 2)
    uv[bad] += kick / torch.linalg.norm(kick, dim=-1, keepdim=True) \
        * u(outliers, 1, lo=20.0, hi=60.0)
    start = cams + torch.cat([n(n_cams, 3, s=2e-3), n(n_cams, 3, s=0.05),
                              cams[:, 6:7] * n(n_cams, 1, s=0.01),
                              n(n_cams, 1, s=0.01), n(n_cams, 1, s=0.002)],
                             -1)
    prob = bal.BalProblem(cams=start.to(dtype),
                          points=(pts + n(n_pts, 3, s=0.05)).to(dtype),
                          cam_idx=ci, lm_idx=li, uv=uv.to(dtype),
                          w=torch.ones(ci.shape[0], dtype=dtype))
    return prob, cams, pts


def _autograd_terms(cams9, X, uv):
    """r (O,2), Jc (O,2,9), Jl (O,2,3) by autograd of bal.project, in
    float64."""
    cams9, X, uv = cams9.double(), X.double(), uv.double()
    r = bal.project(cams9, X) - uv
    Jc = torch.autograd.functional.jacobian(
        lambda c: bal.project(c, X).sum(0), cams9).permute(1, 0, 2)
    Jl = torch.autograd.functional.jacobian(
        lambda x: bal.project(cams9, x).sum(0), X).permute(1, 0, 2)
    return r, Jc, Jl


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


@pytest.mark.parametrize("rot", ["ring", "small", "near-pi"])
def test_projection_and_jacobians_match_autograd(rot):
    """The port's terms and the reference's against autograd, float64:
    ring cameras, rotations below the series' thresholds (|w|^2 < 1e-2
    and < 1e-8) and near pi."""
    p, _, _ = bal_problem(1, dtype=torch.float64)
    cams = p.cams.clone()
    if rot == "small":
        cams[:, :3] *= torch.logspace(-5, -1.2, cams.shape[0],
                                      dtype=torch.float64)[:, None]
    elif rot == "near-pi":
        cams[:, :3] *= (3.1 / torch.linalg.norm(cams[:, :3], dim=-1))[:, None]
    c9, X = cams[p.cam_idx], p.points[p.lm_idx]
    c9 = c9.clone()
    # keep every point in front of its camera
    P = (se3.exp_so3(c9[:, :3]) @ X[:, :, None])[:, :, 0]
    c9[:, 5] = torch.minimum(c9[:, 5], -P[:, 2] - 5.0)
    want = _autograd_terms(c9, X, p.uv)
    got = bal_obs.obs_terms(c9, X, p.uv)
    for a, b in zip(got, want):
        assert _rel(a, b) <= JAC_TOL
    assert _rel(ref.project(c9, X), bal.project(c9, X)) <= JAC_TOL
    for a, b in zip(ref.jacobians(c9, X), want[1:]):
        assert _rel(a, b) <= JAC_TOL


def _order(p):
    return cuda_kernels.SchurOrder(p.cam_idx.long(), p.lm_idx.long())


@pytest.mark.parametrize("seed", [3, 4])
def test_d9_schur_and_cg_twins_match_einsums(seed):
    """Both halves of the product at D = 9 (no row held) and the PCG's
    start and step, against plain float64 einsums."""
    p, _, _ = bal_problem(seed)
    C, L = p.cams.shape[0], p.points.shape[0]
    g = torch.Generator().manual_seed(seed)
    W = torch.randn(p.uv.shape[0], 9, 3, generator=g)
    hinv = torch.randn(L, 3, 3, generator=g)
    hcc = torch.randn(C, 9, 9, generator=g)
    x, b = torch.randn(C, 9, generator=g), torch.randn(C, 9, generator=g)
    a = torch.randn(L, 3, generator=g)
    order = _order(p)
    ci, li = order.cam_idx, order.lm_idx
    W64, x64 = W.double(), x.double()
    s = seg_sum(L, li, torch.einsum("oij,oi->oj", W64, x64[ci]))
    v_want = torch.einsum("lij,lj->li", hinv.double(), a.double() - s)
    v = cuda_kernels.ba_schur_landmarks_plain(W, hinv, order, x=x, a=a)
    assert _rel(v, v_want) <= TWIN_TOL
    y = seg_sum(C, ci, torch.einsum("oij,oj->oi", W64, v.double()[li]))
    out = cuda_kernels.ba_schur_cameras_plain(W, v, order, hcc=hcc, x=x)
    assert _rel(out, torch.einsum("cij,cj->ci", hcc.double(), x64) - y) \
        <= TWIN_TOL
    rhs = cuda_kernels.ba_schur_cameras_plain(W, v, order, b=b)
    assert _rel(rhs, b.double() - y) <= TWIN_TOL
    # At D = 6 (the stereo rig) row 0 is the gauge; at D = 9 none is.
    held = cuda_kernels.ba_schur_cameras_plain(W[:, :6].contiguous(), v,
                                               order, b=b[:, :6].contiguous())
    assert bool((held[0] == 0).all())
    assert _rel(held[1:], (b.double() - y)[1:, :6]) <= TWIN_TOL
    minv = torch.randn(C, 9, 9, generator=g)
    minv = minv @ minv.transpose(1, 2)
    pz, rz = cuda_kernels.ba_cg_start_plain(b, minv)
    z = torch.einsum("cij,cj->ci", minv.double(), b.double())
    assert _rel(pz, z) <= TWIN_TOL
    assert abs(float(rz) - float(torch.sum(b.double() * z))) <= \
        TWIN_TOL * float(torch.sum(b.double().abs() * z.abs()))
    ap = torch.randn(C, 9, generator=g)
    xn, rn, pn, rzn = cuda_kernels.ba_cg_step_plain(pz, ap, x, b, minv, rz)
    alpha = rz.double() / torch.sum(pz.double() * ap.double())
    r_want = b.double() - alpha * ap.double()
    assert _rel(xn, x64 + alpha * pz.double()) <= TWIN_TOL
    assert _rel(rn, r_want) <= TWIN_TOL
    z = torch.einsum("cij,cj->ci", minv.double(), r_want)
    beta = torch.sum(r_want * z) / rz.double()
    assert _rel(pn, z + beta * pz.double()) <= 10 * TWIN_TOL


@pytest.mark.parametrize("padded", [True, False],
                         ids=["padded", "unpadded"])
def test_bal_obs_twins_match_einsums(padded):
    """The three launches' twins (`ops/bal_obs.py`) against the blocks of
    autograd's Jacobians summed in float64, with or without padding rows
    of weight zero; the cost twin equals the cameras twin's cost to the
    bit, and the truncated cost is the full one; a cut is refused (BAL's
    model cuts no observation)."""
    p, _, _ = bal_problem(5)
    if padded:
        w = p.w.clone()
        w[::17] = 0.0
        p = p._replace(w=w)
    delta = 2.0
    obs = bal_obs.cameras_plain(p, (), _order(p), None, None, delta)
    hll, bl = bal_obs.landmarks_plain(p, (), _order(p), None, delta)
    full, trunc = bal_obs.cost_plain(p, (), _order(p), None, delta)
    assert same_bits((full, trunc), (obs.full, obs.trunc))
    assert same_bits(obs.full, obs.trunc)
    cut2 = torch.tensor(16.0 * 16.0)
    with pytest.raises(ValueError, match="no outlier cut"):
        bal_obs.cameras_plain(p, (), _order(p), cut2, None, delta)
    with pytest.raises(ValueError, match="no outlier cut"):
        bal_obs.landmarks_plain(p, (), _order(p), cut2, delta)
    r, Jc, Jl = _autograd_terms(p.cams[p.cam_idx], p.points[p.lm_idx], p.uv)
    r2 = torch.sum(r * r, dim=-1)
    hw = ref.huber_weights(r2, delta)
    wt = p.w.double() * hw
    C, L = p.cams.shape[0], p.points.shape[0]
    ci, li = p.cam_idx, p.lm_idx
    w3 = wt[:, None, None]
    want = {
        "W": torch.einsum("oai,oaj->oij", Jc, Jl) * w3,
        "hcc": seg_sum(C, ci, torch.einsum("oai,oaj->oij", Jc, Jc) * w3),
        "bc": -seg_sum(C, ci, torch.einsum("oai,oa->oi", Jc,
                                           r * wt[:, None])),
        "hll": seg_sum(L, li, torch.einsum("oai,oaj->oij", Jl, Jl) * w3),
        "bl": -seg_sum(L, li, torch.einsum("oai,oa->oi", Jl,
                                           r * wt[:, None]))}
    got = {"W": obs.W, "hcc": obs.hcc, "bc": obs.bc, "hll": hll, "bl": bl}
    for k in want:
        assert _rel(got[k], want[k]) <= TWIN_TOL, k
    assert abs(float(full) - float(torch.sum(p.w.double() * hw * r2))) <= \
        TWIN_TOL * float(full)
    assert int(obs.n_kept) == int((wt > 0).sum())
    assert bool((obs.W[p.w == 0] == 0).all())


@pytest.mark.parametrize("seed", [7, 8])
def test_one_lm_step_matches_the_plain_reference(seed):
    p, _, _ = bal_problem(seed)
    lam = torch.tensor(CFG.lm_lambda0)
    (cams, points, _), row = ba.lm_step(p, (), CFG, p.cams, p.points, lam,
                                        torch.tensor(0), model=ba.BAL)
    rc, rp, rlam, accept = ref.step(p.cams, p.points, p.cam_idx, p.lm_idx,
                                    p.uv, p.w, CFG_DICT, CFG.lm_lambda0)
    assert accept and bool(row[3])
    for got, want, start in ((cams, rc, p.cams), (points, rp, p.points)):
        assert _rel(got - start, want - start) <= STEP_TOL


def _centres(cams):
    R = se3.exp_so3(cams[:, :3].double())
    return -(R.transpose(1, 2) @ cams[:, 3:6].double()[:, :, None])[:, :, 0]


def _aligned_gap(a, b):
    """max |s R a + t - b| over rows, after the least-squares similarity
    (Umeyama) of a onto b."""
    ma, mb = a.mean(0), b.mean(0)
    A, B = a - ma, b - mb
    U, S, Vt = torch.linalg.svd(B.T @ A)
    d = torch.ones(3, dtype=a.dtype)
    d[2] = torch.sign(torch.det(U @ Vt))
    R = U @ torch.diag(d) @ Vt
    s = (S * d).sum() / (A * A).sum()
    return float(torch.linalg.norm(s * A @ R.T + mb - b, dim=-1).max())


@pytest.mark.parametrize("seed", [11, 12])
def test_pass_matches_the_plain_reference(seed):
    """15 LM iterations at BAConfig()'s settings: the full cost, and the
    camera centres after a similarity onto the reference's over the
    scene's depth (~35 m)."""
    p, _, _ = bal_problem(seed, n_cams=16)
    out, cost, trace = bal.bal_adjust(p, CFG), None, None
    out, cost = out
    rc, rp, rcost, accepted = ref.lm(p.cams, p.points, p.cam_idx, p.lm_idx,
                                     p.uv, p.w, CFG_DICT)
    assert sum(accepted) >= CFG.lm_iters // 2
    assert abs(float(cost) - float(rcost)) <= COST_TOL * float(rcost)
    start = float(ref.full_cost(p.cams, p.points, p.cam_idx, p.lm_idx, p.uv,
                                p.w, CFG.huber_delta))
    assert float(rcost) < 0.5 * start
    assert _aligned_gap(_centres(out.cams), _centres(rc)) <= CAM_TOL * 35.0


def test_benchmark_reference_copy_equals_the_tests_reference():
    """`benchmark/reference/bal_ref.py` gives the reference's bits on one
    problem (three LM iterations)."""
    sys.path.insert(0, ROOT)
    from benchmark.reference import bal_ref
    p, _, _ = bal_problem(13)
    cfg = dict(CFG_DICT, lm_iters=3)
    args = (p.cams, p.points, p.cam_idx, p.lm_idx, p.uv, p.w, cfg)
    assert same_bits(ref.lm(*args)[:3], bal_ref.lm(*args)[:3])


def test_bal_adjust_runs_the_shared_graphs(emulated_graphs,  # noqa: F811
                                           fresh_graphs):  # noqa: F811
    """`bal_adjust` replays `bal_lm[C,L,O]` lm_iters times and
    `bal_cost[C,L,O]` once, kind "ba", and equals the eager call to the
    bit."""
    p, _, _ = bal_problem(14)
    cfg = BAConfig(lm_iters=3, cg_iters=10)
    graphed = bal.bal_adjust(p, cfg)
    eager = bal.bal_adjust(p, cfg, graphs=False)
    assert same_bits(graphed, eager)
    size = f"[{p.cams.shape[0]},{p.points.shape[0]},{p.uv.shape[0]}]"
    names = {k[1] for k in fresh_graphs.of("ba")}
    assert names == {"bal_lm" + size, "bal_cost" + size}
    base = by_base(fresh_graphs, "ba")
    assert base["bal_lm"][0].replays == cfg.lm_iters - 1
    assert not bool(torch.equal(graphed[0].cams, p.cams))


def test_load_bal_round_trip_and_cli(tmp_path, capsys):
    """A BAL file written here reads back (`export.load_bal`, numpy in
    bulk) to the values written, and `slam-torch bal` refines it on the
    CPU and writes a file that reads back with a lower cost."""
    from slam1_tpu_torch import cli
    from slam1_tpu_torch.utils import export
    p, _, _ = bal_problem(15, n_cams=6, n_pts=60)
    path = tmp_path / "problem.txt"
    export.write_bal(str(path), p.cams.double().numpy(),
                     p.points.double().numpy(), p.cam_idx.numpy(),
                     p.lm_idx.numpy(), p.uv.double().numpy())
    d = export.load_bal(str(path))
    np.testing.assert_array_equal(d["cam_idx"], p.cam_idx.numpy())
    np.testing.assert_array_equal(d["lm_idx"], p.lm_idx.numpy())
    for k, v in (("uv", p.uv), ("cameras", p.cams), ("points", p.points)):
        np.testing.assert_allclose(d[k], v.double().numpy(), rtol=1e-12,
                                   atol=1e-9)
    out = tmp_path / "refined.txt"
    assert cli.main(["bal", str(path), "--out", str(out), "--device",
                     "cpu", "--iters", "5", "--trace",
                     str(tmp_path / "trace")]) == 0
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert {"host:bal.load", "host:bal.pass"} <= set(spans["spans"])
    assert spans["counters"]["kernel_launches"]["bal_obs"] == 0    # CPU
    q = bal.from_bal_dict(export.load_bal(str(out)), device="cpu")
    before = ref.full_cost(p.cams, p.points, p.cam_idx, p.lm_idx, p.uv,
                           p.w, CFG.huber_delta)
    after = ref.full_cost(q.cams, q.points, q.cam_idx, q.lm_idx, q.uv,
                          q.w, CFG.huber_delta)
    assert float(after) < 0.7 * float(before)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["cameras"] == 6 and line["observations"] == p.uv.shape[0]
    assert abs(line["final_cost"] - float(after)) <= 1e-3 * float(after)
