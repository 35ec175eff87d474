"""`slam-torch ba <traj.npy>` and the standalone solvers as the reference
runs them: a float64 trajectory accepted as the reference accepts it,
the chain preconditioner at any length, and on the card
`posegraph.optimize` and `ba.bundle_adjust` as replays of captured CUDA
graphs (`pg_gn` x iters and `pg_cost`; `ba_lm` x lm_iters and
`ba_cost`), kept in the graph registry by what each function reads.

On the CPU the graphs cannot be captured, so:
  - a float64 trajectory through the port's `ba` equals the reference's
    output on the same file within tests/test_torch_cli.py's 1e-4, and
    both write float32;
  - the four graphs' functions read nothing back to the host (but the
    plain chain twin's read of a device live count);
  - through eagerly emulated graphs `optimize` (n_live None, an int, a
    tensor) and `bundle_adjust` (dense and CG paths, with and without
    the trace) equal `graphs=False` to the bit, return nothing of the
    graphs' own, capture once per key and only replay after;
  - the plain chain twins at 9000 poses, past the 8533 rows the kernel
    holds in shared memory, equal the reference's `_chain_sqrt_solve`
    within tests/test_torch_kernel_redesign.py's 1e-4 of max |x|: the
    algebra the kernel's device-memory path must match.
tests/test_torch_kernels_cuda.py runs the kernel and the real graphs on
the card.
"""

import json

import numpy as np
import pytest
import torch

from slam1_tpu import cli as jcli
from slam1_tpu_torch import cli
from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import ba as tba
from slam1_tpu_torch.models import posegraph as tpg
from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.utils import synthetic, tree
from test_torch_cli import run_cli
from test_torch_kernel_redesign import _check_chain
from torch_graph_helpers import HostReads, by_base, one_each, same_bits
from torch_graph_helpers import emulated_graphs, fresh_graphs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

F, N_LIVE = 48, 40           # pose rows, poses the edges touch
ITERS, CG_ITERS = 3, 20
BA_CFG = BAConfig(lm_iters=4, cg_iters=20)
BA_CAMS = {"direct": 6, "cg": tba.DIRECT_MAX_CAMS + 4}


def _pool_storages(graphs) -> set:
    """The storages of every static state, input and output leaf."""
    out = set()
    for g in graphs:
        for x in g._state + g._inputs + tree.flatten(g._out):
            if x is not None:        # an emulated capture keeps no `out`
                out.add(x.untyped_storage().data_ptr())
    return out


def _storages(tensors) -> set:
    return {x.untyped_storage().data_ptr() for x in tensors}


# ------------------------------------------- F1: a float64 trajectory

def test_float64_trajectory_gives_the_reference_result(tmp_path, capsys):
    """np.save of a float64 array is what a user script writes: the port
    makes the graph in float32 as the reference's jnp.asarray does."""
    rng = np.random.default_rng(7)
    gt = synthetic.make_trajectory(20, "arc", 1.0, device="cpu").numpy()
    noisy = gt.astype(np.float64)
    noisy[:, :3, 3] += rng.normal(0, 0.02, (20, 3))
    assert noisy.dtype == np.float64
    traj = str(tmp_path / "t64.npy")
    np.save(traj, noisy)
    res = run_cli(capsys, ["ba", traj, "--device", "cpu", "--out",
                           str(tmp_path / "t.npy")])
    assert jcli.main(["ba", traj, "--out", str(tmp_path / "j.npy")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == want["frames"] == 20
    assert abs(res["final_cost"] - want["final_cost"]) <= 1e-4 * max(
        1.0, abs(want["final_cost"]))
    port, ref = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(port, ref, atol=1e-4)


# ------------------------------------------- the chain past 8533 poses

@pytest.mark.parametrize("n_live", [8534, 9000])
def test_chain_twins_at_9000_poses_match_jax(n_live):
    ops = synthetic.chain_inputs(9000, n_live, n_live)
    x = _check_chain(*ops, n_live)
    assert torch.equal(x[n_live:], ops[2][n_live:, None] * ops[3][n_live:])


# ------------------------------------------------ the standalone graphs

def _pose_graph(f=F, n_live=N_LIVE, loops=((2, 30), (5, 36)), seed=0):
    """A circle of n_live poses chained from drifting odometry in f rows
    (identity past n_live, whose chain edges are disabled) with loop
    edges at weight 100 to the true relative poses."""
    rng = np.random.default_rng(seed)
    yaw = 2 * np.pi / n_live
    step = se3.exp_se3(torch.tensor([0.0, 0.0, 1.0, 0.0, yaw, 0.0]))
    truth = [torch.eye(4)]
    for _ in range(n_live - 1):
        truth.append(truth[-1] @ step)
    truth = torch.stack(truth)
    noise = torch.as_tensor(rng.normal(0, [2e-3] * 3 + [1e-2] * 3,
                                       (f - 1, 6)), dtype=torch.float32)
    z = se3.exp_se3(noise)
    z[:n_live - 1] = (se3.inverse(truth[:-1]) @ truth[1:]) @ z[:n_live - 1]
    poses = [torch.eye(4)]
    for k in range(n_live - 1):
        poses.append(poses[-1] @ z[k])
    poses = torch.cat([torch.stack(poses),
                       torch.eye(4).repeat(f - n_live, 1, 1)])
    li = torch.tensor([i for i, _ in loops])
    lj = torch.tensor([j for _, j in loops])
    ei = torch.arange(f - 1)
    w = (ei < n_live - 1).to(torch.float32)
    return tpg.PoseGraph(
        poses=poses, ei=torch.cat([ei, li]), ej=torch.cat([ei + 1, lj]),
        z=torch.cat([z, se3.inverse(truth[li]) @ truth[lj]]),
        w=torch.cat([w, torch.full((len(loops),), 100.0)]))


LIVES = {"none": None, "int": N_LIVE,
         "tensor": torch.tensor(N_LIVE, dtype=torch.int32)}


@pytest.mark.parametrize("live", list(LIVES))
def test_pose_graph_programs_read_nothing_back(live):
    graph = _pose_graph()
    n_live = LIVES[live]
    gn = tpg._graphed_gn(CG_ITERS, 1e-4, True, n_live)
    args = (n_live,) if live == "tensor" else ()
    with HostReads() as rec:
        poses, out = gn(graph.poses, graph, *args)
    # the plain chain twin (and only it) reads a device live count, once
    # per application of the preconditioner
    want = (["aten._local_scalar_dense.default"] * (CG_ITERS + 1)
            if live == "tensor" else [])
    assert rec.ops == want and out == ()
    with HostReads() as rec:
        same, total = tpg._graphed_cost(poses, graph)
    assert rec.ops == [] and same is poses and total.dim() == 0


@pytest.mark.parametrize("case", list(BA_CAMS))
def test_ba_programs_read_nothing_back(case):
    prob, _, _, cam = synthetic.ba_problem(1, n_cams=BA_CAMS[case],
                                           n_outliers=5, device="cpu")
    carry = tba._lm_carry(prob, cam, BA_CFG, True)
    with HostReads() as rec:
        carry, out = tba._graphed_ba_lm(BA_CFG)(carry)
    assert rec.ops == [] and out == () and int(carry.t) == 1
    with HostReads() as rec:
        same, cost = tba._graphed_ba_cost(BA_CFG)(carry)
    assert rec.ops == [] and same is carry and cost.dim() == 0


@pytest.mark.parametrize("live", list(LIVES))
def test_optimize_graphs_equal_eager(emulated_graphs,  # noqa: F811
                                     fresh_graphs, live):
    graph = _pose_graph()
    kw = dict(iters=ITERS, cg_iters=CG_ITERS, n_live=LIVES[live])
    before = tuple(x.clone() for x in graph)
    eager = tpg.optimize(graph, graphs=False, **kw)
    graphed = tpg.optimize(graph, **kw)
    assert same_bits(eager, graphed)
    assert float((graphed[0] - graph.poses).abs().max()) > 1e-3
    assert same_bits(before, tuple(graph))
    cache = fresh_graphs.of("posegraph")
    gn = one_each(fresh_graphs, "posegraph")["pg_gn"]
    assert sorted(one_each(fresh_graphs, "posegraph")) == ["pg_cost",
                                                            "pg_gn"]
    assert gn.name == f"pg_gn[{F},{graph.ei.shape[0]}]"
    assert gn.graph == "emulated" and gn.replays == ITERS - 1
    assert not _storages(graphed) & _pool_storages(cache.values())
    # iters=0 is the final cost alone, at the graph's own poses
    poses0, cost0 = tpg.optimize(graph, iters=0)
    assert poses0 is graph.poses
    assert same_bits(cost0, tpg.optimize(graph, iters=0, graphs=False)[1])


def test_optimize_graphs_cached_by_key(emulated_graphs,  # noqa: F811
                                       fresh_graphs):
    cache = fresh_graphs.of("posegraph")
    graph = _pose_graph()
    live = LIVES["tensor"]
    kw = dict(iters=ITERS, cg_iters=CG_ITERS, n_live=live)
    first = tpg.optimize(graph, **kw)
    kept = tuple(x.clone() for x in first)
    gn = one_each(fresh_graphs, "posegraph")["pg_gn"]
    # the same key, other values: replays only
    moved = graph._replace(poses=first[0])
    second = tpg.optimize(moved, **kw)
    assert len(cache) == 2 and gn.replays == 2 * ITERS - 1
    assert same_bits(second, tpg.optimize(moved, graphs=False, **kw))
    assert same_bits(kept, first)
    # another live count as a tensor is an input of the same graph
    tpg.optimize(graph, **{**kw, "n_live": torch.tensor(N_LIVE - 3,
                                                        dtype=torch.int32)})
    assert len(cache) == 2 and gn.replays == 3 * ITERS - 1
    # another F, E, cg_iters, damping or live count built in: a pg_gn of
    # its own (and a pg_cost where the shapes differ)
    tpg.optimize(_pose_graph(f=F + 8), **kw)
    assert len(cache) == 4
    tpg.optimize(_pose_graph(loops=((2, 30), (5, 36), (8, 38))), **kw)
    assert len(cache) == 6
    tpg.optimize(graph, **{**kw, "cg_iters": CG_ITERS + 1})
    assert len(cache) == 7
    tpg.optimize(graph, damping=2e-4, **kw)
    assert len(cache) == 8
    tpg.optimize(graph, **{**kw, "n_live": N_LIVE})
    assert len(cache) == 9
    assert gn.replays == 3 * ITERS - 1
    for g in cache.values():
        assert g.graph == "emulated"


def _ba_call(prob, cam, trace, **kw):
    return tba.bundle_adjust(prob, cam, BA_CFG, return_trace=trace, **kw)


@pytest.mark.parametrize("trace", [True, False], ids=["trace", "no-trace"])
@pytest.mark.parametrize("case", list(BA_CAMS))
def test_bundle_adjust_graphs_equal_eager(emulated_graphs,  # noqa: F811
                                          fresh_graphs, case, trace):
    prob, _, _, cam = synthetic.ba_problem(0, n_cams=BA_CAMS[case],
                                           px_noise=0.3, n_outliers=8,
                                           device="cpu")
    before = tuple(x.clone() for x in prob)
    eager = _ba_call(prob, cam, trace, graphs=False)
    graphed = _ba_call(prob, cam, trace)
    assert same_bits(eager, graphed)
    assert float((graphed[0].poses - prob.poses).abs().max()) > 1e-4
    assert same_bits(before, tuple(prob))
    graphs = one_each(fresh_graphs, "ba")
    assert sorted(graphs) == ["ba_cost", "ba_lm"]
    assert graphs["ba_lm"].replays == BA_CFG.lm_iters - 1
    assert graphs["ba_cost"].replays == 0
    c, l, o = prob.poses.shape[0], prob.points.shape[0], prob.uv.shape[0]
    assert graphs["ba_lm"].name == f"ba_lm[{c},{l},{o}]"
    # what it returns is not the graphs' own; the problem's other
    # leaves are the input's
    new = graphed[0]
    assert new.uv is prob.uv and new.cam_idx is prob.cam_idx
    kept = tree.flatten(((new.poses, new.points), graphed[1:]))
    assert not _storages(kept) & _pool_storages(graphs.values())


def test_bundle_adjust_graphs_cached_by_key(emulated_graphs,  # noqa: F811
                                            fresh_graphs):
    cache = fresh_graphs.of("ba")
    prob, _, _, cam = synthetic.ba_problem(0, n_cams=BA_CAMS["cg"],
                                           n_outliers=8, device="cpu")
    first = _ba_call(prob, cam, True)
    kept = tuple(x.clone() for x in tree.flatten(first))
    graphs = one_each(fresh_graphs, "ba")
    # the same key: replays only
    moved = prob._replace(points=first[0].points)
    second = _ba_call(moved, cam, True)
    assert len(cache) == 2
    assert graphs["ba_lm"].replays == 2 * BA_CFG.lm_iters - 1
    assert graphs["ba_cost"].replays == 1
    assert same_bits(second, _ba_call(moved, cam, True, graphs=False))
    assert same_bits(kept, tuple(tree.flatten(first)))
    # another camera goes into the same graphs, and its values are read
    cam2 = type(cam)(*[v * 1.01 for v in cam])
    third = _ba_call(prob, cam2, True)
    assert len(cache) == 2
    assert same_bits(third, _ba_call(prob, cam2, True, graphs=False))
    assert not same_bits(third, first)
    # another problem shape, trace or config: graphs of their own
    other, _, _, _ = synthetic.ba_problem(0, n_cams=BA_CAMS["cg"] + 1,
                                          n_outliers=8, device="cpu")
    _ba_call(other, cam, True)
    _ba_call(prob, cam, False)
    tba.bundle_adjust(prob, cam, BAConfig(lm_iters=3, cg_iters=20))
    assert len(cache) == 8
    assert graphs["ba_lm"].replays == 3 * BA_CFG.lm_iters - 1
    for g in by_base(fresh_graphs, "ba")["ba_lm"][1:]:
        assert g.graph == "emulated"
