"""The sharded solvers as the reference runs them: on a card under NCCL
`distributed_bundle_adjust` replays `dba_lm` (one `dist_lm_step`) per
LM iteration and `dba_cost`, `optimize_sharded` replays `dpg_gn` (one
`dist_gn_step`) per Gauss-Newton iteration and `dpg_cost`, collectives
inside; on the CPU and under gloo both run eagerly.

On the CPU the graphs cannot be captured, so:
  - the rule that picks the graphs (`graphs.graphed` with the mesh)
    reads only the device and the backend, and on the CPU nothing is
    captured;
  - the four graphs' functions read nothing back to the host, on a world
    of one (in-process store);
  - in four spawned gloo ranks at lm = 1, 2 and 4, through eagerly
    emulated graphs (`torch_graph_helpers.emulate_graphs`), the graphed
    solvers equal `graphs=False` to the bit on every rank (BA with and
    without the graduated cut and with the trace; the pose graph with
    loop edges across blocks and a live count that differs per rank),
    capture once per key and only replay after, and count the same
    collectives in `mesh.comm`.
tests/test_torch_dist.py holds the eager solvers to the reference;
tests/test_torch_kernels_cuda.py runs the real graphs under NCCL on the
card.
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from slam1_tpu_torch import parallel
from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.parallel import dist_ba, dist_pgo
from slam1_tpu_torch.parallel import mesh as mesh_mod
from slam1_tpu_torch.utils import graphs, synthetic
from torch_dist_ranks import run_ranks
from torch_graph_helpers import HostReads
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
LMS = (1, 2, 4)
LM_ITERS, CG_ITERS = 4, 12
PGO_N, PGO_F = 48, 64     # live poses, rows (padded)


def ba_inputs():
    prob, _, _, cam = synthetic.ba_problem(0, n_cams=5, n_pts=80,
                                           px_noise=0.3, n_outliers=12,
                                           device="cpu")
    return prob, cam


def pgo_inputs():
    """A two-lap loop of PGO_N poses (noisy odometry, loop edges between
    the laps, across the blocks of lm = 2 and 4) padded to PGO_F rows."""
    n, f = PGO_N, PGO_F
    rng = np.random.default_rng(3)
    gt = synthetic.make_trajectory(n, "loop2", 1.0, device="cpu")
    noise = torch.as_tensor(rng.normal(0, [2e-3] * 3 + [2e-2] * 3,
                                       (n - 1, 6)), dtype=torch.float32)
    z = se3.inverse(gt[:-1]) @ gt[1:] @ se3.exp_se3(noise)
    est = [torch.eye(4)]
    for k in range(n - 1):
        est.append(est[-1] @ z[k])
    poses = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    poses[:n] = torch.stack(est).numpy()
    zz = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    zz[:n - 1] = z.numpy()
    w = np.zeros(f, np.float32)
    w[:n - 1] = 1.0
    li = np.array([2, 10, 20])
    lj = li + n // 2
    le_z = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    le_z[:3] = (se3.inverse(gt[li]) @ gt[lj]).numpy()
    return dict(poses=poses, z=zz, w=w,
                le_i=np.array([*li, 0], np.int32),
                le_j=np.array([*lj, 0], np.int32), le_z=le_z,
                le_w=np.array([1000.0] * 3 + [0.0], np.float32),
                iters=3, cg_iters=CG_ITERS, n_live=n)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    prob, cam = ba_inputs()
    inputs = dict(ba={k: v.numpy() for k, v in prob._asdict().items()},
                  cam=[x.numpy() for x in cam], pgo=pgo_inputs(), lms=LMS,
                  lm_iters=LM_ITERS, cg_iters=CG_ITERS)
    return run_ranks(WORLD, ("dist_graphs",), {"dist_graphs": inputs},
                     tmp_path_factory.mktemp("ranks"))


def _bits(x):
    x = np.asarray(x)
    return x.dtype, x.shape, x.tobytes()


RUNS = [("ba", lm, cut) for lm in LMS for cut in ("cut", "nocut")] + [
    ("pgo", lm, None) for lm in LMS]


def _runs(o, solver, lm, cut):
    name = f"{solver}{lm}" + (f"_{cut}" if cut else "")
    return [o[f"{name}_{run}"] for run in ("eager", "graphed", "replayed")]


@pytest.mark.parametrize("solver,lm,cut", RUNS)
def test_emulated_graphs_equal_eager_to_the_bit(ranks, solver, lm, cut):
    """Every rank: the capturing call and the replaying call equal
    graphs=False to the bit, every output; the ranks of one lm group
    agree on them."""
    for r, rank in enumerate(ranks):
        eager, graphed, replayed = _runs(rank["dist_graphs"], solver, lm,
                                         cut)
        for key, value in eager.items():
            if key == "comm":
                continue
            for other in (graphed, replayed):
                assert _bits(other[key]) == _bits(value), (r, key)
        assert np.all(np.isfinite(eager["cost"]))
    first = _runs(ranks[0]["dist_graphs"], solver, lm, cut)[0]
    for rank in ranks[1:]:
        mine = _runs(rank["dist_graphs"], solver, lm, cut)[0]
        assert _bits(mine["poses"]) == _bits(first["poses"])


@pytest.mark.parametrize("solver,lm,cut", RUNS)
def test_emulated_graphs_count_the_eager_collectives(ranks, solver, lm,
                                                     cut):
    """mesh.comm after a graphed call (capturing or replaying) equals its
    totals after the eager call; at lm > 1 the pose graph's halo runs
    point-to-point sends inside the graphs."""
    for rank in ranks:
        eager, graphed, replayed = _runs(rank["dist_graphs"], solver, lm,
                                         cut)
        assert graphed["comm"] == eager["comm"]
        assert replayed["comm"] == eager["comm"]
        assert eager["comm"]["all_reduce_calls"] > 0
        if solver == "pgo":
            assert (eager["comm"]["p2p_calls"] > 0) == (lm > 1)


@pytest.mark.parametrize("lm", LMS)
def test_emulated_graphs_capture_once_per_key(ranks, lm):
    """One graph per key (a dba_lm and a dba_cost for each of two BA
    configs, one dpg_gn and one dpg_cost), each captured at the first
    graphed call and replayed after: dba_lm /
    dpg_gn once per iteration but the capture's, dba_cost / dpg_cost
    once."""
    iters = pgo_inputs()["iters"]
    for rank in ranks:
        o = rank["dist_graphs"]
        assert o[f"ba{lm}_graphs"] == {
            "dba_lm": [(True, 2 * LM_ITERS - 1)] * 2,
            "dba_cost": [(True, 1)] * 2}
        assert o[f"pgo{lm}_graphs"] == {"dpg_gn": [(True, 2 * iters - 1)],
                                        "dpg_cost": [(True, 1)]}


def test_capturable_reads_the_backend_and_the_device():
    """Graphs only for a card's tensors under NCCL: gloo (ranks sharing a
    card, or the CPU) always runs eagerly."""
    card = types.SimpleNamespace(is_cuda=True)
    cpu = torch.zeros(1)
    for backend, x, want in (("nccl", card, True), ("gloo", card, False),
                             ("nccl", cpu, False), ("gloo", cpu, False)):
        mesh = types.SimpleNamespace(backend=backend)
        assert graphs.graphed(x, mesh) is want
        assert graphs.graphed(x, mesh, wanted=False) is False


@pytest.fixture
def world_of_one():
    """A gloo world of one on the CPU (in-process store) and its mesh;
    the graphs are dropped and the group destroyed after the test."""
    mesh_mod.init_multihost(device="cpu")
    try:
        yield mesh_mod.make_mesh(lm_axis=1, device="cpu")
    finally:
        parallel.clear_graphs()
        dist.destroy_process_group()


def _dba_carry(mesh, cfg):
    prob, cam = ba_inputs()
    sp, _ = dist_ba.partition_problem(prob, 1)
    return dist_ba._dist_lm_carry(dist_ba._local_problem(mesh, sp), cam,
                                  cfg, True)


def _dpg_carry():
    g = pgo_inputs()
    le_w = _t(g["le_w"])
    edges = dist_pgo._block_edges(
        _t(g["z"]), _t(g["w"]), _t(g["le_i"]).long(), _t(g["le_j"]).long(),
        _t(g["le_z"]), le_w, 0)
    return dist_pgo._PGOCarry(_t(g["poses"]), edges), g


@pytest.mark.parametrize("graph", ["dba_lm", "dba_cost", "dpg_gn",
                                   "dpg_cost"])
def test_graph_functions_read_nothing_on_the_host(world_of_one, graph):
    """What each graph captures makes no host read and no tensor from
    host data (the chain twins' live count is an int here)."""
    mesh = world_of_one
    cfg = BAConfig(lm_iters=LM_ITERS, cg_iters=CG_ITERS)
    if graph.startswith("dba"):
        carry = _dba_carry(mesh, cfg)
        fn = (dist_ba._graphed_dist_lm if graph == "dba_lm"
              else dist_ba._graphed_dist_end)(mesh, cfg)
    else:
        carry, g = _dpg_carry()
        fn = (dist_pgo._graphed_gn(mesh, "lm", CG_ITERS, 1e-4, g["n_live"])
              if graph == "dpg_gn" else dist_pgo._graphed_cost(mesh, "lm"))
    with HostReads() as rec:
        new, out = fn(carry)
    assert rec.ops == []
    assert all(torch.isfinite(x).all() for x in (new.poses, *out))


def test_cpu_tensors_run_eagerly(world_of_one):
    """With graphs=True (the default) on CPU tensors both solvers run
    eagerly: nothing is captured or cached."""
    mesh = world_of_one
    prob, cam = ba_inputs()
    sp, _ = dist_ba.partition_problem(prob, 1)
    g = pgo_inputs()
    dist_ba.distributed_bundle_adjust(
        sp, cam, BAConfig(lm_iters=1, cg_iters=2), mesh)
    dist_pgo.optimize_sharded(*[_t(g[k]) for k in (
        "poses", "z", "w", "le_i", "le_j", "le_z", "le_w")], mesh=mesh,
        iters=1, cg_iters=2)
    assert not graphs.GRAPHS.of("dist_ba") and not graphs.GRAPHS.of(
        "dist_pgo")
