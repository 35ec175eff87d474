"""The pose-graph relaxation as the reference runs it: `_pgo_step` as
three backend programs that `SlamSystem` replays on the card as CUDA
graphs over the step graph's state, `pgo_build[bucket]` (the pose graph
from the state and the loop edges), `pgo_gn[bucket]` (one Gauss-Newton
iteration, replayed once per iteration, with the live count a 0-d int32
device tensor) and `pgo_apply[bucket]` (the state's write-back).

On the CPU the graphs cannot be captured, so:
  - the programs read nothing back to the host but the plain chain
    twin's read of the live count (the CPU twin loops over the live
    rows; the kernel reads the count on the device);
  - the programs, `pgo_gn` called `iters` times, equal the JAX package's
    `_pgo_step` on the same numpy inputs at the 512-row bucket of
    `tiny_config()`, within tests/test_torch_loop_pgo.py's PGO
    tolerances (positions 1e-4 m, rotations 1e-5 rad, the cost 1e-4
    relative) and tests/test_torch_ba_pipeline.py's rule for map points
    (1e-5 times the squared distance, at least 10 m);
  - the plain chain twins give the same bits for the live count as an
    int and as a 0-d int32 tensor;
  - a `SlamSystem` whose graphs are emulated eagerly ends equal to the
    bit to `graphs=False` over live PGOs, `detect_loops_offline`'s and
    `finalize`'s.
tests/test_torch_kernels_cuda.py replays the real graphs on the card.
"""

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.models import pipeline as jpipe
from slam1_tpu.ops import se3 as jse3
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline as tpipe
from slam1_tpu_torch.ops import cuda_kernels
from slam1_tpu_torch.utils import synthetic
from test_torch_ba_pipeline import _assert_close
from test_torch_loop_pgo import rot_angle, t
from torch_graph_helpers import HostReads, same_bits
from torch_graph_helpers import emulated_graphs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

BUCKET = 512                 # tiny_config's trajectory capacity
N_LIVE = 40                  # frames of the loop
KF_ROWS, MAP_ROWS = 64, 256
LIVE_ITERS = max(tiny_config().ba.pg_iters // 5, 3)
CG_ITERS = tiny_config().ba.cg_iters


class Kf(NamedTuple):
    frame_of_row: torch.Tensor
    poses: torch.Tensor


class Map(NamedTuple):
    xyz: torch.Tensor
    last_frame: torch.Tensor
    valid: torch.Tensor


class State(NamedTuple):
    """The leaves of a SlamState that the PGO programs read or write."""
    traj: torch.Tensor
    rel: torch.Tensor
    rel_mask: torch.Tensor
    frame: torch.Tensor
    T_w_cam: torch.Tensor
    kf: Kf
    map: Map


def _inputs(seed=0, drift=0.02):
    """A circle of N_LIVE frames chained from odometry with a forward
    drift, in a BUCKET-row trajectory (identity past the loop), one loop
    edge (0, N_LIVE - 1) at weight 100 in MAX_LOOP_EDGES slots, keyframes
    at every other frame and a map of random points: numpy arrays."""
    rng = np.random.default_rng(seed)
    yaw = 2 * np.pi / N_LIVE
    xi = np.array([0.0, 0.0, 1.0, 0.0, yaw, 0.0], np.float32)
    true_step = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    xi_odo = np.tile(xi, (N_LIVE - 1, 1))
    xi_odo[:, 2] += drift
    z = np.asarray(jse3.exp_se3(jnp.asarray(xi_odo)))
    traj = np.tile(np.eye(4, dtype=np.float32), (BUCKET, 1, 1))
    truth = [np.eye(4, dtype=np.float32)]
    for i in range(N_LIVE - 1):
        traj[i + 1] = traj[i] @ z[i]
        truth.append(truth[-1] @ true_step)
    rel = np.zeros((BUCKET, 6), np.float32)
    rel[1:N_LIVE] = -xi_odo                  # rel[f] = log(T_f_{f-1})
    rel_mask = np.zeros(BUCKET, bool)
    rel_mask[1:N_LIVE] = True
    cap = tpipe.MAX_LOOP_EDGES
    le_i, le_j = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    le_z = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    le_w = np.zeros(cap, np.float32)
    le_j[0] = N_LIVE - 1
    le_z[0] = np.linalg.inv(truth[0]) @ truth[-1]
    le_w[0] = 100.0
    kf_frames = np.full(KF_ROWS, -1, np.int32)
    kf_frames[:N_LIVE // 2] = np.arange(0, N_LIVE, 2)
    kf_poses = np.tile(np.eye(4, dtype=np.float32), (KF_ROWS, 1, 1))
    kf_poses[:N_LIVE // 2] = traj[kf_frames[:N_LIVE // 2]]
    map_xyz = rng.uniform(-20, 20, (MAP_ROWS, 3)).astype(np.float32)
    map_last = rng.integers(-1, N_LIVE, MAP_ROWS).astype(np.int32)
    map_valid = rng.random(MAP_ROWS) > 0.3
    return dict(traj=traj, rel=rel, rel_mask=rel_mask, le_i=le_i, le_j=le_j,
                le_z=le_z, le_w=le_w, kf_frames=kf_frames, kf_poses=kf_poses,
                map_xyz=map_xyz, map_last=map_last, map_valid=map_valid,
                frame=np.int32(N_LIVE - 1))


def _state(d):
    return State(traj=t(d["traj"]), rel=t(d["rel"]), rel_mask=t(d["rel_mask"]),
                 frame=t(d["frame"]), T_w_cam=t(d["traj"][N_LIVE - 1]),
                 kf=Kf(t(d["kf_frames"]), t(d["kf_poses"])),
                 map=Map(t(d["map_xyz"]), t(d["map_last"]),
                         t(d["map_valid"])))


def _loop_edges(d):
    return [t(d[k]) for k in ("le_i", "le_j", "le_z", "le_w")]


def _live(n=N_LIVE):
    return torch.tensor(n, dtype=torch.int32)


def _run_programs(state, d, iters):
    """The three programs as SlamSystem._pgo chains them -> (state,
    cost)."""
    _, graph = tpipe._graphed_pgo_build(BUCKET)(state, *_loop_edges(d))
    gn = tpipe._graphed_pgo_gn(CG_ITERS)
    for _ in range(iters):
        _, graph = gn(state, graph, _live())
    return tpipe._graphed_pgo_apply(BUCKET)(state, graph)


# ------------------------------------------------------------ host reads

def test_pgo_programs_read_nothing_back_but_the_twins_live_count(
        monkeypatch):
    d = _inputs()
    state, edges = _state(d), _loop_edges(d)
    with HostReads() as rec:
        _, graph = tpipe._graphed_pgo_build(BUCKET)(state, *edges)
    assert rec.ops == []
    sweeps = []
    twin = cuda_kernels.chain_sweep_plain

    def counted(*args):
        sweeps.append(args[4])
        return twin(*args)
    monkeypatch.setattr(cuda_kernels, "chain_sweep_plain", counted)
    live = _live()
    with HostReads() as rec:
        _, graph = tpipe._graphed_pgo_gn(CG_ITERS)(state, graph, live)
    # one sweep per application of the preconditioner, each handed the
    # device scalar, whose value the twin (and only it) reads
    assert len(sweeps) == CG_ITERS + 1
    assert all(n is live for n in sweeps)
    assert rec.ops == ["aten._local_scalar_dense.default"] * len(sweeps)
    with HostReads() as rec:
        tpipe._graphed_pgo_apply(BUCKET)(state, graph)
    assert rec.ops == []


# ------------------------------------------------ the programs against JAX

@pytest.mark.parametrize("iters", [LIVE_ITERS, 12])
def test_pgo_programs_with_a_device_n_live_match_jax(iters):
    d = _inputs()
    j = jpipe._pgo_step(
        *[jnp.asarray(d[k]) for k in ("traj", "rel", "rel_mask",
                                      "kf_frames")],
        jnp.asarray(d["kf_frames"] >= 0),
        *[jnp.asarray(d[k].astype(np.int32)) for k in ("le_i", "le_j")],
        *[jnp.asarray(d[k]) for k in ("le_z", "le_w", "frame", "map_xyz",
                                      "map_last", "map_valid")],
        bucket=BUCKET, iters=iters, cg_iters=CG_ITERS)
    j_traj, j_tw, j_kf, j_kf_mask, j_xyz, j_cost = [np.asarray(x) for x in j]
    j_kf = np.where(j_kf_mask[:, None, None], j_kf, d["kf_poses"])
    state_in = _state(d)
    out, cost = _run_programs(state_in, d, iters)
    assert cost.dim() == 0
    assert abs(float(cost) - float(j_cost)) <= 1e-4 * max(1.0, float(j_cost))
    for name, a, b in (("traj", out.traj, j_traj),
                       ("T_w_cam", out.T_w_cam[None], j_tw[None]),
                       ("kf.poses", out.kf.poses, j_kf)):
        a = a.numpy()
        np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], rtol=0,
                                   atol=1e-4, err_msg=name)
        assert max(rot_angle(x[:3, :3], y[:3, :3])
                   for x, y in zip(a, b)) <= 1e-5, name
    _assert_close("map.xyz", out.map.xyz, j_xyz)
    # the loop moved the trajectory and the map, and only what it writes
    assert float((out.traj - state_in.traj).abs().max()) > 1e-2
    assert not torch.equal(out.map.xyz, state_in.map.xyz)
    for name in ("rel", "rel_mask", "frame"):
        assert getattr(out, name) is getattr(state_in, name)
    assert out.kf.frame_of_row is state_in.kf.frame_of_row
    # _pgo_step runs the same ops: the same bits
    ref = tpipe._pgo_step(
        state_in.traj, state_in.rel, state_in.rel_mask,
        state_in.kf.frame_of_row, *_loop_edges(d), state_in.frame,
        state_in.map.xyz, state_in.map.last_frame, state_in.map.valid,
        bucket=BUCKET, iters=iters, cg_iters=CG_ITERS, n_live=N_LIVE)
    assert same_bits((ref[0], ref[1], ref[3], ref[4]),
                     (out.traj, out.T_w_cam, out.map.xyz, cost))


# ------------------------------------------ the live count, int or tensor

@pytest.mark.parametrize("n_live", [1, 2, 13, 20])
def test_chain_twins_take_the_live_count_as_a_tensor(n_live):
    ops = synthetic.chain_inputs(24, n_live, n_live)
    as_int, as_tensor = n_live, _live(n_live)
    assert torch.equal(cuda_kernels.chain_prepare_plain(*ops[:2], as_int),
                       cuda_kernels.chain_prepare_plain(*ops[:2], as_tensor))
    for twin in (cuda_kernels.chain_sweep_plain,
                 cuda_kernels.chain_sweep_fused_plain):
        assert same_bits(twin(*ops, as_int), twin(*ops, as_tensor))


# ------------------------------------------------ SlamSystem, the programs

def _pgo_run(world, lefts, rights, cfg, graphed):
    """The 48-frame two-lap clip through SlamSystem in blocks of 8 (live
    PGOs on the loops the polls close), then `detect_loops_offline` before
    the last frames are drained (its sweep adds the edges of the second
    lap's end and relaxes), then `finalize`."""
    sys_ = tpipe.SlamSystem(world.cam, cfg, seed=2, bow_train_frame=8,
                            graphs=graphed)
    sys_.process(lefts[0], rights[0])
    for s in range(1, lefts.shape[0], 8):
        sys_.process_block(lefts[s:s + 8], rights[s:s + 8])
    live_runs = len(sys_.pgo_costs)
    added = sys_.detect_loops_offline(stride_kf=8)
    return sys_, sys_.finalize(), live_runs, added


def test_slam_system_pgo_graphs_equal_eager(emulated_graphs):
    cfg = tiny_config()
    # Accepted edges suppress others only within 8 frames, so that the
    # offline sweep finds edges the live polls did not take; 10
    # Gauss-Newton iterations for the offline and final relaxations (3
    # for the live ones) keep the CPU run short.
    cfg = cfg.replace(bow=dataclasses.replace(cfg.bow, rearm_frames=8),
                      ba=dataclasses.replace(cfg.ba, pg_iters=10))
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=48, n_points=1200,
                                 trajectory="loop2", speed=0.9,
                                 image_hw=(h, w), device="cpu")
    lefts, rights = synthetic.render_sequence(world, h, w)
    runs = {graphed: _pgo_run(world, lefts, rights, cfg, graphed)
            for graphed in (True, False)}
    (g, g_post, g_live, g_added), (e, e_post, e_live, e_added) = (
        runs[True], runs[False])
    assert (g_live, g_added) == (e_live, e_added)
    assert g_live >= 2 and g_added >= 1
    runs_all = len(g.pgo_costs)
    assert runs_all == len(e.pgo_costs) == g_live + 2
    names = ("pgo_build[512]", "pgo_gn[512]", "pgo_apply[512]")
    assert set(names) <= set(g.backend_graphs) and e.backend_graphs == {}
    gn = g.backend_graphs["pgo_gn[512]"]
    live_iters = max(cfg.ba.pg_iters // 5, 3)
    assert gn.replays == (g_live * live_iters + 2 * cfg.ba.pg_iters) - 1
    for name in names:
        graph = g.backend_graphs[name]
        assert graph.over is g.step_graph, name
        assert graph._state is g.step_graph._state, name
    np.testing.assert_array_equal(g_post, e_post)
    assert same_bits(g.state, e.state)
    assert g.metrics == e.metrics
    assert [(i, j, w) for i, j, _, w in g.loop_edges] == \
        [(i, j, w) for i, j, _, w in e.loop_edges]
    assert all(np.array_equal(a[2], b[2])
               for a, b in zip(g.loop_edges, e.loop_edges))
    assert [dataclasses.astuple(x) for x in g.loop_events] == \
        [dataclasses.astuple(x) for x in e.loop_events]
    assert len(g.ba_costs) == len(e.ba_costs) > 0
    assert torch.equal(torch.stack(g.ba_costs), torch.stack(e.ba_costs))
    assert len(g.pgo_costs) == runs_all
    assert same_bits(torch.stack(g.pgo_costs), torch.stack(e.pgo_costs))
