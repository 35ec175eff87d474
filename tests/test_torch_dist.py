"""The port's distributed layer (`slam1_tpu_torch/parallel/`) against the
JAX package's on the conftest's 8 virtual CPU devices.

The port's ranks are four `torch.multiprocessing` processes over gloo,
spawned once for the file (`torch_dist_ranks.run_ranks`), which run
every case in one process group: the mesh at each lm axis, the
data-parallel `detect_batch` split over a batch axis of 2, the
landmark-sharded BA at lm = 4 and the sharded pose graph at lm = 4.

Tolerances:
  - partitioners: integers equal and floats equal to the bit;
  - distributed BA (`tests/test_ba.make_ba_problem(n_cams=5, n_pts=80)`,
    6 LM iterations, 30 CG): poses within 1e-4 of the reference's
    distributed BA, costs within 1e-3 relative (of max(cost, 1));
  - sharded PGO (`tests/test_dist_pgo._noisy_chain`, 64 poses): one
    Gauss-Newton step of 3 PCG iterations within 1e-4 m and 1e-4
    relative of the reference; at the reference test's own budget (10
    Gauss-Newton steps of 48 PCG iterations) float32 PCG amplifies the
    two packages' last-bit differences to millimetres or centimetres
    along the graph's soft mode (the reference's own test says pose
    parity between differently inexact solvers is not meaningful there),
    so the loop-closing run is held within 0.03 m and 10% of cost, and
    to the reference test's property: the loop closes;
  - sharded PGO on a 300-pose two-lap loop padded to 512 rows, whose
    live chain straddles three of the four blocks, at the live
    relaxation's budget (5 Gauss-Newton steps of 64 PCG iterations):
    cost within 10% of the reference's sharded cost (both end far above
    the single-device cost: each block's chain preconditioner leaves
    the coupling across blocks and the loop edges to PCG).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import BAConfig as JBAConfig
from slam1_tpu.models import posegraph as jposegraph
from slam1_tpu.parallel import dist_ba as jdba
from slam1_tpu.parallel import dist_pgo as jdpgo
from slam1_tpu.parallel import mesh as jmesh
from slam1_tpu_torch.config import BAConfig, tiny_config
from slam1_tpu_torch.models.ba import bundle_adjust
from slam1_tpu_torch.ops.detector import detect_batch
from slam1_tpu_torch.ops import se3 as tse3
from slam1_tpu_torch.parallel import dist_ba as tdba
from slam1_tpu_torch.utils import interop
from test_ba import make_ba_problem, pose_err
from test_dist_pgo import _noisy_chain
from torch_dist_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
LM_ITERS, CG_ITERS = 6, 30
F = 64
# name: (chain key, loop edges, GN iterations, CG iterations)
GRAPHS = {"step": (0, "one", 1, 3), "closing": (3, "closing", 10, 48)}
SPLIT_N, SPLIT_F = 300, 512


def ba_inputs():
    prob, T_true, _, cam = make_ba_problem(n_cams=5, n_pts=80, px_noise=0.0)
    return prob, T_true, cam


def graph(name):
    key, loops, iters, cg_iters = GRAPHS[name]
    gt, est, z, w = _noisy_chain(jax.random.PRNGKey(key), F)
    if loops == "one":
        le_i = np.array([0, 0, 0, 0], np.int32)
        le_j = np.array([F - 1, 0, 0, 0], np.int32)
        le_z = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
        le_z[0] = np.linalg.inv(gt[0]) @ gt[F - 1]
        le_w = np.array([5.0, 0, 0, 0], np.float32)
    else:
        le_i = np.array([0, 0], np.int32)
        le_j = np.array([F - 1, 0], np.int32)
        le_z = np.stack([np.linalg.inv(gt[0]) @ gt[F - 1],
                         np.eye(4, dtype=np.float32)])
        le_w = np.array([10.0, 0.0], np.float32)
    return gt, dict(poses=est, z=z, w=w, le_i=le_i, le_j=le_j, le_z=le_z,
                    le_w=le_w, iters=iters, cg_iters=cg_iters)


def split_graph():
    """A two-lap loop of SPLIT_N poses (noisy odometry, four loop edges
    between the laps at 1000 times the odometry weight) padded to SPLIT_F
    rows, as a SLAM run's live relaxation sizes it."""
    from slam1_tpu_torch.utils.synthetic import make_trajectory
    n, f = SPLIT_N, SPLIT_F
    rng = np.random.default_rng(4)
    gt = make_trajectory(n, "loop2", 1.0, device="cpu")
    noise = torch.as_tensor(rng.normal(0, [2e-3] * 3 + [2e-2] * 3,
                                       (n - 1, 6)), dtype=torch.float32)
    z = tse3.inverse(gt[:-1]) @ gt[1:] @ tse3.exp_se3(noise)
    est = [torch.eye(4)]
    for k in range(n - 1):
        est.append(est[-1] @ z[k])
    poses = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    poses[:n] = torch.stack(est).numpy()
    zz = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    zz[:n - 1] = z.numpy()
    w = np.zeros(f, np.float32)
    w[:n - 1] = 1.0
    li = np.array([5, 30, 60, 100])
    lj = li + n // 2
    le_z = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    le_z[:4] = (tse3.inverse(gt[li]) @ gt[lj]).numpy()
    pad = np.zeros(4, np.int32)
    return dict(poses=poses, z=zz, w=w,
                le_i=np.concatenate([li, pad]).astype(np.int32),
                le_j=np.concatenate([lj, pad]).astype(np.int32), le_z=le_z,
                le_w=np.array([1000.0] * 4 + [0.0] * 4, np.float32),
                iters=5, cg_iters=64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    prob, _, cam = ba_inputs()
    ba = {k: np.asarray(v) for k, v in prob._asdict().items()}
    ba.update(cam=[np.asarray(x) for x in cam], lm=WORLD, lm_iters=LM_ITERS,
              cg_iters=CG_ITERS)
    pgo = {name: graph(name)[1] for name in GRAPHS}
    pgo.update(lm=WORLD, graphs=list(GRAPHS) + ["split"],
               split=split_graph())
    imgs = (np.random.default_rng(0).uniform(0, 1, (4, 64, 128)) > 0.995
            ).astype(np.float32)
    out = run_ranks(WORLD, ("mesh", "ba", "pgo"),
                    {"mesh": {"imgs": imgs}, "ba": ba, "pgo": pgo},
                    tmp_path_factory.mktemp("ranks"))
    return out, imgs


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(8, lm_axis=WORLD)


def test_make_mesh_shapes(ranks):
    out, _ = ranks
    for r, o in enumerate(out):
        m = o["mesh"]
        np.testing.assert_array_equal(m["mesh_None"], [1, 4, 0, r])
        np.testing.assert_array_equal(m["mesh_4"], [1, 4, 0, r])
        np.testing.assert_array_equal(m["mesh_1"], [4, 1, r, 0])
        np.testing.assert_array_equal(m["mesh_2"], [2, 2, r // 2, r % 2])
    # The reference's default axis choice on 8 and 2 devices.
    assert dict(jmesh.make_mesh(8).shape) == {"batch": 2, "lm": 4}
    assert dict(jmesh.make_mesh(2).shape) == {"batch": 1, "lm": 2}


def test_dp_detect_batch_split_equals_unsplit(ranks):
    """Each batch row of the 2 x 2 mesh detects its half of the batch:
    the halves, in batch order, are the unsplit batch's features."""
    out, imgs = ranks
    whole = detect_batch(torch.as_tensor(imgs), tiny_config().detector)
    halves = {int(o["mesh"]["batch_index"]): o["mesh"] for o in out}
    assert sorted(halves) == [0, 1]
    for k, v in whole._asdict().items():
        got = np.concatenate([halves[b][f"feat_{k}"] for b in (0, 1)])
        np.testing.assert_array_equal(got, v.numpy())
    assert whole.mask.sum() > 0


def _port_problem(prob):
    return interop.ba_problem(jax.device_get(prob), "cpu")


def _assert_same(tp, jp, names):
    for name in names:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_problem_matches_jax(n_shards):
    prob, _, _ = ba_inputs()
    jp, jorig = jdba.partition_problem(prob, n_shards)
    tp, torig = tdba.partition_problem(_port_problem(prob), n_shards)
    _assert_same(tp, jp, ("points", "cam_idx", "lm_idx", "uv", "w", "ur",
                          "wr"))
    np.testing.assert_array_equal(torig.numpy(), np.asarray(jorig))


@pytest.mark.parametrize("n_shards,obs_per_shard", [(2, 0), (4, 0), (4, 60)])
def test_partition_problem_device_matches_jax(n_shards, obs_per_shard):
    """Same layout, same drop count (the (4, 60) case overflows)."""
    prob, _, _ = ba_inputs()
    jp, jorig, jdrop = jdba.partition_problem_device(prob, n_shards,
                                                     obs_per_shard)
    tp, torig, tdrop = tdba.partition_problem_device(_port_problem(prob),
                                                     n_shards, obs_per_shard)
    _assert_same(tp, jp, ("points", "cam_idx", "lm_idx", "uv", "w", "ur",
                          "wr"))
    np.testing.assert_array_equal(torig.numpy(), np.asarray(jorig))
    assert int(tdrop) == int(jdrop)
    assert (int(tdrop) > 0) == (obs_per_shard == 60)


def test_distributed_ba_matches_jax(ranks, jax_mesh):
    out, _ = ranks
    prob, T_true, cam = ba_inputs()
    sp, _ = jdba.partition_problem(prob, WORLD)
    jo, jcost, jtrace = jdba.distributed_bundle_adjust(
        sp, cam, JBAConfig(lm_iters=LM_ITERS, cg_iters=CG_ITERS), jax_mesh,
        return_trace=True)
    jcost = float(jcost)
    for o in out:
        b = o["ba"]
        np.testing.assert_array_equal(b["shape"], [1, WORLD])
        np.testing.assert_allclose(b["poses"], np.asarray(jo.poses),
                                   rtol=0, atol=1e-4)
        assert abs(float(b["cost"]) - jcost) <= 1e-3 * max(1.0, jcost)
        np.testing.assert_allclose(b["trace"], np.asarray(jtrace), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_array_equal(b["poses"], out[0]["ba"]["poses"])
        np.testing.assert_array_equal(b["points"], out[0]["ba"]["points"])
    assert pose_err(jnp.asarray(out[0]["ba"]["poses"]), T_true) < 1e-2


def test_distributed_ba_matches_single_device(ranks):
    """As tests/test_dist.py holds the reference: the sharded solver and
    the port's single-device bundle_adjust land on equivalent poses."""
    out, _ = ranks
    prob, T_true, cam = ba_inputs()
    single, cost = bundle_adjust(_port_problem(prob),
                                 interop.camera(jax.device_get(cam), "cpu"),
                                 BAConfig(lm_iters=LM_ITERS,
                                          cg_iters=CG_ITERS))
    err_d = pose_err(jnp.asarray(out[0]["ba"]["poses"]), T_true)
    err_s = pose_err(jnp.asarray(single.poses.numpy()), T_true)
    assert err_d < 1e-2
    assert abs(err_d - err_s) < 5e-3
    assert np.isfinite(float(cost))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_pgo_matches_jax(ranks, jax_mesh, name):
    out, _ = ranks
    gt, g = graph(name)
    jp, jc = jdpgo.optimize_sharded(
        *[jnp.asarray(g[k]) for k in ("poses", "z", "w", "le_i", "le_j",
                                      "le_z", "le_w")],
        mesh=jax_mesh, axis="lm", iters=g["iters"], cg_iters=g["cg_iters"])
    jp, jc = np.asarray(jp), float(jc)
    tol_t, tol_c = (1e-4, 1e-4) if name == "step" else (3e-2, 0.1)
    for o in out:
        tp = o["pgo"][name + "_poses"]
        tc = float(o["pgo"][name + "_cost"])
        assert np.abs(tp[:, :3, 3] - jp[:, :3, 3]).max() <= tol_t
        assert abs(tc - jc) <= tol_c * jc
        np.testing.assert_array_equal(tp, out[0]["pgo"][name + "_poses"])
    if name == "closing":
        tp = out[0]["pgo"]["closing_poses"]
        before = np.linalg.norm(g["poses"][F - 1, :3, 3] - gt[F - 1, :3, 3])
        after = np.linalg.norm(tp[F - 1, :3, 3] - gt[F - 1, :3, 3])
        assert after < before
    # every rank exchanged halos with its neighbours
    assert int(out[0]["pgo"]["p2p_calls"]) > 0


def test_sharded_pgo_split_chain_matches_jax(ranks, jax_mesh):
    out, _ = ranks
    g = split_graph()
    args = [jnp.asarray(g[k]) for k in ("poses", "z", "w", "le_i", "le_j",
                                        "le_z", "le_w")]
    _, jc = jdpgo.optimize_sharded(*args, mesh=jax_mesh, axis="lm",
                                   iters=g["iters"], cg_iters=g["cg_iters"])
    f = SPLIT_F
    ei = jnp.arange(f - 1)
    _, jc1 = jposegraph.optimize(jposegraph.PoseGraph(
        poses=args[0], ei=jnp.concatenate([ei, args[3]]),
        ej=jnp.concatenate([ei + 1, args[4]]),
        z=jnp.concatenate([args[1][:f - 1], args[5]]),
        w=jnp.concatenate([args[2][:f - 1], args[6]])),
        iters=g["iters"], cg_iters=g["cg_iters"])
    jc, jc1 = float(jc), float(jc1)
    for o in out:
        tc = float(o["pgo"]["split_cost"])
        assert abs(tc - jc) <= 0.1 * jc
        np.testing.assert_array_equal(o["pgo"]["split_poses"],
                                      out[0]["pgo"]["split_poses"])
    # The reference's own property on this graph, which the port keeps:
    # split over blocks, the live relaxation ends far above one block.
    assert jc > 2.0 * jc1
