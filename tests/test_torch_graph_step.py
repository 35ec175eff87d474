"""The per-frame steps as the reference runs them: the frame index a
device scalar, culling, the trajectory write and the ring row decided on
the device, the draws made outside the step, and the step replayed as a
captured CUDA graph on the card (`slam1_tpu_torch/utils/graphs.py`).

On the CPU the graphs cannot be captured, so:
  - `_step_core` (frame as a 0-d tensor) is held to the JAX `slam_step`
    over 36 frames of `tiny_config()` with a lowered `cull_max_age` (the
    cull at frame 32 removes landmarks) and a 32-frame trajectory (the
    writes of frames 32-35 are dropped): integers and masks exactly,
    poses within 1e-3 m, the rows' chi^2 and reprojection error within
    1e-5 (the slice tests' tolerances);
  - both steps are checked to read nothing back to the host (what a
    capture needs), with a dispatch mode that records every operation
    that reads a tensor's value on the host or makes a tensor from host
    data;
  - `StepGraph`'s bookkeeping (which leaves `load` copies, the
    write-back of the step's new leaves) is held on plain tensors, and
    `SlamSystem` and `vo_block` run through a `StepGraph` whose capture
    and replay are emulated eagerly (the same static state, loads and
    write-backs) must equal their eager runs to the bit.
A test marked `cuda` replays the real graphs against eager steps where
there is a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import tiny_config as jtiny
from slam1_tpu.models import pipeline as jpipe
from slam1_tpu.utils.synthetic import make_world, render_sequence
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline as tpipe
from slam1_tpu_torch.models import vo
from slam1_tpu_torch.ops import pnp
from slam1_tpu_torch.utils import checkpoint, graphs, interop, synthetic, \
    tree
from torch_graph_helpers import HostReads, same_bits
from torch_graph_helpers import emulated_graphs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 36
MAX_FRAMES = 32          # trajectory capacity: frames 32-35 are dropped
CULL_MAX_AGE = 4         # the default 60 culls nothing in 36 frames


class ReplayDraws:
    """The reference's draws of `_init_state` and `slam_step`: its state
    key split per frame, recomputed with jax.random."""

    def __init__(self, seed=0):
        self.seed = seed
        self.key = None

    @staticmethod
    def _u(key, shape):
        return torch.as_tensor(np.array(jax.random.uniform(
            key, shape, minval=1e-9, maxval=1.0)))

    def init(self, n):
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(self.seed), 3)
        self.key = k1
        return self._u(k2, (n,)), self._u(k3, (n,))

    def step(self, k, n):
        self.key, k_pnp, k_bow, k_bow2 = jax.random.split(self.key, 4)
        return tpipe.StepDraws(self._u(k_pnp, (k, n)), self._u(k_bow, (n,)),
                               self._u(k_bow2, (n,)))


def _short(cfg):
    return cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, cull_max_age=CULL_MAX_AGE, max_frames=MAX_FRAMES))


@pytest.fixture(scope="module")
def stepped():
    """Both packages' steps over the loop clip, state by state."""
    jcfg, tcfg = _short(jtiny()), _short(tiny_config())
    h, w = jcfg.image.height, jcfg.image.width
    world = make_world(jax.random.PRNGKey(3), n_frames=N_FRAMES,
                       n_points=1200, trajectory="loop", speed=0.9,
                       image_hw=(h, w))
    lefts, rights = (np.array(a) for a in render_sequence(world, h, w))
    cam = interop.camera(jax.device_get(world.cam), "cpu")
    draws = ReplayDraws(0)
    js = jpipe._init_state(jnp.asarray(lefts[0]), jnp.asarray(rights[0]),
                           world.cam, jcfg, 0)
    ts = tpipe._init_state(torch.as_tensor(lefts[0]),
                           torch.as_tensor(rights[0]), cam, tcfg, draws)
    out = []
    for i in range(1, N_FRAMES):
        js, jrow, _ = jpipe.slam_step(js, jnp.asarray(lefts[i]),
                                      jnp.asarray(rights[i]), world.cam,
                                      jcfg)
        u = draws.step(tcfg.tracking.ransac_iters,
                       ts.prev_obs.mask.shape[0])
        ts, trow, _ = tpipe._step_core(ts, torch.as_tensor(lefts[i]),
                                       torch.as_tensor(rights[i]), cam,
                                       tcfg, u)
        jn = jax.device_get(js)
        out.append(dict(
            jrow=np.asarray(jrow), trow=trow.numpy().copy(),
            j_valid=np.asarray(jn.map.valid),
            j_cursor=int(jn.map.cursor), t=_snapshot(ts), j=jn))
    return out


def _snapshot(ts):
    return {k: v.clone() for k, v in dict(
        cursor=ts.map.cursor, count=ts.map.count, valid=ts.map.valid,
        hash_slot=ts.map.hash_slot, obs_count=ts.map.obs_count,
        prev_lm=ts.prev_lm, kf_n=ts.kf.n, frame=ts.frame,
        row_of_frame=ts.kf.row_of_frame, rel_mask=ts.rel_mask,
        last_kf_frame=ts.last_kf_frame, traj=ts.traj, rows=ts.rows,
        T_w_cam=ts.T_w_cam, db_mask=ts.bow.db_mask).items()}


def test_step_core_with_a_device_frame_matches_jax(stepped):
    exact_cols = (0, 1, 3, 4, 5, 6, 8, 9)     # flags, counts, frame
    for f, s in enumerate(stepped, start=1):
        np.testing.assert_array_equal(s["trow"][list(exact_cols)],
                                      s["jrow"][list(exact_cols)], err_msg=f)
        np.testing.assert_allclose(s["trow"], s["jrow"], rtol=1e-5,
                                   atol=1e-5, err_msg=str(f))
        t, j = s["t"], s["j"]
        assert t["frame"].dtype == torch.int32 and t["frame"].dim() == 0
        for name, ref in (("cursor", j.map.cursor), ("count", j.map.count),
                          ("valid", j.map.valid),
                          ("hash_slot", j.map.hash_slot),
                          ("obs_count", j.map.obs_count),
                          ("prev_lm", j.prev_lm), ("kf_n", j.kf.n),
                          ("frame", j.frame),
                          ("row_of_frame", j.kf.row_of_frame),
                          ("rel_mask", j.rel_mask),
                          ("last_kf_frame", j.last_kf_frame),
                          ("db_mask", j.bow.db_mask)):
            np.testing.assert_array_equal(t[name].numpy(), np.asarray(ref),
                                          err_msg=f"{name} at frame {f}")
        np.testing.assert_allclose(t["traj"].numpy(), np.asarray(j.traj),
                                   rtol=0, atol=1e-3, err_msg=str(f))
        np.testing.assert_allclose(t["T_w_cam"].numpy(),
                                   np.asarray(j.T_w_cam), rtol=0, atol=1e-3)
        np.testing.assert_allclose(t["rows"].numpy(), np.asarray(j.rows),
                                   rtol=1e-5, atol=1e-5, err_msg=str(f))


def test_the_cull_and_the_dropped_writes_happen(stepped):
    """The clip exercises what moved to the device: the cull of frame 32
    invalidates landmarks (none before it), and frames past the
    trajectory's end leave it as it was."""
    culled = [int(np.sum(~s["j_valid"][:s["j_cursor"]])) for s in stepped]
    assert culled[30] == 0 and culled[31] > 0        # frames 31 and 32
    last = stepped[-1]["t"]
    assert bool(last["rel_mask"][MAX_FRAMES - 1])
    assert int(last["frame"]) == N_FRAMES - 1 > MAX_FRAMES
    np.testing.assert_array_equal(last["traj"].numpy(),
                                  stepped[MAX_FRAMES - 2]["t"]["traj"].numpy())
    np.testing.assert_array_equal(
        last["rows"][N_FRAMES - 1].numpy(), stepped[-1]["trow"])


# ------------------------------------------------------------------ draws

@pytest.mark.parametrize("k,n", [(64, 256), (8, 1)])
def test_draws_made_outside_equal_ransac_draws(k, n):
    """Generated numbers depend on the count drawn, not the shape: the
    (K,N) draws made before a graph replay are the (1,K,N) draws
    ransac_pnp makes itself, and leave the generator where it does."""
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    inside = pnp.uniform((1, k, n), g1, "cpu")
    outside = pnp.draw_uniform(k, n, g2, "cpu")
    assert torch.equal(inside[0], outside)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_vo_step_with_outside_draws_equals_its_own_draws():
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(0, n_frames=3, n_points=1500,
                                 trajectory="arc", image_hw=(h, w),
                                 device="cpu")
    lefts, rights = synthetic.render_sequence(world, h, w)
    a = vo.init_state(lefts[0], rights[0], world.cam, cfg, seed=4)
    b = vo.init_state(lefts[0], rights[0], world.cam, cfg, seed=4)
    for i in (1, 2):
        a, ma = vo.vo_step(a, lefts[i], rights[i], world.cam, cfg)
        u = pnp.draw_uniform(cfg.tracking.ransac_iters,
                             b.prev_obs.mask.shape[0], b.generator, "cpu")
        b, mb = vo.vo_step(b, lefts[i], rights[i], world.cam, cfg, u=u)
        assert torch.equal(a.T_w_cam, b.T_w_cam)
        assert all(torch.equal(x, y) for x, y in zip(ma, mb))


# ------------------------------------------------------------ host reads

def test_the_steps_read_nothing_back_to_the_host():
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=4, n_points=1200,
                                 trajectory="loop", speed=0.9,
                                 image_hw=(h, w), device="cpu")
    lefts, rights = synthetic.render_sequence(world, h, w)
    draws = tpipe.DrawSource(0, "cpu")
    st = tpipe._init_state(lefts[0], rights[0], world.cam, cfg, draws)
    st, _, _ = tpipe.slam_step(st, lefts[1], rights[1], world.cam, cfg,
                               draws)
    u = draws.step(cfg.tracking.ransac_iters, st.prev_obs.mask.shape[0])
    with HostReads() as rec:
        tpipe._step_core(st, lefts[2], rights[2], world.cam, cfg, u)
    assert rec.ops == []
    vs = vo.init_state(lefts[0], rights[0], world.cam, cfg)
    u = pnp.draw_uniform(cfg.tracking.ransac_iters,
                         vs.prev_obs.mask.shape[0], vs.generator, "cpu")
    with HostReads() as rec:
        vo.vo_step(vs, lefts[1], rights[1], world.cam, cfg, u=u)
    assert rec.ops == []
    with HostReads() as rec:                 # the recorder sees reads
        bool(st.frame > 0)
    assert rec.ops == ["aten._local_scalar_dense.default"]


# ------------------------------------------------- StepGraph bookkeeping

def test_load_copies_only_rebound_leaves():
    static = [torch.zeros(3), torch.ones(2, 2),
              torch.zeros((), dtype=torch.int32)]
    assert graphs.load_leaves(static, list(static)) == 0
    new = torch.full((2, 2), 5.0)
    assert graphs.load_leaves(static, [static[0], new, static[2]]) == 1
    assert torch.equal(static[1], new) and static[1] is not new
    with pytest.raises(ValueError, match="does not fit"):
        graphs.load_leaves(static, [static[0], torch.ones(3, 2), static[2]])
    with pytest.raises(ValueError, match="does not fit"):
        graphs.load_leaves(static, [static[0], static[1],
                                    torch.zeros((), dtype=torch.int64)])
    with pytest.raises(ValueError):
        graphs.load_leaves(static, static[:2])


def test_write_back_reads_every_leaf_before_writing():
    """A new leaf that is another static leaf (a swap) or a view of one
    is copied from the values before the write-back."""
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    c = torch.arange(6.0).reshape(2, 3)
    static = [a, b, c]
    graphs._write_back(static, [b, a, c.flip(0)])
    assert a.tolist() == [10, 11, 12, 13] and b.tolist() == [0, 1, 2, 3]
    assert c.tolist() == [[3, 4, 5], [0, 1, 2]]
    with pytest.raises(ValueError, match="changed a state leaf"):
        graphs._write_back(static, [a, b, c.reshape(6)])


def test_tree_helpers_and_tensor_leaves():
    st = vo.VOMetrics(*[torch.tensor(i) for i in range(5)])
    leaves = tree.flatten((st, (torch.zeros(1),)))
    assert len(leaves) == 6
    back = tree.unflatten((st, (torch.zeros(1),)), iter(leaves))
    assert type(back[0]) is vo.VOMetrics and back[0].pnp_ok is leaves[4]
    with pytest.raises(TypeError, match="leaves are tensors"):
        graphs.StepGraph(lambda s: (s, None), "t")._capture((1,), ())
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.StepGraph(lambda s: (s, None), "t")._capture(
            (torch.zeros(1),), ())


def test_slam_system_through_a_step_graph_equals_eager(emulated_graphs,
                                                       tmp_path):
    """Local BA, BoW training, the live PGO, checkpoints and finalize all
    write state back between replays: the graphed system must carry
    them into the static state (StepGraph.load) and end equal."""
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=40, n_points=1200,
                                 trajectory="loop", speed=0.9,
                                 image_hw=(h, w), device="cpu")
    lefts, rights = synthetic.render_sequence(world, h, w)
    runs = {}
    for graphed in (True, False):
        run_cfg = cfg.replace(runtime=dataclasses.replace(
            cfg.runtime, checkpoint_every=16,
            checkpoint_dir=str(tmp_path / str(graphed))))
        sys_ = tpipe.SlamSystem(world.cam, run_cfg, seed=2,
                                bow_train_frame=8, graphs=graphed)
        sys_.process(lefts[0], rights[0])
        rows = [sys_.process(lefts[i], rights[i]) for i in range(1, 9)]
        for s in range(9, 40, 8):
            sys_.process_block(lefts[s:s + 8], rights[s:s + 8])
        runs[graphed] = (sys_, sys_.finalize(), rows)
    (g, g_post, g_rows), (e, e_post, e_rows) = runs[True], runs[False]
    assert g.step_graph is not None and e.step_graph is None
    assert g.step_graph.replays == 38 and g.step_graph.loaded > 0
    assert len(g.ba_costs) > 0 and g._bow_trained
    np.testing.assert_array_equal(g_post, e_post)
    assert same_bits(g.state, e.state)
    assert all(torch.equal(a, b) for a, b in zip(g_rows, e_rows))
    assert g.metrics == e.metrics
    assert [(i, j) for i, j, _, _ in g.loop_edges] == \
        [(i, j) for i, j, _, _ in e.loop_edges]
    assert torch.equal(torch.stack(g.ba_costs), torch.stack(e.ba_costs))


def test_vo_block_through_a_step_graph_equals_vo_steps(emulated_graphs):
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(0, n_frames=6, n_points=1500,
                                 trajectory="arc", image_hw=(h, w),
                                 device="cpu")
    lefts, rights = synthetic.render_sequence(world, h, w)
    a = vo.init_state(lefts[0], rights[0], world.cam, cfg, seed=1)
    poses, ms = [], []
    for i in range(1, 6):
        a, m = vo.vo_step(a, lefts[i], rights[i], world.cam, cfg)
        poses.append(a.T_w_cam)
        ms.append(m)
    b = vo.init_state(lefts[0], rights[0], world.cam, cfg, seed=1)
    b, b_poses, b_ms = vo.vo_block(b, lefts[1:3], rights[1:3], world.cam, cfg)
    b, b_poses2, b_ms2 = vo.vo_block(b, lefts[3:], rights[3:], world.cam,
                                     cfg)
    assert b.graph.replays == 4          # one capture, reused by both calls
    assert torch.equal(torch.stack(poses), torch.cat([b_poses, b_poses2]))
    for x, y, z in zip(zip(*ms), b_ms, b_ms2):
        assert torch.equal(torch.stack(x), torch.cat([y, z]))
    assert b.frame == a.frame == 5
    assert same_bits((a.T_w_cam, a.prev_obs, a.xi_vel),
                       (b.T_w_cam, b.prev_obs, b.xi_vel))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_checkpoint_keeps_the_frame_a_tensor(tmp_path):
    cam = synthetic.make_world(0, n_frames=2, n_points=10,
                               device="cpu").cam
    cfg = tiny_config()
    st = tpipe._template_state(cam, cfg)
    st = st._replace(frame=torch.full((), 37, dtype=torch.int32))
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, st)
    back = checkpoint.load(path, tpipe._template_state(cam, cfg))
    assert back.frame.dtype == torch.int32 and back.frame.dim() == 0
    assert int(back.frame) == 37
    assert same_bits(st, back)


# --------------------------------------------------------------- the card

@pytest.mark.cuda
def test_graph_replays_equal_eager_steps_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    from slam1_tpu_torch.ops import cuda_kernels
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=40, n_points=1200,
                                 trajectory="loop", speed=0.9,
                                 image_hw=(h, w), device="cuda")
    lefts, rights = synthetic.render_sequence(world, h, w)
    out = {}
    for graphed in (True, False):
        cuda_kernels.reset_launch_counts()
        sys_ = tpipe.SlamSystem(world.cam, cfg, seed=2, bow_train_frame=8,
                                graphs=graphed)
        sys_.process(lefts[0], rights[0])
        for s in range(1, 40, 8):
            sys_.process_block(lefts[s:s + 8], rights[s:s + 8])
        out[graphed] = (sys_, sys_.finalize(), cuda_kernels.launch_counts())
    (g, g_post, g_n), (e, e_post, e_n) = out[True], out[False]
    assert g.step_graph is not None and g.step_graph.replays == 38
    assert g_n == e_n
    np.testing.assert_array_equal(g_post, e_post)
    assert same_bits(g.state, e.state)
    a = vo.init_state(lefts[0], rights[0], world.cam, cfg, seed=1)
    poses = []
    for i in range(1, 8):
        a, _ = vo.vo_step(a, lefts[i], rights[i], world.cam, cfg)
        poses.append(a.T_w_cam)
    b = vo.init_state(lefts[0], rights[0], world.cam, cfg, seed=1)
    b, b_poses, _ = vo.vo_block(b, lefts[1:8], rights[1:8], world.cam, cfg)
    assert torch.equal(torch.stack(poses), b_poses)
