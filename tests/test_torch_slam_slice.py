"""The SLAM slice of the port (`SlamSystem` with local BA off) against
the JAX package's, on the loop clips of tests/test_pipeline.py.

Both sides run `tiny_config()` with `ba.local_every=0` (BA on is held
in tests/test_torch_slam_ba_slice.py) and `bow_train_frame=8`; the world is made by the JAX
package and carried across with `utils/interop.py`. The port draws from
`ReplayDraws`, which recomputes the reference's own key chain with
`jax.random`: the state key split per frame, `fold_in(seed, 999)` for
the vocabulary, and `fold_in(seed ^ 0x5a5a, ...)` per slate entry.

Tolerances: every drained metrics row identical in its integers and
flags, chi^2 and the reprojection error within 1e-5; the map's cursor,
valid, count and hash tables and every keyframe-store table identical
(but one descriptor bit, a rounding fact of the reference pinned by its
own test below) with the PGO-moved poses within 1e-3; loop events and
loop-edge pairs identical, their Z within 1e-4; the poses before and
after the final relaxation within 1e-3 m and 1e-4 rad.
"""

import copy
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
from slam1_tpu_torch.utils import interop
from slam1_tpu_torch.utils.evalmetrics import ate_rmse
from torch_threads import one_torch_thread  # noqa: F401


class ReplayDraws:
    """The reference's draws at every random site of SlamSystem."""

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

    def train(self, r):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), 999)
        return self._u(key, (r,))

    def slate(self, hit_frames, cand_frames, salt, k, n):
        base = jax.random.PRNGKey(self.seed ^ 0x5a5a)
        return torch.stack([
            self._u(jax.random.fold_in(
                base, (hf * 7919 + c * 31 + salt) & 0x7fffffff), (k, n))
            for hf, c in zip(hit_frames, cand_frames)])


def rot_angle(Ra, Rb):
    M = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    v = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v))))


def _run_both(trajectory, n_frames, n_points):
    jcfg = jtiny()
    jcfg = jcfg.replace(ba=dataclasses.replace(jcfg.ba, local_every=0))
    tcfg = tiny_config()
    tcfg = tcfg.replace(ba=dataclasses.replace(tcfg.ba, local_every=0))
    h, w = jcfg.image.height, jcfg.image.width
    world = make_world(jax.random.PRNGKey(3), n_frames=n_frames,
                       n_points=n_points, trajectory=trajectory, speed=0.9,
                       image_hw=(h, w))
    lefts, rights = (np.array(a) for a in render_sequence(world, h, w))

    js = jpipe.SlamSystem(world.cam, jcfg, bow_train_frame=8)
    for i in range(n_frames):
        js.process(jnp.asarray(lefts[i]), jnp.asarray(rights[i]))
    j_pre = js.poses()
    j_post = js.finalize()

    ts = tpipe.SlamSystem(interop.camera(jax.device_get(world.cam), "cpu"),
                          tcfg, bow_train_frame=8, draws=ReplayDraws(0))
    tl, tr = torch.as_tensor(lefts), torch.as_tensor(rights)
    ts.process(tl[0], tr[0])
    for i in range(1, n_frames):
        ts.process(tl[i], tr[i])
    t_pre = ts.poses()
    t_post = ts.finalize()
    return dict(world=world, js=js, ts=ts, j_pre=j_pre, j_post=j_post,
                t_pre=t_pre, t_post=t_post)


@pytest.fixture(scope="module")
def loop_clip():
    return _run_both("loop", 36, 1200)


def test_slice_metrics_rows_match_jax(loop_clip):
    js, ts = loop_clip["js"], loop_clip["ts"]
    assert len(ts.metrics) == len(js.metrics) == 35
    for a, b in zip(js.metrics, ts.metrics):
        for name in ("loop_hit", "loop_candidate", "is_kf", "kf_n",
                     "num_stereo", "num_inliers", "pnp_ok", "frame"):
            assert getattr(b, name) == getattr(a, name), (a.frame, name)
        assert abs(b.loop_chi2 - a.loop_chi2) <= 1e-5, a.frame
        assert abs(b.mean_reproj_err - a.mean_reproj_err) <= 1e-5, a.frame
        assert [c for c, _ in b.alt_cands] == [c for c, _ in a.alt_cands]
        np.testing.assert_allclose([v for _, v in b.alt_cands],
                                   [v for _, v in a.alt_cands], atol=1e-5)


def test_slice_map_and_keyframes_match_jax(loop_clip):
    jst, tst = loop_clip["js"].state, loop_clip["ts"].state
    for name in ("cursor", "valid", "count", "hash_slot"):
        np.testing.assert_array_equal(getattr(tst.map, name).numpy(),
                                      np.asarray(getattr(jst.map, name)),
                                      err_msg=name)
    for name in jst.kf._fields:
        a = np.asarray(getattr(jst.kf, name))
        b = getattr(tst.kf, name).numpy()
        if name == "desc":
            # One bit of frame 2's snapshot differs, a rounding fact of
            # the reference's jitted frontend (see the test below).
            assert np.argwhere(a != b).tolist() == [[2, 115, 10]]
            assert a[2, 115, 10] ^ b[2, 115, 10] == 1 << 7
        elif name == "poses":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_reference_rounding_fused_blur_flips_one_descriptor_bit():
    """Rounding fact of the reference: inside its jitted frontend XLA
    rounds a blurred sample 1 ulp away from the same blur run alone.
    On frame 2 of the loop clip two BRIEF samples of keypoint 42 are
    0.6784578 and 0.67845786 (1 ulp apart) in the standalone blur, which
    the port reproduces bit for bit, so the port's bit 87 is 1; the
    reference's frontend gives 0. Its own describe() on its own
    standalone blur gives the port's bit."""
    from slam1_tpu.models.frontend import stereo_frontend as jfront
    from slam1_tpu.ops import brief as jbrief
    from slam1_tpu.utils.synthetic import render_frame
    from slam1_tpu_torch.models.frontend import stereo_frontend as tfront
    cfg = jtiny()
    h, w = cfg.image.height, cfg.image.width
    world = make_world(jax.random.PRNGKey(3), n_frames=36, n_points=1200,
                       trajectory="loop", speed=0.9, image_hw=(h, w))
    left, right = (np.array(a) for a in render_frame(world, 2, h, w))
    fj, _ = jfront(jnp.asarray(left), jnp.asarray(right), world.cam, cfg)
    ft, _ = tfront(torch.as_tensor(left), torch.as_tensor(right),
                   interop.camera(jax.device_get(world.cam), "cpu"),
                   tiny_config())
    dj, dt = np.asarray(fj.desc), ft.desc.numpy()
    assert np.argwhere(dj != dt).tolist() == [[42, 10]]
    assert (dj[42, 10] >> 7) & 1 == 0 and (dt[42, 10] >> 7) & 1 == 1
    np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
    np.testing.assert_array_equal(ft.angle.numpy(), np.asarray(fj.angle))
    blurred = jbrief.gaussian_blur(jnp.asarray(left), cfg.detector.blur_sigma)
    alone = np.asarray(jbrief.describe(
        blurred, fj.xy[42:43], fj.angle[42:43],
        jnp.asarray(jbrief.make_pattern(cfg.detector.brief_pairs,
                                        cfg.detector.brief_radius,
                                        cfg.detector.pattern_seed))))
    assert (alone[0, 10] >> 7) & 1 == 1


def test_slice_loop_closure_matches_jax(loop_clip):
    js, ts = loop_clip["js"], loop_clip["ts"]
    assert [dataclasses.astuple(e)[:2] + dataclasses.astuple(e)[3:]
            for e in ts.loop_events] == \
        [dataclasses.astuple(e)[:2] + dataclasses.astuple(e)[3:]
         for e in js.loop_events]
    for a, b in zip(js.loop_events, ts.loop_events):
        assert abs(a.chi2 - b.chi2) <= 1e-5
    assert [(i, j) for i, j, _, _ in ts.loop_edges] == \
        [(i, j) for i, j, _, _ in js.loop_edges]
    for (_, _, Zj, wj), (_, _, Zt, wt) in zip(js.loop_edges, ts.loop_edges):
        np.testing.assert_allclose(Zt, Zj, rtol=0, atol=1e-4)
        assert wt == wj
    assert len(ts.loop_edges) >= 1


def test_slice_loop_edge_rows_match_jax(loop_clip):
    """The loop edges with keyframe-row endpoints (the pose-prior input
    of global BA): rows identical, Z within 1e-4."""
    jr = [np.asarray(a) for a in loop_clip["js"].loop_edge_rows()]
    tr = [a.numpy() for a in loop_clip["ts"].loop_edge_rows()]
    for k in (0, 1, 3):
        np.testing.assert_array_equal(tr[k], jr[k])
    np.testing.assert_allclose(tr[2], jr[2], rtol=0, atol=1e-4)
    assert (jr[3] > 0).sum() == len(loop_clip["ts"].loop_edges)


def _without_loops(system):
    """A shallow copy with no loop edges or events of its own and a list
    of relaxation costs of its own: the offline sweep below appends to
    those, and its relaxation replaces the state's tensors without
    writing into them."""
    c = copy.copy(system)
    c.loop_edges, c.loop_events, c._verifying = [], [], []
    if hasattr(c, "pgo_costs"):
        c.pgo_costs = list(system.pgo_costs)
    return c


def test_slice_offline_loop_sweep_matches_jax(loop_clip):
    """detect_loops_offline over the finished clip with the live loop
    edges taken away, so the sweep finds the loop again: its place
    queries, slates, accepted edges and final relaxation match the
    reference's."""
    js, ts = _without_loops(loop_clip["js"]), _without_loops(loop_clip["ts"])
    live_poses = loop_clip["ts"].poses().copy()
    added_j = js.detect_loops_offline(stride_kf=7)
    added_t = ts.detect_loops_offline(stride_kf=7)
    assert added_t == added_j >= 1
    assert [(e.frame, e.candidate, e.num_inliers, e.accepted)
            for e in ts.loop_events] == \
        [(e.frame, e.candidate, e.num_inliers, e.accepted)
         for e in js.loop_events]
    for a, b in zip(js.loop_events, ts.loop_events):
        assert abs(a.chi2 - b.chi2) <= 1e-5
    assert [(i, j) for i, j, _, _ in ts.loop_edges] == \
        [(i, j) for i, j, _, _ in js.loop_edges]
    for (_, _, Zj, _), (_, _, Zt, _) in zip(js.loop_edges, ts.loop_edges):
        np.testing.assert_allclose(Zt, Zj, rtol=0, atol=1e-4)
    pj, pt = js.poses(), ts.poses()
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0, atol=1e-3)
    assert max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(pj, pt)) <= 1e-4
    # the live systems keep their own edges
    assert len(loop_clip["ts"].loop_edges) == len(loop_clip["js"].loop_edges)
    np.testing.assert_array_equal(loop_clip["ts"].poses(), live_poses)


def test_slice_poses_match_jax(loop_clip):
    for pre_or_post in ("pre", "post"):
        pj, pt = loop_clip["j_" + pre_or_post], loop_clip["t_" + pre_or_post]
        assert pt.shape == pj.shape == (36, 4, 4)
        np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0,
                                   atol=1e-3)
        assert max(rot_angle(a[:3, :3], b[:3, :3])
                   for a, b in zip(pj, pt)) <= 1e-4


def test_slice_closes_the_loop_and_improves_ate(loop_clip):
    gt = np.asarray(loop_clip["world"].poses)
    ts = loop_clip["ts"]
    i, j, Z, _ = ts.loop_edges[0]
    Z_true = np.linalg.inv(gt[i]) @ gt[j]
    assert np.linalg.norm(Z[:3, 3] - Z_true[:3, 3]) < 0.2
    assert ate_rmse(loop_clip["t_post"], gt, align=False) < \
        ate_rmse(loop_clip["t_pre"], gt, align=False)


def test_slam_system_refuses_unported_options():
    """The three options construction used to refuse (local BA, the
    asynchronous drain, checkpoints) are ported: each constructs, and
    the only refusal left is a drain batch larger than the ring."""
    cam = interop.camera(jax.device_get(
        make_world(jax.random.PRNGKey(0), n_frames=2, n_points=10,
                   image_hw=(128, 256)).cam), device="cpu")
    cfg = tiny_config()
    assert tpipe.SlamSystem(cam, cfg).cfg.ba.local_every == 5
    lagged = tpipe.SlamSystem(cam, cfg.replace(bow=dataclasses.replace(
        cfg.bow, poll_lag_s=0.05)))
    assert lagged._async and lagged._pool is not None
    tpipe.SlamSystem(cam, cfg.replace(runtime=dataclasses.replace(
        cfg.runtime, checkpoint_every=8)))
    with pytest.raises(ValueError, match="poll_max_pending"):
        tpipe.SlamSystem(cam, cfg.replace(bow=dataclasses.replace(
            cfg.bow, poll_max_pending=tpipe.ROW_RING + 1)))


def test_slam_step_from_carried_state():
    """A reference SlamState after two frames, exported to numpy and
    carried into the port, takes the same next step as the reference."""
    cfg = jtiny()
    h, w = cfg.image.height, cfg.image.width
    world = make_world(jax.random.PRNGKey(3), n_frames=3, n_points=1200,
                       trajectory="loop", speed=0.9, image_hw=(h, w))
    lefts, rights = render_sequence(world, h, w)
    js = jpipe._init_state(lefts[0], rights[0], world.cam, cfg, 0)
    js, _, _ = jpipe.slam_step(js, lefts[1], rights[1], world.cam, cfg)
    key = js.key
    exported = jax.device_get(js)
    js2, jrow, _ = jpipe.slam_step(js, lefts[2], rights[2], world.cam, cfg)

    ts = interop.slam_state(exported._replace(key=None), device="cpu")
    draws = ReplayDraws(0)
    draws.key = key
    ts2, trow, _ = tpipe.slam_step(
        ts, torch.as_tensor(np.array(lefts[2])),
        torch.as_tensor(np.array(rights[2])),
        interop.camera(jax.device_get(world.cam), "cpu"), tiny_config(), draws)
    assert ts2.frame == int(js2.frame) == 2
    # the packed row: counts and flags exact, chi^2 and the mean
    # reprojection error (px) to 1e-5 relative
    np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), rtol=1e-5,
                               atol=1e-5)
    for name in ("cursor", "count", "valid", "hash_slot", "obs_count"):
        np.testing.assert_array_equal(getattr(ts2.map, name).numpy(),
                                      np.asarray(getattr(js2.map, name)))
    np.testing.assert_array_equal(ts2.prev_lm.numpy(), np.asarray(js2.prev_lm))
    np.testing.assert_allclose(ts2.T_w_cam.numpy(), np.asarray(js2.T_w_cam),
                               rtol=0, atol=1e-5)
