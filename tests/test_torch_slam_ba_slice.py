"""The SLAM system with local BA on: the port's `SlamSystem` against the
JAX package's on the 36-frame loop clip of tests/test_torch_slam_slice.py.

Both sides run `tiny_config()` unchanged (`ba.local_every=5`: a windowed
BA every 5 keyframes, on the drains) with `bow_train_frame=8`; the port
replays the reference's draws. Tolerances: the same number of BA
launches with costs within 1e-2 relative, the same drained rows in their
integers and flags, the same loop events and loop-edge pairs, poses
before and after the final relaxation within 1e-2 m.
"""

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
from test_torch_slam_slice import ReplayDraws
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 36


@pytest.fixture(scope="module")
def ba_clip():
    jcfg, tcfg = jtiny(), tiny_config()
    assert jcfg.ba.local_every == tcfg.ba.local_every == 5
    h, w = jcfg.image.height, jcfg.image.width
    world = make_world(jax.random.PRNGKey(3), n_frames=N_FRAMES,
                       n_points=1200, trajectory="loop", speed=0.9,
                       image_hw=(h, w))
    lefts, rights = (np.array(a) for a in render_sequence(world, h, w))
    js = jpipe.SlamSystem(world.cam, jcfg, bow_train_frame=8)
    for i in range(N_FRAMES):
        js.process(jnp.asarray(lefts[i]), jnp.asarray(rights[i]))
    j_pre = js.poses()
    j_post = js.finalize()

    ts = tpipe.SlamSystem(interop.camera(jax.device_get(world.cam), "cpu"),
                          tcfg, bow_train_frame=8, draws=ReplayDraws(0))
    tl, tr = torch.as_tensor(lefts), torch.as_tensor(rights)
    for i in range(N_FRAMES):
        ts.process(tl[i], tr[i])
    t_pre = ts.poses()
    t_post = ts.finalize()
    return dict(world=world, js=js, ts=ts, j_pre=j_pre, j_post=j_post,
                t_pre=t_pre, t_post=t_post)


def test_ba_cadence_and_costs_match_jax(ba_clip):
    js, ts = ba_clip["js"], ba_clip["ts"]
    # one window per 5 keyframes past the first: (36 - 1) // 5
    assert len(ts.ba_costs) == len(js.ba_costs) == (N_FRAMES - 1) // 5
    assert ts._kf_at_last_ba == js._kf_at_last_ba == 36
    for a, b in zip(js.ba_costs, ts.ba_costs):
        assert b.dim() == 0 and np.isfinite(float(b))
        assert abs(float(b) - float(a)) <= 1e-2 * float(a)


def test_ba_slice_rows_match_jax(ba_clip):
    js, ts = ba_clip["js"], ba_clip["ts"]
    assert len(ts.metrics) == len(js.metrics) == N_FRAMES - 1
    for a, b in zip(js.metrics, ts.metrics):
        for name in ("loop_hit", "loop_candidate", "is_kf", "kf_n",
                     "num_stereo", "pnp_ok", "frame"):
            assert getattr(b, name) == getattr(a, name), (a.frame, name)
        assert abs(b.num_inliers - a.num_inliers) <= 2, a.frame


def test_ba_slice_loop_edges_match_jax(ba_clip):
    js, ts = ba_clip["js"], ba_clip["ts"]
    assert [(e.frame, e.candidate, e.accepted) for e in ts.loop_events] == \
        [(e.frame, e.candidate, e.accepted) for e in js.loop_events]
    assert [(i, j) for i, j, _, _ in ts.loop_edges] == \
        [(i, j) for i, j, _, _ in js.loop_edges]
    assert len(ts.loop_edges) >= 1
    for (_, _, Zj, _), (_, _, Zt, _) in zip(js.loop_edges, ts.loop_edges):
        np.testing.assert_allclose(Zt, Zj, rtol=0, atol=1e-3)


def test_ba_slice_poses_match_jax(ba_clip):
    for which in ("pre", "post"):
        pj, pt = ba_clip["j_" + which], ba_clip["t_" + which]
        assert pt.shape == pj.shape == (N_FRAMES, 4, 4)
        np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0,
                                   atol=1e-2)
    jst, tst = ba_clip["js"].state, ba_clip["ts"].state
    np.testing.assert_allclose(tst.kf.poses.numpy(), np.asarray(jst.kf.poses),
                               rtol=0, atol=1e-2)
    np.testing.assert_array_equal(tst.map.valid.numpy(),
                                  np.asarray(jst.map.valid))


def test_ba_slice_closes_the_loop(ba_clip):
    gt = np.asarray(ba_clip["world"].poses)
    i, j, Z, _ = ba_clip["ts"].loop_edges[0]
    Z_true = np.linalg.inv(gt[i]) @ gt[j]
    assert np.linalg.norm(Z[:3, 3] - Z_true[:3, 3]) < 0.2
    assert ate_rmse(ba_clip["t_post"], gt, align=False) < 0.5


def test_default_config_constructs():
    """`SlamConfig()` unchanged (local BA on, asynchronous drain)
    constructs with its fetch worker."""
    from slam1_tpu_torch.config import SlamConfig
    from slam1_tpu_torch.ops.camera import StereoCamera
    cfg = SlamConfig()
    assert cfg.ba.local_every == 5 and cfg.bow.poll_lag_s > 0
    s = tpipe.SlamSystem(StereoCamera.kitti_default(device="cpu"), cfg)
    assert s._async and s._pool is not None and s.ba_costs == []
