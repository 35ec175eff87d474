"""The VO slice of the port against the JAX package on the test_vo clip
(tiny_config, PRNGKey(42), 12 frames, 1500 points, arc, speed 0.8).

The world is made by the JAX package and carried across with
`utils/interop.py`; the RANSAC draws are the reference's own key chain
(`vo.py:60`: split per frame, then `uniform(sub, (K, N), 1e-9, 1)`),
handed to the port frame by frame.

Tolerances: rendering 1e-6 at the identity pose; at other poses XLA
and PyTorch round the 3-term products of `transform_points` in another
order (1 ulp of the camera-frame points, ~2e-6 m), which moves the
bilinear sample positions by ~1e-5 px, so those frames hold to 1e-4
(and 1e-6 on all but 1% of pixels). Per frame: identical num_stereo,
num_temporal +-1, num_inliers +-2, poses 1e-3 m and 1e-3 rad; ATE
within 1e-3 m of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import tiny_config as jtiny
from slam1_tpu.models import vo as jvo
from slam1_tpu.utils.evalmetrics import ate_rmse
from slam1_tpu.utils.synthetic import make_world, render_frame, \
    render_sequence
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import vo as tvo
from slam1_tpu_torch.utils import interop
from slam1_tpu_torch.utils import synthetic as tsyn
from torch_threads import one_torch_thread  # noqa: F401

H, W = 128, 256


@pytest.fixture(scope="module")
def clip():
    key = jax.random.PRNGKey(42)
    cfg = jtiny()
    world = make_world(key, n_frames=12, n_points=1500, trajectory="arc",
                       speed=0.8, image_hw=(H, W))
    lefts, rights = render_sequence(world, H, W)
    return cfg, world, np.array(lefts), np.array(rights)


def reference_draws(cfg, n_steps, seed=0):
    """The (K, N) uniforms the reference's vo_step feeds ransac_pnp."""
    key = jax.random.PRNGKey(seed)
    shape = (cfg.tracking.ransac_iters, cfg.detector.max_kp)
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.array(jax.random.uniform(
            sub, shape, minval=1e-9, maxval=1.0))))
    return out


def rot_angle(Ra, Rb):
    M = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    v = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v))))


@pytest.mark.parametrize("frame", [0, 5, 11])
def test_render_frame_matches_jax(clip, frame):
    _, world, _, _ = clip
    tw = interop.world(jax.device_get(world), device="cpu")
    atol = 1e-6 if frame == 0 else 1e-4
    for j, t in zip(render_frame(world, frame, H, W),
                    tsyn.render_frame(tw, frame, H, W)):
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=atol)
        assert np.mean(np.abs(t - j) > 1e-6) < 0.01


@pytest.mark.parametrize("kind", ["straight", "arc", "loop"])
def test_make_trajectory_matches_jax(kind):
    """30 chained float32 4x4 products: rounding differences accumulate
    to under a millimetre."""
    from slam1_tpu.utils.synthetic import make_trajectory
    np.testing.assert_allclose(
        tsyn.make_trajectory(30, kind, 0.8, device="cpu").numpy(),
        np.asarray(make_trajectory(30, kind, 0.8)), rtol=0, atol=1e-3)


def test_run_sequence_matches_jax(clip):
    cfg, world, lefts, rights = clip
    pj, mj = jvo.run_sequence(jnp.asarray(lefts), jnp.asarray(rights),
                              world.cam, cfg)
    pt, mt = tvo.run_sequence(
        torch.as_tensor(lefts), torch.as_tensor(rights),
        interop.camera(jax.device_get(world.cam), device="cpu"), tiny_config(),
        draws=reference_draws(cfg, lefts.shape[0] - 1))
    assert pt.shape == pj.shape and len(mt) == len(mj)
    for i, (a, b) in enumerate(zip(mj, mt)):
        assert int(b.num_stereo) == int(a.num_stereo), i
        assert abs(int(b.num_temporal) - int(a.num_temporal)) <= 1, i
        assert abs(int(b.num_inliers) - int(a.num_inliers)) <= 2, i
        assert bool(b.pnp_ok) == bool(a.pnp_ok), i
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0,
                               atol=1e-3)
    assert max(rot_angle(a[:3, :3], b[:3, :3])
               for a, b in zip(pj, pt)) <= 1e-3
    gt = np.asarray(world.poses)
    assert abs(ate_rmse(pt, gt, align=False)
               - ate_rmse(pj, gt, align=False)) <= 1e-3


def test_vo_step_from_carried_state(clip):
    """A reference state exported to numpy (without its key) and carried
    into the port takes the same next step as the reference."""
    cfg, world, lefts, rights = clip
    js = jvo.init_state(jnp.asarray(lefts[0]), jnp.asarray(rights[0]),
                        world.cam, cfg)
    sub = jax.random.split(js.key)[1]
    u = np.array(jax.random.uniform(
        sub, (cfg.tracking.ransac_iters, cfg.detector.max_kp),
        minval=1e-9, maxval=1.0))
    ts = interop.vo_state(jax.device_get(js._replace(key=None)), device="cpu")
    js2, jm = jvo.vo_step(js, jnp.asarray(lefts[1]), jnp.asarray(rights[1]),
                          world.cam, cfg)
    ts2, tm = tvo.vo_step(ts, torch.as_tensor(lefts[1]),
                          torch.as_tensor(rights[1]),
                          interop.camera(jax.device_get(world.cam), "cpu"),
                          tiny_config(), u=torch.as_tensor(u))
    assert ts2.frame == int(js2.frame) == 1
    assert int(tm.num_stereo) == int(jm.num_stereo)
    np.testing.assert_allclose(ts2.T_w_cam.numpy(), np.asarray(js2.T_w_cam),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ts2.prev_obs.mask.numpy(),
                                  np.asarray(js2.prev_obs.mask))


def test_port_tracks_its_own_world():
    """The port end to end on its own renderer and RANSAC generator."""
    cfg = tiny_config()
    world = tsyn.make_world(7, n_frames=8, n_points=1500, trajectory="arc",
                            speed=0.8, image_hw=(H, W), device="cpu")
    lefts, rights = tsyn.render_sequence(world, H, W)
    poses, metrics = tvo.run_sequence(lefts, rights, world.cam, cfg)
    assert poses.shape == (8, 4, 4) and np.isfinite(poses).all()
    assert ate_rmse(poses, world.poses.numpy(), align=False) < 0.5
    assert np.mean([bool(m.pnp_ok) for m in metrics]) > 0.8
