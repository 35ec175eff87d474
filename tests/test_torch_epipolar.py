"""Two-view geometry of the port (`ops/epipolar.py`, `triangulate.dlt`)
against the JAX package, on the problems of `tests/test_epipolar.py`.

The reference draws its RANSAC samples from `jax.random.uniform(key,
(iters, N), 1e-9, 1.0)`; the test computes those draws and hands them
to the port as `u`, so both sides solve the same hypotheses. Inlier
masks and counts must be equal, F equal up to sign and scale within
1e-4 (both are scaled by F[2,2], and compared here at unit norm), R and
t within 1e-4 after the cheirality vote, and DLT points within 1e-4
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.ops import epipolar as jepi
from slam1_tpu.ops import se3 as jse3
from slam1_tpu.ops import triangulate as jtri
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu_torch.ops import epipolar as tepi
from slam1_tpu_torch.ops import triangulate as ttri
from test_epipolar import two_view_problem
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)          # conftest's `rng`
XI = [0.3, 0.05, 0.5, 0.02, 0.04, 0.01]


def draws(iters, n):
    return torch.as_tensor(np.array(jax.random.uniform(
        KEY, (iters, n), minval=1e-9, maxval=1.0)))


def unit(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


@pytest.mark.parametrize("outliers,iters", [(0, 64), (40, 128), (10, 128)])
def test_ransac_fundamental_matches_jax(outliers, iters):
    uv1, uv2, mask = two_view_problem(outliers=outliers)
    j = jepi.ransac_fundamental(KEY, jnp.asarray(uv1), jnp.asarray(uv2),
                                jnp.asarray(mask), iters=iters)
    t = tepi.ransac_fundamental(torch.as_tensor(uv1), torch.as_tensor(uv2),
                                torch.as_tensor(mask), iters=iters,
                                u=draws(iters, len(mask)))
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.num_inliers) == int(j.num_inliers)
    assert bool(t.ok) == bool(j.ok)
    np.testing.assert_allclose(unit(t.F.numpy()), unit(j.F), atol=1e-4)


def test_samples_with_fewer_valid_points_than_a_sample():
    """6 valid points: every hypothesis also takes two masked (-inf)
    slots, which tie; both sides take them at the lowest indices (the
    8-point problem itself is then degenerate, and neither is ok)."""
    uv1, uv2, mask = two_view_problem()
    mask[6:] = False
    u = draws(16, len(mask))
    g = -jnp.log(-jnp.log(jnp.asarray(u.numpy())))
    _, js = jax.lax.top_k(jnp.where(jnp.asarray(mask)[None], g, -jnp.inf), 8)
    ts = tepi.gumbel_top(u, torch.as_tensor(mask)[None], 8)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    j = jepi.ransac_fundamental(KEY, jnp.asarray(uv1), jnp.asarray(uv2),
                                jnp.asarray(mask), iters=16)
    t = tepi.ransac_fundamental(torch.as_tensor(uv1), torch.as_tensor(uv2),
                                torch.as_tensor(mask), iters=16, u=u)
    assert not bool(t.ok) and not bool(j.ok)
    assert int(t.num_inliers) <= 6


def test_recover_pose_2d2d_matches_jax():
    cam = StereoCamera.kitti_default()
    K = np.asarray(cam.K)
    uv1, uv2, mask = two_view_problem(outliers=8)
    j = jepi.recover_pose_2d2d(KEY, jnp.asarray(uv1), jnp.asarray(uv2),
                               jnp.asarray(mask), jnp.asarray(K), iters=128)
    t = tepi.recover_pose_2d2d(torch.as_tensor(uv1), torch.as_tensor(uv2),
                               torch.as_tensor(mask), torch.as_tensor(K),
                               iters=128, u=draws(128, len(mask)))
    assert bool(t.ok) and bool(j.ok)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_allclose(t.T.numpy(), np.asarray(j.T), atol=1e-4)
    T_true = np.asarray(jse3.exp_se3(jnp.asarray(XI)))
    dR = t.T.numpy()[:3, :3].T @ T_true[:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.5, ang


def test_recover_pose_2d2d_generator_draws():
    """With a torch.Generator the port draws its own samples (no replay):
    the recovered rotation is still the true one."""
    cam = StereoCamera.kitti_default()
    uv1, uv2, mask = two_view_problem(outliers=8)
    g = torch.Generator().manual_seed(3)
    t = tepi.recover_pose_2d2d(torch.as_tensor(uv1), torch.as_tensor(uv2),
                               torch.as_tensor(mask),
                               torch.as_tensor(np.asarray(cam.K)),
                               iters=128, generator=g)
    T_true = np.asarray(jse3.exp_se3(jnp.asarray(XI)))
    dR = t.T.numpy()[:3, :3].T @ T_true[:3, :3]
    assert bool(t.ok)
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 0.5
    with pytest.raises(ValueError, match="exactly one"):
        tepi.ransac_fundamental(torch.as_tensor(uv1), torch.as_tensor(uv2),
                                torch.as_tensor(mask))


def test_decompose_essential_candidates_match_jax():
    """The four (R, t) candidates as a set: each of the reference's
    appears among the port's (SVD signs may order them differently)."""
    T = np.asarray(jse3.exp_se3(jnp.asarray(XI)))
    t = T[:3, 3] / np.linalg.norm(T[:3, 3])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ T[:3, :3]).astype(np.float32)
    R1, R2, tj = (np.asarray(a) for a in jepi.decompose_essential(
        jnp.asarray(E)))
    S1, S2, tt = (a.numpy() for a in tepi.decompose_essential(
        torch.as_tensor(E)))
    cands = [S1, S2]
    for R in (R1, R2):
        assert min(np.abs(R - S).max() for S in cands) < 1e-5
    assert min(np.abs(tj - tt).max(), np.abs(tj + tt).max()) < 1e-5


def test_dlt_matches_jax():
    cam = StereoCamera.kitti_default()
    K = np.asarray(cam.K, np.float32)
    uv1, uv2, _ = two_view_problem()
    T = np.asarray(jse3.exp_se3(jnp.asarray(XI)))
    P1 = (K @ np.eye(3, 4)).astype(np.float32)
    P2 = (K @ T[:3]).astype(np.float32)
    Xj = np.asarray(jtri.dlt(jnp.asarray(P1), jnp.asarray(P2),
                             jnp.asarray(uv1), jnp.asarray(uv2)))
    Xt = ttri.dlt(torch.as_tensor(P1), torch.as_tensor(P2),
                  torch.as_tensor(uv1), torch.as_tensor(uv2)).numpy()
    rel = np.linalg.norm(Xt - Xj, axis=-1) / np.linalg.norm(Xj, axis=-1)
    assert rel.max() < 1e-4, rel.max()
    assert 5.0 < np.median(Xt[:, 2]) < 50.0
