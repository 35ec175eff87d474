"""RANSAC-PnP of the port against the JAX package with the same draws.

The reference draws `uniform(key, (K, N), 1e-9, 1.0)` inside
`ransac_pnp` (`pnp.py:101-102`); the test computes that array with
jax.random and hands it to the port as `u`. Same hypotheses, same GN
(forward-mode Jacobians on both sides), so the pose agrees within 1e-4
(float32 sum order in the 6x6 normal equations) and the inlier count
within +-1 (points on the 3 px threshold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import TrackingConfig as JTracking
from slam1_tpu.ops import se3 as jse3
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu.ops.pnp import ransac_pnp as jransac
from slam1_tpu_torch.config import TrackingConfig
from slam1_tpu_torch.ops import se3 as tse3
from slam1_tpu_torch.ops.pnp import ransac_pnp
from slam1_tpu_torch.utils import interop
from torch_threads import one_torch_thread  # noqa: F401

N = 192


def problem(seed, n_valid, outliers=0.2):
    rng = np.random.default_rng(seed)
    cam = StereoCamera.for_canvas(128, 256)
    fx, cx, cy = float(cam.fx), float(cam.cx), float(cam.cy)
    X = np.stack([rng.uniform(-12, 12, N), rng.uniform(-4, 3, N),
                  rng.uniform(6, 40, N)], -1).astype(np.float32)
    xi = np.array([0.05, -0.02, -0.8, 0.004, 0.03, -0.002], np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    Xb = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([fx * Xb[:, 0] / Xb[:, 2] + cx,
                   fx * Xb[:, 1] / Xb[:, 2] + cy], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    out = rng.random(N) < outliers
    uv[out] = rng.uniform(0, 256, (out.sum(), 2))
    mask = np.zeros(N, bool)
    mask[rng.permutation(N)[:n_valid]] = True
    return cam, X, uv.astype(np.float32), mask, xi


@pytest.mark.parametrize("n_valid,prior,weights,outliers", [
    (150, False, False, 0.2), (150, True, False, 0.2),
    (150, True, True, 0.2), (40, True, False, 0.2),
    # Fewer valid points than the sample size: every hypothesis also
    # draws masked (-inf) slots, whose ties must go to the lowest index.
    (5, True, False, 0.0)])
def test_ransac_pnp_matches_jax(n_valid, prior, weights, outliers):
    cam, X, uv, mask, xi = problem(n_valid, n_valid, outliers)
    cfg = JTracking(ransac_iters=64)
    key = jax.random.PRNGKey(n_valid)
    xi_init = (xi + 0.01).astype(np.float32) if prior else None
    pw = (np.where(X[:, 2] < 20, 1.0, 0.5).astype(np.float32)
          if weights else None)
    j = jax.device_get(jransac(
        key, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(mask), cam, cfg,
        xi_init=None if xi_init is None else jnp.asarray(xi_init),
        point_weights=None if pw is None else jnp.asarray(pw)))
    u = np.array(jax.random.uniform(key, (cfg.ransac_iters, N),
                                    minval=1e-9, maxval=1.0))
    t = ransac_pnp(torch.as_tensor(X), torch.as_tensor(uv),
                   torch.as_tensor(mask), interop.camera(cam, device="cpu"),
                   TrackingConfig(ransac_iters=64),
                   xi_init=None if xi_init is None
                   else torch.as_tensor(xi_init),
                   point_weights=None if pw is None else torch.as_tensor(pw),
                   u=torch.as_tensor(u))
    assert bool(t.ok) == bool(j.ok)
    assert abs(int(t.num_inliers) - int(j.num_inliers)) <= 1
    np.testing.assert_allclose(t.T.numpy(), j.T, rtol=0, atol=1e-4)
    if n_valid > 10:
        assert bool(t.ok)
        np.testing.assert_allclose(tse3.log_se3(t.T).numpy(), xi, atol=0.05)
        np.testing.assert_allclose(float(t.mean_err), float(j.mean_err),
                                   rtol=1e-3, atol=1e-4)


def test_ransac_pnp_generator_path():
    """Without injected draws the port samples from its generator: the
    same seed gives the same pose."""
    cam, X, uv, mask, xi = problem(1, 150)
    args = (torch.as_tensor(X), torch.as_tensor(uv), torch.as_tensor(mask),
            interop.camera(cam, device="cpu"), TrackingConfig(ransac_iters=64))
    a = ransac_pnp(*args, generator=torch.Generator().manual_seed(5))
    b = ransac_pnp(*args, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.T, b.T) and bool(a.ok)
    np.testing.assert_allclose(tse3.log_se3(a.T).numpy(), xi, atol=0.05)
    with pytest.raises(ValueError, match="generator or draws"):
        ransac_pnp(*args)
