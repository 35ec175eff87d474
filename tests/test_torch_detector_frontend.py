"""Detector and stereo frontend of the port against the JAX package on a
rendered 128x256 stereo pair (the test_vo clip: PRNGKey(42), 1500
points, arc, speed 0.8).

Exact on valid slots: keypoint coordinates, scores, angles, descriptor
bits, masks, match indices and match masks. Triangulated points within
1e-5 m (same closed form; division order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import tiny_config as jtiny
from slam1_tpu.models.frontend import stereo_frontend as jfrontend
from slam1_tpu.ops import brief as jbrief
from slam1_tpu.ops import detector as jdet
from slam1_tpu.utils.synthetic import make_world, render_frame
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models.frontend import stereo_frontend
from slam1_tpu_torch.ops import brief as tbrief
from slam1_tpu_torch.ops import detector as tdet
from slam1_tpu_torch.utils import interop
from torch_threads import one_torch_thread  # noqa: F401

H, W = 128, 256


@pytest.fixture(scope="module")
def pair():
    world = make_world(jax.random.PRNGKey(42), n_frames=12, n_points=1500,
                       trajectory="arc", speed=0.8, image_hw=(H, W))
    left, right = render_frame(world, 3, H, W)
    return world, np.array(left), np.array(right)


def test_make_pattern_identical():
    np.testing.assert_array_equal(tbrief.make_pattern(),
                                  jbrief.make_pattern())


def test_gaussian_blur_identical(pair):
    _, left, _ = pair
    np.testing.assert_array_equal(
        tbrief.gaussian_blur(torch.as_tensor(left), 1.4).numpy(),
        np.asarray(jbrief.gaussian_blur(jnp.asarray(left), 1.4)))


@pytest.mark.parametrize("shape", [(128, 256), (64, 128)])
def test_downsample2_identical(shape):
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    np.testing.assert_array_equal(
        tdet._downsample2(torch.as_tensor(img)).numpy(),
        np.asarray(jdet._downsample2(jnp.asarray(img))))


@pytest.mark.parametrize("shape", [(376, 1280), (33, 47)])
def test_downsample2_other_shapes_within_one_ulp(shape):
    """At other shapes XLA rounds the 2x2 mean in another order (and
    odd edges are padded); the pooled values agree to 1 ulp."""
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    np.testing.assert_allclose(
        tdet._downsample2(torch.as_tensor(img)).numpy(),
        np.asarray(jdet._downsample2(jnp.asarray(img))), rtol=0, atol=6e-8)


def _assert_features_equal(fj, ft):
    """fj: the reference's Features (carried across), ft: the port's."""
    fj = interop.features(jax.device_get(fj), device="cpu")
    m = fj.mask
    assert torch.equal(ft.mask, m) and m.sum() > 50
    for name in ("xy", "score", "angle", "desc"):
        assert torch.equal(getattr(ft, name)[m], getattr(fj, name)[m]), name


@pytest.mark.parametrize("levels", [1, 3])
def test_detect_pyramid_identical(pair, levels):
    _, left, right = pair
    jcfg = dataclasses.replace(jtiny().detector, num_levels=levels)
    tcfg = dataclasses.replace(tiny_config().detector, num_levels=levels)
    ft = tdet.detect_pyramid(torch.as_tensor(np.stack([left, right])), tcfg,
                             H, W)
    assert ft.mask.shape == (2, tcfg.max_kp)
    for i, img in enumerate((left, right)):
        fj = jdet.detect_pyramid(jnp.asarray(img), jcfg, H, W)
        _assert_features_equal(fj, type(ft)(*[a[i] for a in ft]))


def test_stereo_frontend_identical(pair):
    world, left, right = pair
    cfg = jtiny()
    fj, oj = jax.device_get(jfrontend(jnp.asarray(left), jnp.asarray(right),
                                      world.cam, cfg))
    ft, ot = stereo_frontend(torch.as_tensor(left), torch.as_tensor(right),
                             interop.camera(jax.device_get(world.cam), "cpu"),
                             tiny_config())
    _assert_features_equal(fj, ft)
    m = np.asarray(oj.mask)
    assert m.sum() > 20
    np.testing.assert_array_equal(ot.mask.numpy(), m)
    np.testing.assert_array_equal(ot.uv_r.numpy(), np.asarray(oj.uv_r))
    np.testing.assert_array_equal(ot.desc.numpy(), np.asarray(oj.desc))
    np.testing.assert_allclose(ot.xyz.numpy(), np.asarray(oj.xyz), rtol=1e-6,
                               atol=1e-5)
