"""Leaf math of the port against the JAX package on the same numpy
inputs: se3, camera, lsq, triangulate, brief's single-image entries,
`Features.capacity`, `detect_batch` and `final_pose_diff`.

Tolerance: 1e-5 relative (plus a small absolute floor for values near
0). Both sides compute in float32; the only differences are the order
in which XLA and PyTorch sum the 3-term dot products of small matrix
products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.ops import camera as jcam
from slam1_tpu.ops import lsq as jlsq
from slam1_tpu.ops import se3 as jse3
from slam1_tpu.ops import triangulate as jtri
from slam1_tpu_torch.ops import camera as tcam
from slam1_tpu_torch.ops import lsq as tlsq
from slam1_tpu_torch.ops import se3 as tse3
from slam1_tpu_torch.ops import triangulate as ttri
from slam1_tpu_torch.utils import interop
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def twists(seed, n=64):
    """Random twists, a quarter of them with tiny rotations (the
    small-angle branches) and one exactly zero."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 1.0, (n, 6)).astype(np.float32)
    xi[: n // 4, 3:] *= 1e-5
    xi[0] = 0.0
    return xi


@pytest.mark.parametrize("fn", ["hat", "exp_so3", "_v_matrix"])
def test_so3_maps(fn):
    phi = twists(0)[:, 3:]
    close(getattr(jse3, fn)(jnp.asarray(phi)),
          getattr(tse3, fn)(torch.as_tensor(phi)))


def test_vee_inverts_hat():
    w = torch.as_tensor(twists(1)[:, 3:])
    assert torch.equal(tse3.vee(tse3.hat(w)), w)


@pytest.mark.parametrize("scale", [1.0, 1e-5, 3.0])
def test_log_so3(scale):
    phi = twists(2)[:, 3:] * scale
    phi = phi / np.maximum(1.0, np.linalg.norm(phi, axis=1,
                                              keepdims=True) / 3.0)
    R = np.array(jse3.exp_so3(jnp.asarray(phi)))
    close(jse3.log_so3(jnp.asarray(R)), tse3.log_so3(torch.as_tensor(R)),
          rtol=1e-4, atol=1e-5)


def test_exp_log_se3():
    xi = twists(3)
    close(jse3.exp_se3(jnp.asarray(xi)), tse3.exp_se3(torch.as_tensor(xi)))
    T = np.array(jse3.exp_se3(jnp.asarray(xi)))
    close(jse3.log_se3(jnp.asarray(T)), tse3.log_se3(torch.as_tensor(T)),
          rtol=1e-4, atol=1e-5)


def test_inverse_and_transform_points():
    T = np.array(jse3.exp_se3(jnp.asarray(twists(4, 8))))
    X = np.random.default_rng(5).normal(0, 5, (8, 50, 3)).astype(np.float32)
    close(jse3.inverse(jnp.asarray(T)), tse3.inverse(torch.as_tensor(T)))
    close(jse3.transform_points(jnp.asarray(T), jnp.asarray(X)),
          tse3.transform_points(torch.as_tensor(T), torch.as_tensor(X)),
          atol=1e-5)


@pytest.mark.parametrize("make", ["kitti_default", "for_canvas"])
def test_camera_constructors(make):
    args = (128, 256) if make == "for_canvas" else ()
    j = getattr(jcam.StereoCamera, make)(*args)
    t = getattr(tcam.StereoCamera, make)(*args, device="cpu")
    for a, b in zip(j, t):
        assert float(a) == float(b)


def _points(seed, n=200):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 6, (n, 3)).astype(np.float32)
    X[:, 2] = np.abs(X[:, 2]) + 0.5
    X[:10, 2] *= -1.0                       # some behind the camera
    return X


@pytest.mark.parametrize("fn", ["project", "project_stereo"])
def test_projection(fn):
    jc = jcam.StereoCamera.kitti_default()
    tc = interop.camera(jc, device="cpu")
    X = _points(6)
    j = getattr(jcam, fn)(jc, jnp.asarray(X))
    t = getattr(tcam, fn)(tc, torch.as_tensor(X))
    for a, b in zip(j, t):
        if a.dtype == bool:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            close(a, b, atol=1e-3)           # pixels, up to ~1e4


def test_stereo_rectified():
    jc = jcam.StereoCamera.for_canvas(128, 256)
    tc = interop.camera(jc, device="cpu")
    rng = np.random.default_rng(7)
    uv_l = rng.uniform(0, 256, (300, 2)).astype(np.float32)
    uv_r = uv_l - np.stack([rng.uniform(-2, 40, 300), np.zeros(300)],
                           -1).astype(np.float32)
    Xj, vj = jtri.stereo_rectified(jc, jnp.asarray(uv_l), jnp.asarray(uv_r))
    Xt, vt = ttri.stereo_rectified(tc, torch.as_tensor(uv_l),
                                   torch.as_tensor(uv_r))
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    close(Xj, Xt, atol=1e-4)


def test_huber_weights():
    r2 = np.random.default_rng(8).exponential(5.0, 500).astype(np.float32)
    r2[:3] = [0.0, 4.0, np.inf]
    close(jlsq.huber_weights(jnp.asarray(r2), 2.0),
          tlsq.huber_weights(torch.as_tensor(r2), 2.0))


def _spd6(seed, n=32):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 1, (n, 6, 12)).astype(np.float32)
    return (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)


@pytest.mark.parametrize("fn", ["inv3x3", "inv_spd6"])
def test_closed_form_inverses(fn):
    H = _spd6(9)
    M = H[:, :3, :3] if fn == "inv3x3" else H
    close(getattr(jlsq, fn)(jnp.asarray(M)),
          getattr(tlsq, fn)(torch.as_tensor(M)), rtol=1e-4, atol=1e-5)


def test_solve_spd6():
    H = _spd6(10)
    g = np.random.default_rng(11).normal(0, 1, (32, 6)).astype(np.float32)
    close(jlsq.solve_spd6(jnp.asarray(H), jnp.asarray(g)),
          tlsq.solve_spd6(torch.as_tensor(H), torch.as_tensor(g)),
          rtol=1e-4, atol=1e-5)


def test_camera_matrices():
    jc = jcam.StereoCamera.kitti_default()
    tc = interop.camera(jc, device="cpu")
    close(jc.K, tc.K)
    for a, b in zip(jc.projection_matrices(), tc.projection_matrices()):
        close(a, b)


def test_project_world_and_backproject():
    jc = jcam.StereoCamera.for_canvas(128, 256)
    tc = interop.camera(jc, device="cpu")
    T = np.array(jse3.exp_se3(jnp.asarray(twists(12, 1)[0] * 0.3)))
    X = _points(13)
    for a, b in zip(jcam.project_world(jc, jnp.asarray(T), jnp.asarray(X)),
                    tcam.project_world(tc, torch.as_tensor(T),
                                       torch.as_tensor(X))):
        if a.dtype == bool:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            close(a, b, atol=1e-3)
    rng = np.random.default_rng(14)
    uv = rng.uniform(0, 256, (100, 2)).astype(np.float32)
    z = rng.uniform(1, 50, 100).astype(np.float32)
    close(jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(z)),
          tcam.backproject(tc, torch.as_tensor(uv), torch.as_tensor(z)),
          atol=1e-5)


def test_compose_rotation_angle_orthonormalize():
    T = np.array(jse3.exp_se3(jnp.asarray(twists(15, 16))))
    close(jse3.compose(jnp.asarray(T[:8]), jnp.asarray(T[8:])),
          tse3.compose(torch.as_tensor(T[:8]), torch.as_tensor(T[8:])))
    R = T[:, :3, :3]
    close(jse3.rotation_angle(jnp.asarray(R)),
          tse3.rotation_angle(torch.as_tensor(R)), rtol=1e-4, atol=1e-3)
    noisy = (R + np.random.default_rng(16).normal(0, 1e-2, R.shape)
             ).astype(np.float32)
    close(jse3.orthonormalize(jnp.asarray(noisy)),
          tse3.orthonormalize(torch.as_tensor(noisy)), rtol=1e-4, atol=1e-5)


def _blurred_image(seed, h=96, w=128):
    from slam1_tpu.ops import brief as jbrief
    img = np.random.default_rng(seed).random((h, w)).astype(np.float32)
    return np.array(jbrief.gaussian_blur(jnp.asarray(img)))


def test_extract_patches_and_describe():
    from slam1_tpu.ops import brief as jbrief
    from slam1_tpu_torch.ops import brief as tbrief
    img = _blurred_image(17)
    rng = np.random.default_rng(18)
    xy = rng.uniform(-3, 130, (64, 2)).astype(np.float32)  # some clipped
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jbrief.extract_patches(jnp.asarray(img), jnp.asarray(xy),
                                          33)),
        tbrief.extract_patches(torch.as_tensor(img), torch.as_tensor(xy),
                               33).numpy())
    pattern = jbrief.make_pattern()
    np.testing.assert_array_equal(
        np.asarray(jbrief.describe(jnp.asarray(img), jnp.asarray(xy),
                                   jnp.asarray(ang), pattern)),
        tbrief.describe(torch.as_tensor(img), torch.as_tensor(xy),
                        torch.as_tensor(ang), pattern).numpy())


def test_features_capacity_and_detect_batch():
    from slam1_tpu.config import tiny_config as jtiny
    from slam1_tpu.ops import detector as jdet
    from slam1_tpu_torch.config import tiny_config
    from slam1_tpu_torch.ops import detector as tdet
    imgs = np.stack([_blurred_image(s, 128, 256) for s in (19, 20)])
    j = jdet.detect_batch(jnp.asarray(imgs), jtiny().detector)
    t = tdet.detect_batch(torch.as_tensor(imgs), tiny_config().detector)
    assert t.capacity == j.capacity == tiny_config().detector.max_kp
    np.testing.assert_array_equal(np.asarray(j.mask), t.mask.numpy())
    np.testing.assert_array_equal(np.asarray(j.desc), t.desc.numpy())
    close(j.xy, t.xy, atol=1e-4)


def test_final_pose_diff():
    from slam1_tpu.utils import evalmetrics as jev
    from slam1_tpu_torch.utils import evalmetrics as tev
    T = np.array(jse3.exp_se3(jnp.asarray(twists(21, 10))))
    gt = np.concatenate([T, T[:3]])                # longer than est
    np.testing.assert_array_equal(jev.final_pose_diff(T[::-1], gt),
                                  tev.final_pose_diff(T[::-1], gt))
