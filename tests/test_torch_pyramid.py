"""The non-power-of-2 scale pyramid of the port's `detect_pyramid`
against the JAX package, on `tests/test_pyramid.py`'s 128x256 canvas:
the half-octave pyramid (scale sqrt 2, 5 levels) and the original
project's ORB pyramid (scale 1.2, 8 levels).

Level l is the full image resized by the reference's antialiased linear
filter (`jax.image.resize`); the port builds the same separable
triangle-filter weights and applies them as two products
(`detector.resize_linear`). Tolerances:
  - level images within 2e-6 (on [0, 1] images), not 1e-6: XLA:CPU
    rounds the compiled weights differently per shape, and the port
    follows its rounding at most shapes of this canvas but not all (the
    short side's 128 -> 51 of the 1.2 pyramid's level 5 is the worst
    here); `_resize_weights` says how;
  - every keypoint slot (mask, position within 1e-3 px, descriptor bits)
    equal, at both scales on both images.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import DetectorConfig as JDetectorConfig
from slam1_tpu.ops import detector as jdet
from slam1_tpu_torch.config import DetectorConfig
from slam1_tpu_torch.ops import detector as tdet
from slam1_tpu_torch.ops import hamming as tham
from test_pyramid import _textured_image
from torch_threads import one_torch_thread  # noqa: F401

LEVEL_TOL = 2e-6
SCALES = {"sqrt2": (math.sqrt(2.0), 5), "orb1.2": (1.2, 8)}
CASES = [("sqrt2", 7), ("orb1.2", 7), ("orb1.2", 1)]


def configs(name):
    s, levels = SCALES[name]
    kw = dict(grid_rows=4, grid_cols=8, kp_per_tile=16, num_levels=levels,
              scale_factor=s)
    return JDetectorConfig(**kw), DetectorConfig(**kw)


@pytest.fixture(scope="module")
def images():
    return {k: np.array(_textured_image(jax.random.PRNGKey(k), 128, 256))
            for k in (1, 7)}


def jax_levels(img, scale, levels):
    h, w = img.shape
    out = [img]
    for lvl in range(1, levels):
        s = scale ** lvl
        out.append(jax.image.resize(img, (max(16, round(h / s)),
                                          max(16, round(w / s))),
                                    "linear", antialias=True))
    return out


@pytest.mark.parametrize("name,key", CASES)
def test_pyramid_levels_match_jax(images, name, key):
    jc, tc = configs(name)
    img = images[key]
    j = jax.jit(jax_levels, static_argnums=(1, 2))(
        jnp.asarray(img), jc.scale_factor, jc.num_levels)
    t = tdet.pyramid_levels(torch.as_tensor(img)[None], tc)
    assert [a.shape for a in j] == [tuple(b.shape[1:]) for b in t]
    for lvl, (a, b) in enumerate(zip(j, t)):
        err = float(np.abs(np.asarray(a) - b[0].numpy()).max())
        assert err <= LEVEL_TOL, (lvl, err)


@pytest.mark.parametrize("name,key", CASES)
def test_detect_pyramid_matches_jax(images, name, key):
    jc, tc = configs(name)
    img = images[key]
    j = jdet.detect_pyramid(jnp.asarray(img), jc)
    xy, _, _, desc, mask = [x[0].numpy() for x in tdet.detect_pyramid(
        torch.as_tensor(img)[None], tc)]
    assert mask.shape == np.asarray(j.mask).shape == (tc.max_kp,)
    assert tc.max_kp % 128 == 0 and mask.sum() > 100
    differ = ((np.asarray(j.mask) != mask)
              | (np.abs(np.asarray(j.xy) - xy).max(-1) > 1e-3)
              | (np.asarray(j.desc) != desc).any(-1))
    assert int(differ.sum()) == 0


@pytest.mark.parametrize("zf", [1.2, 1.4, 1.7])
def test_half_octave_pyramid_matches_at_1p4x(images, zf):
    """The port's counterpart of test_pyramid.py's case: a revisit at a
    non-octave scale ratio still matches through the sqrt-2 pyramid (the
    zoomed view is made by the reference's upsampling)."""
    _, tc = configs("sqrt2")
    h, w = 128, 256
    img = images[7]
    ch, cw = int(h / zf), int(w / zf)
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    zoom = np.array(jax.image.resize(jnp.asarray(img[y0:y0 + ch,
                                                     x0:x0 + cw]),
                                     (h, w), "linear"))
    fa, fb = (tdet.detect_pyramid(torch.as_tensor(x)[None], tc)
              for x in (img, zoom))
    m = tham.match(fa.desc[0], fb.desc[0], fa.mask[0], fb.mask[0],
                   ratio=0.9, max_distance=80, cross_check=True)
    xa = fa.xy[0].numpy()
    xb = fb.xy[0].numpy()[m.idx.numpy()]
    pred = (xa - np.array([x0, y0])) * zf
    err = np.linalg.norm(pred - xb, axis=-1)
    good = int(np.sum(m.mask.numpy() & (err < 4.0)))
    assert good >= 30, f"only {good} matches at {zf}x"


def test_resize_weights_rows_sum_to_one():
    """Each output sample's weights sum to 1 inside the image."""
    for n_in, n_out in ((128, 107), (1280, 1067), (376, 105)):
        wts = tdet._resize_weights(n_in, n_out, torch.device("cpu"))
        assert wts.shape == (n_in, n_out)
        np.testing.assert_allclose(wts.sum(0).numpy(), 1.0, atol=1e-6)
