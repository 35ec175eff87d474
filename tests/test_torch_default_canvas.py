"""The default 376x1280 canvas through both packages: every other parity
test runs at 128x256 or `tiny_config()` shapes.

  - `detect_pyramid` (3 levels, 2688 keypoint slots) on the left and
    right images of a rendered frame: no slot differs in mask, position
    (1e-3 px) or descriptor (measured: 0 of 2688 on both images). On
    uniform noise one slot of 2688 differs whatever order the port sums
    its 2x2 means in, so the pyramid is not its cause (measured: 1).
  - the pyramid levels of `detect_pyramid` and of `lk.build_pyramid`
    (3 levels each) against the reference's pyramids compiled as one
    program: equal (measured: 0 differing pixels; summed in the width's
    order at every level, as the reference rounds op by op, level 2
    differs by 1 ulp on 6395 of 30080 pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import SlamConfig as JSlamConfig
from slam1_tpu.ops import detector as jdet
from slam1_tpu.ops import lk as jlk
from slam1_tpu_torch.config import SlamConfig
from slam1_tpu_torch.ops import detector as tdet
from slam1_tpu_torch.ops import lk as tlk
from slam1_tpu_torch.utils import synthetic as tsyn
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def frame():
    cfg = SlamConfig()
    h, w = cfg.image.height, cfg.image.width
    world = tsyn.make_world(0, n_frames=4, n_points=6000, trajectory="arc",
                            device="cpu")
    left, right = tsyn.render_frame(world, 2, h, w)
    return cfg, left.numpy(), right.numpy()


def differing_slots(img, cfg):
    j = jdet.detect_pyramid(jnp.asarray(img), JSlamConfig().detector,
                            cfg.image.valid_height, cfg.image.valid_width)
    xy, _, _, desc, mask = [x[0].numpy() for x in tdet.detect_pyramid(
        torch.as_tensor(img)[None], cfg.detector, cfg.image.valid_height,
        cfg.image.valid_width)]
    assert mask.shape == np.asarray(j.mask).shape == (cfg.detector.max_kp,)
    return int(((np.asarray(j.mask) != mask)
                | (np.abs(np.asarray(j.xy) - xy).max(-1) > 1e-3)
                | (np.asarray(j.desc) != desc).any(-1)).sum())


@pytest.mark.parametrize("side", ["left", "right", "noise"])
def test_detect_pyramid_default_canvas(frame, side):
    cfg, left, right = frame
    img = {"left": left, "right": right,
           "noise": np.random.default_rng(5).random(left.shape).astype(
               np.float32)}[side]
    assert differing_slots(img, cfg) <= (1 if side == "noise" else 0)


def jitted_detector_pyramid(img, levels):
    out = [img]
    for _ in range(levels - 1):
        out.append(jdet._downsample2(out[-1]))
    return out


def port_detector_pyramid(img, levels):
    """The levels `detect_pyramid` scores, for one image."""
    out = [img[None]]
    for lvl in range(1, levels):
        out.append(tdet._downsample2(out[-1], pairwise=lvl > 1))
    return [x[0] for x in out]


@pytest.mark.parametrize("which", ["detector", "lk"])
def test_pyramid_levels_default_canvas(frame, which):
    """Level by level against the reference's pyramid compiled as one
    program, as its jitted `detect_pyramid` and `lk_track` build it."""
    cfg, left, _ = frame
    if which == "lk":
        levels = cfg.flow.levels
        j = jax.jit(jlk.build_pyramid, static_argnums=1)(jnp.asarray(left),
                                                         levels)
        tp = tlk.build_pyramid(torch.as_tensor(left), levels)
    else:
        levels = cfg.detector.num_levels
        j = jax.jit(jitted_detector_pyramid, static_argnums=1)(
            jnp.asarray(left), levels)
        tp = port_detector_pyramid(torch.as_tensor(left), levels)
    assert [a.shape for a in j] == [tuple(b.shape) for b in tp]
    for lv, (a, b) in enumerate(zip(j, tp)):
        assert int((np.asarray(a) != b.numpy()).sum()) == 0, lv
