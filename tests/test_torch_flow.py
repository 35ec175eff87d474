"""The flow VO path of the port (`ops/lk.py`, `ops/disparity.py`,
`models/vo_flow.py`) against the JAX package on the same numpy inputs,
on the cases of tests/test_lk.py, tests/test_disparity.py and
tests/test_vo_flow.py.

Tolerances:
  - bilinear samples, pyramid levels (against the reference's pyramid
    compiled as one program), cost volumes (against `_cost_volume` run
    op by op): exact. The port rounds the 2x2 means and the cumulative
    sums in the reference's order (see `lk._downsample2`,
    `disparity._cumsum_last`).
  - disparity maps against the compiled `disparity`: validity masks and
    integer disparities exact, NaN where the reference has NaN
    (parabolic fits next to +inf costs), sub-pixel disparities 1e-3 px.
    Compiled, XLA contracts multiply-adds into FMAs and turns the
    division by the window area into a product, so costs move by ulps
    (measured over all 20 cases: 0 mask or integer differences, 5.2e-4
    px).
  - LK positions 1e-3 px, errors 1e-5, masks exact: the window sums of
    121 products are summed in another order (measured: 1e-4 px).
  - disparity of rendered frames (flat regions, tied costs): validity
    0.5% of pixels, more than 0.5 px apart 0.1% of the pixels valid on
    both sides (measured 0.32% and 0.014%).
  - flow VO (8 frames, the reference's key chain replayed as draws):
    per frame equal num_tracked, num_stereo and pnp_ok, num_inliers +-1;
    positions 1e-4 m (measured 1.4e-6), ATE within 1e-4 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import tiny_config as jtiny
from slam1_tpu.models import vo_flow as jvf
from slam1_tpu.ops import disparity as jd
from slam1_tpu.ops import lk as jlk
from slam1_tpu.utils.evalmetrics import ate_rmse
from slam1_tpu.utils.synthetic import make_world, render_sequence
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import vo_flow as tvf
from slam1_tpu_torch.ops import disparity as td
from slam1_tpu_torch.ops import lk as tlk
from slam1_tpu_torch.utils import interop
from slam1_tpu_torch.utils import synthetic as tsyn
from test_disparity import _make_pair, _texture
from test_lk import _grid_points, _shift_bilinear, _smooth_texture
from torch_threads import one_torch_thread  # noqa: F401


def t(a):
    return torch.as_tensor(np.array(a))


def test_bilinear():
    rng = np.random.default_rng(0)
    img = _smooth_texture(rng, 120, 160)
    xy = rng.uniform(-4, 170, (2000, 2)).astype(np.float32)   # clamped too
    np.testing.assert_array_equal(
        np.asarray(jlk.bilinear(jnp.asarray(img), jnp.asarray(xy))),
        tlk.bilinear(t(img), t(xy)).numpy())


@pytest.mark.parametrize("hw,levels", [((120, 160), 4), ((128, 256), 3),
                                       ((97, 133), 3)])
def test_build_pyramid(hw, levels):
    """Against the reference's pyramid compiled as one program, as its
    jitted `lk_track` builds it (run op by op, XLA sums levels 2 and up
    in another order; tests/test_torch_default_canvas.py measures the
    default canvas)."""
    img = np.random.default_rng(1).random(hw).astype(np.float32)
    j = jax.jit(jlk.build_pyramid, static_argnums=1)(jnp.asarray(img),
                                                     levels)
    tp = tlk.build_pyramid(t(img), levels)
    assert len(j) == len(tp) == levels
    for a, b in zip(j, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# (seed, smoothing sigma, shift, levels, image size): test_lk.py's cases.
LK_CASES = {
    "subpixel": (0, 3, (3.6, -2.3), 3, (120, 160)),
    "large-motion": (1, 4, (11.0, 0.0), 4, (120, 160)),
    "oracle-shift": (3, 3, (2.7, 1.4), 3, (120, 160)),
}


@pytest.mark.parametrize("case", sorted(LK_CASES))
def test_lk_track(case):
    seed, sigma, (dx, dy), levels, (h, w) = LK_CASES[case]
    img = _smooth_texture(np.random.default_rng(seed), h, w, sigma=sigma)
    nxt = _shift_bilinear(img, dx, dy)
    pts = _grid_points(h, w)
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    j = jlk.lk_track(jnp.asarray(img), jnp.asarray(nxt), jnp.asarray(pts),
                     jnp.asarray(mask), levels=levels)
    r = tlk.lk_track(t(img), t(nxt), t(pts), t(mask), levels=levels)
    np.testing.assert_array_equal(np.asarray(j.mask), r.mask.numpy())
    np.testing.assert_allclose(r.xy.numpy(), np.asarray(j.xy), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(r.err.numpy(), np.asarray(j.err), rtol=0,
                               atol=1e-5)
    assert r.mask.numpy().mean() > 0.4


def test_lk_invalid_mask_propagates():
    img = _smooth_texture(np.random.default_rng(2), 64, 64)
    pts = np.array([[32.0, 32.0], [40.0, 40.0]], np.float32)
    mask = np.array([True, False])
    j = jlk.lk_track(jnp.asarray(img), jnp.asarray(img), jnp.asarray(pts),
                     jnp.asarray(mask))
    r = tlk.lk_track(t(img), t(img), t(pts), t(mask))
    np.testing.assert_array_equal(np.asarray(j.mask), r.mask.numpy())
    assert not bool(r.mask[1])


@pytest.mark.parametrize("n", [1, 5, 16, 17, 33, 134, 398, 1291])
def test_cumsum_order(n):
    x = np.random.default_rng(n).random((3, n)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)),
        td._cumsum_last(t(x)).numpy())


def _piecewise_pair():
    rng = np.random.default_rng(1)
    h, w = 96, 160
    wide = _texture(rng, h, w + 48)
    left = wide[:, 4:4 + w]
    right = np.empty_like(left)
    right[:h // 2] = wide[:h // 2, 8:8 + w]
    right[h // 2:] = wide[h // 2:, 16:16 + w]
    return left, right


def _periodic_pair():
    xs = np.arange(128, dtype=np.float32)
    img = (np.sin(xs * (2 * np.pi / 8))[None, :].repeat(64, 0) * 0.5
           + 0.5).astype(np.float32)
    return img, img


# test_disparity.py's inputs.
PAIRS = {
    "constant-7": lambda: _make_pair(np.random.default_rng(0), d=7),
    "piecewise": _piecewise_pair,
    "periodic": _periodic_pair,
    "lookup-6": lambda: _make_pair(np.random.default_rng(2), d=6),
    "oracle-9": lambda: _make_pair(np.random.default_rng(3), h=96, w=192,
                                   d=9),
}


def test_cost_volume():
    left, right = PAIRS["oracle-9"]()
    np.testing.assert_array_equal(
        np.asarray(jd._cost_volume(jnp.asarray(left), jnp.asarray(right),
                                   32, 3)),
        td._cost_volume(t(left), t(right), 32, 3).numpy())


@pytest.mark.parametrize("sgm,lr", [(True, True), (True, False),
                                    (False, True), (False, False)])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_disparity(pair, sgm, lr):
    left, right = PAIRS[pair]()
    j = jd.disparity(jnp.asarray(left), jnp.asarray(right), max_disp=32,
                     radius=3, sgm=sgm, lr_check=lr)
    r = td.disparity(t(left), t(right), max_disp=32, radius=3, sgm=sgm,
                     lr_check=lr)
    held_disparity(j, r)


def held_disparity(j, r):
    """A reference DisparityResult against the port's: masks, NaNs and
    integer disparities exact, sub-pixel values within 1e-3 px."""
    vj, vt = np.asarray(j.valid), r.valid.numpy()
    dj, dt = np.asarray(j.disp), r.disp.numpy()
    np.testing.assert_array_equal(vj, vt)
    np.testing.assert_array_equal(np.isnan(dj), np.isnan(dt))
    np.testing.assert_array_equal(np.rint(dj), np.rint(dt))
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-3)


def test_disparity_rendered_frames(clip):
    """Rendered frames have flat regions where costs tie: there the
    compiled reference's FMAs move argmin and the uniqueness test by
    ulps. Measured over the clip's 8 frames: at most 106 of 32768
    validity pixels (0.32%) differ, and of the pixels valid on both
    sides at most 0.014% are more than 0.5 px apart."""
    cfg, _, lefts, rights = clip
    d = cfg.disparity
    for i in (0, 3):
        j = jd.disparity(jnp.asarray(lefts[i]), jnp.asarray(rights[i]),
                         max_disp=d.max_disp, radius=d.radius)
        r = td.disparity(t(lefts[i]), t(rights[i]), max_disp=d.max_disp,
                         radius=d.radius)
        vj, vt = np.asarray(j.valid), r.valid.numpy()
        assert np.mean(vj != vt) <= 0.005, i
        dj, dt = np.asarray(j.disp), r.disp.numpy()
        both = vj & vt & ~np.isnan(dj) & ~np.isnan(dt)
        assert np.mean(np.abs(dj - dt)[both] > 0.5) <= 1e-3, i
        assert vt.mean() > 0.7


def test_sample_disparity():
    left, right = PAIRS["lookup-6"]()
    j = jd.disparity(jnp.asarray(left), jnp.asarray(right), max_disp=32,
                     radius=3)
    r = td.disparity(t(left), t(right), max_disp=32, radius=3)
    pts = np.random.default_rng(4).uniform(-5, 170, (300, 2)).astype(
        np.float32)
    pts[:2] = [[80.0, 48.0], [100.0, 30.0]]
    held_disparity(jd.DisparityResult(*jd.sample_disparity(
        j, jnp.asarray(pts))), td.DisparityResult(
        *td.sample_disparity(r, t(pts))))
    d, ok = td.sample_disparity(r, t(pts[:2]))
    assert bool(ok.all())
    np.testing.assert_allclose(d.numpy(), 6.0, atol=1.0)


def reference_clip():
    """tests/test_vo_flow.py's clip: 8 frames, 1500 points, speed 0.45."""
    cfg = jtiny()
    world = make_world(jax.random.PRNGKey(0), n_frames=8, n_points=1500,
                       image_hw=(cfg.image.height, cfg.image.width),
                       speed=0.45)
    lefts, rights = render_sequence(world, cfg.image.height, cfg.image.width)
    return cfg, world, np.array(lefts), np.array(rights)


@pytest.fixture(scope="module")
def clip():
    return reference_clip()


def reference_draws(cfg, n_steps, seed=0):
    """The (K, N) uniforms the reference's vo_flow.vo_step feeds
    ransac_pnp: the state's key split once per frame (`vo_flow.py:100`),
    N = the one-level detector's capacity."""
    d = cfg.detector
    shape = (cfg.tracking.ransac_iters, d.grid_rows * d.grid_cols
             * d.kp_per_tile)
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(t(jax.random.uniform(sub, shape, minval=1e-9,
                                        maxval=1.0)))
    return out


def test_run_sequence_matches_jax(clip):
    cfg, world, lefts, rights = clip
    pt, mt = tvf.run_sequence(
        t(lefts), t(rights), interop.camera(jax.device_get(world.cam), "cpu"),
        tiny_config(), draws=reference_draws(cfg, lefts.shape[0] - 1))
    held_to_reference(clip, pt, mt)


def held_to_reference(clip, pt, mt):
    """The port's run_sequence of the clip (poses, metrics), with the
    reference's draws, against the reference's run_sequence."""
    cfg, world, lefts, rights = clip
    pj, mj = jvf.run_sequence(jnp.asarray(lefts), jnp.asarray(rights),
                              world.cam, cfg)
    assert pt.shape == pj.shape and len(mt) == len(mj)
    for i, (a, b) in enumerate(zip(mj, mt)):
        assert int(b.num_tracked) == int(a.num_tracked), i
        assert int(b.num_stereo) == int(a.num_stereo), i
        assert abs(int(b.num_inliers) - int(a.num_inliers)) <= 1, i
        assert bool(b.pnp_ok) == bool(a.pnp_ok), i
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0,
                               atol=1e-4)
    gt = np.asarray(world.poses)
    assert abs(ate_rmse(pt, gt, align=False)
               - ate_rmse(pj, gt, align=False)) <= 1e-4
    assert np.mean([bool(m.pnp_ok) for m in mt]) > 0.6


def test_vo_step_from_carried_state(clip):
    """A reference state exported to numpy (without its key) and carried
    into the port takes the same next step as the reference."""
    cfg, world, lefts, rights = clip
    js = jvf.init_state(jnp.asarray(lefts[0]), jnp.asarray(rights[0]),
                        world.cam, cfg)
    ts = interop.flow_vo_state(jax.device_get(js._replace(key=None)), "cpu")
    u = reference_draws(cfg, 1)[0]
    js2, jm = jvf.vo_step(js, jnp.asarray(lefts[1]), jnp.asarray(rights[1]),
                          world.cam, cfg)
    ts2, tm = tvf.vo_step(ts, t(lefts[1]), t(rights[1]),
                          interop.camera(jax.device_get(world.cam), "cpu"),
                          tiny_config(), u=u)
    assert ts2.frame == int(js2.frame) == 1
    assert int(tm.num_stereo) == int(jm.num_stereo)
    np.testing.assert_allclose(ts2.T_w_cam.numpy(), np.asarray(js2.T_w_cam),
                               rtol=0, atol=1e-4)
    # The disparity of the new frame, compiled inside the reference's
    # vo_step: 68 of 32768 validity pixels differ (0.21%, measured).
    assert np.mean(ts2.prev_dvalid.numpy()
                   != np.asarray(js2.prev_dvalid)) <= 0.005
    np.testing.assert_array_equal(ts2.prev_mask.numpy(),
                                  np.asarray(js2.prev_mask))


def test_port_tracks_its_own_world():
    """The port end to end on its own renderer and RANSAC generator."""
    cfg = tiny_config()
    world = tsyn.make_world(3, n_frames=8, n_points=1500, speed=0.45,
                            image_hw=(cfg.image.height, cfg.image.width),
                            device="cpu")
    lefts, rights = tsyn.render_sequence(world, cfg.image.height,
                                         cfg.image.width)
    poses, metrics = tvf.run_sequence(lefts, rights, world.cam, cfg)
    assert poses.shape == (8, 4, 4) and np.isfinite(poses).all()
    assert np.mean([bool(m.pnp_ok) for m in metrics]) > 0.6
    assert ate_rmse(poses, world.poses.numpy(), align=False) < 0.6
