"""The carried state that the CPU tests of the port's BA steps share
(not collected): the reference's `SlamSystem` runs 12 frames of the
loop clip at `tiny_config()` with BA off, and its state, exported to
numpy, is carried into the port with `interop.slam_state`; the loop
rows, observation bucket, garbage tail and global-BA cases built on it.

A test file takes them by importing them:

    from torch_ba_carried import _cfgs, _tstate, carried  # noqa: F401
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam1_tpu.config import tiny_config as jtiny
from slam1_tpu.models import pipeline as jpipe
from slam1_tpu.utils.synthetic import make_world, render_sequence
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.utils import interop

N_FRAMES = 12
N_KF = 32            # a bucket above kf.n = 12, and above the 16 cameras
                     # up to which the reduced system is solved densely
LM_ITERS = 5


def _cfgs():
    def cut(cfg):
        return cfg.replace(ba=dataclasses.replace(
            cfg.ba, lm_iters=LM_ITERS, cg_iters=48))
    return cut(jtiny()), cut(tiny_config())


@pytest.fixture(scope="module")
def carried():
    """(reference state as numpy, reference camera, port camera)."""
    jcfg, _ = _cfgs()
    run_cfg = jcfg.replace(ba=dataclasses.replace(jcfg.ba, local_every=0))
    h, w = jcfg.image.height, jcfg.image.width
    world = make_world(jax.random.PRNGKey(3), n_frames=36, n_points=1200,
                       trajectory="loop", speed=0.9, image_hw=(h, w))
    lefts, rights = render_sequence(world, h, w)
    js = jpipe.SlamSystem(world.cam, run_cfg, bow_train_frame=8)
    for i in range(N_FRAMES):
        js.process(lefts[i], rights[i])
    js.finalize(run_pgo=False)
    exported = jax.device_get(js.state)
    assert int(exported.kf.n) == N_FRAMES
    return exported, world.cam, interop.camera(jax.device_get(world.cam),
                                               "cpu")


def _jstate(exported):
    """A fresh reference state (its steps donate their input)."""
    return jax.tree.map(jnp.asarray, exported)


def _tstate(exported):
    return interop.slam_state(exported._replace(key=None), device="cpu")


def _loop_rows(exported):
    """Two loop edges in keyframe rows (the trajectory's own relative
    poses, moved by 5 cm) and two padding rows."""
    le_i = np.array([1, 2, 0, 0], np.int32)
    le_j = np.array([10, 11, 0, 0], np.int32)
    le_z = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    traj = np.asarray(exported.traj, np.float64)
    for k in range(2):
        z = np.linalg.inv(traj[le_i[k]]) @ traj[le_j[k]]
        z[:3, 3] += [0.05, 0.0, -0.05]
        le_z[k] = z
    le_w = np.array([1000.0, 1000.0, 0.0, 0.0], np.float32)
    return le_i, le_j, le_z, le_w


def _obs_bucket(exported):
    n_real = int(np.sum(exported.map.obs_count[:N_KF]))
    return 1 << max(int(np.ceil(np.log2(max(n_real, 1)))), 10)


def _with_garbage_tail(exported):
    """The state with 30 observations of keyframes 3..8 thrown 400 to
    900 px off: what `ba.global_trim_px` = 256 gates out."""
    rng = np.random.default_rng(5)
    obs = np.array(exported.map.obs)
    for k in range(30):
        row = 3 + k % 6
        slot = int(rng.integers(0, int(exported.map.obs_count[row])))
        obs[row, slot, 2:4] += rng.uniform(400, 900, 2) * rng.choice([-1, 1])
    return exported._replace(map=exported.map._replace(obs=obs))


GLOBAL_CASES = {
    # n_kf = 16: the dense reduced system on both sides
    "direct": (16, False),
    "direct-garbage": (16, True),
    # n_kf = 32: the CG path. The reference's segment sums there are
    # differences of a float32 running sum; on this state that noise in
    # a far landmark's 3x3 block throws two landmarks 85 m off and takes
    # its reported cost from 3e2 to 1.6e7 (the truncated cost it accepts
    # on does not see them). The poses still agree; the landmarks, the
    # costs and the survivor counts are held on the dense path only.
    "cg": (N_KF, False),
}
