"""The asynchronous drain of the port's `SlamSystem` (`bow.poll_lag_s >
0`) on the CPU: a worker thread fetches ring snapshots every
`poll_max_pending` frames and each slate's result, polls consume what
has landed.

Such runs depend on timing (when a fetch lands decides which poll
consumes it), so the checks are bounds and invariants: no metrics row
is lost or repeated, `finalize` drains what is pending, the ring never
wraps, every BA cadence window is caught up, the poses stay finite and
close to the ground truth, and the worker is shut down with the
system.
"""

import dataclasses
import gc
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline
from slam1_tpu_torch.utils import synthetic
from slam1_tpu_torch.utils.evalmetrics import ate_rmse
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 36
PENDING = 8


def _cfg(lag):
    cfg = tiny_config()
    return cfg.replace(bow=dataclasses.replace(
        cfg.bow, poll_lag_s=lag, poll_max_pending=PENDING))


@pytest.fixture(scope="module")
def clip():
    cfg = _cfg(0.0)
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=N_FRAMES, n_points=1200,
                                 trajectory="loop", speed=0.9,
                                 image_hw=(h, w), device="cpu")
    return world, synthetic.render_sequence(world, h, w)


def _fetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("slam-fetch")]


@pytest.fixture(scope="module")
def lagged(clip):
    """The clip through the asynchronous system, frame by frame, with
    what was pending just before `finalize`."""
    world, (lefts, rights) = clip
    sys_ = pipeline.SlamSystem(world.cam, _cfg(0.05), seed=5,
                               bow_train_frame=8)
    most_pending = 0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for i in range(N_FRAMES):
            sys_.process(lefts[i], rights[i])
            most_pending = max(most_pending,
                               sys_.frame_count - sys_._last_drained)
        before = dict(metrics=len(sys_.metrics),
                      last_drained=sys_._last_drained)
        poses = sys_.finalize()
    return dict(sys=sys_, poses=poses, before=before, warnings=rec,
                most_pending=most_pending)


def test_no_row_lost_and_forced_drain_at_finalize(lagged):
    sys_ = lagged["sys"]
    # polls consume in batches of >= PENDING frames, so the last frames
    # were still in the ring (or in flight) before finalize
    assert lagged["before"]["metrics"] < N_FRAMES - 1
    assert lagged["before"]["last_drained"] < N_FRAMES - 1
    assert [m.frame for m in sys_.metrics] == list(range(1, N_FRAMES))
    assert sys_._last_drained == sys_.frame_count == N_FRAMES - 1
    assert sys_._ring_inflight is None and sys_._verify_inflight is None
    assert not sys_._verifying


def test_ring_never_wraps(lagged):
    assert not [w for w in lagged["warnings"]
                if "overflowed" in str(w.message)]
    assert lagged["most_pending"] <= pipeline.ROW_RING
    # a snapshot is requested once PENDING rows wait and lands at a
    # later poll (every 4 frames): the backlog stays far below the ring
    assert lagged["most_pending"] <= 4 * PENDING


def test_backend_keeps_up(lagged, clip):
    world, (lefts, rights) = clip
    sys_ = lagged["sys"]
    assert len(sys_.ba_costs) == (N_FRAMES - 1) // 5
    assert all(np.isfinite(float(c)) for c in sys_.ba_costs)
    assert np.isfinite(lagged["poses"]).all()
    assert np.mean([m.pnp_ok for m in sys_.metrics]) >= 0.8
    ate = ate_rmse(lagged["poses"], world.poses.numpy(), align=False)
    assert ate <= 0.5, ate


def test_blocks_force_a_drain_before_the_ring_wraps(clip):
    """Blocks of 16 frames with the drain batched at 8: rows are never
    lost, whatever lands when."""
    world, (lefts, rights) = clip
    sys_ = pipeline.SlamSystem(world.cam, _cfg(0.05), seed=5,
                               bow_train_frame=8)
    sys_.process(lefts[0], rights[0])
    for s in range(1, N_FRAMES, 16):
        sys_.process_block(lefts[s:s + 16], rights[s:s + 16])
    sys_.finalize()
    assert [m.frame for m in sys_.metrics] == list(range(1, N_FRAMES))


def test_fetch_reads_a_snapshot_not_the_live_ring(clip):
    world, _ = clip
    sys_ = pipeline.SlamSystem(world.cam, _cfg(0.05))
    ring = torch.arange(12.0).reshape(3, 4)
    gate = threading.Event()
    sys_._pool.submit(gate.wait, 5.0)          # the worker is busy
    fut = sys_._fetch(ring.clone())
    ring.zero_()                               # a later step writes the ring
    gate.set()
    np.testing.assert_array_equal(fut.result(timeout=10),
                                  np.arange(12.0).reshape(3, 4))


def test_pool_shut_down_on_del(clip):
    world, _ = clip
    gc.collect()
    others = set(_fetch_threads())
    sys_ = pipeline.SlamSystem(world.cam, _cfg(0.05))
    assert sys_._fetch(torch.zeros(2)).result(timeout=10).shape == (2,)
    pool = sys_._pool
    mine = [t for t in _fetch_threads() if t not in others]
    assert len(mine) == 1
    del sys_
    gc.collect()
    assert pool._shutdown
    deadline = time.time() + 10.0
    while mine[0].is_alive() and time.time() < deadline:
        time.sleep(0.05)
    assert not mine[0].is_alive()
    # the synchronous mode starts no worker at all
    assert pipeline.SlamSystem(world.cam, _cfg(0.0))._pool is None
