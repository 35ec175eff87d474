"""Checkpoints of the port: `utils/checkpoint.py` and `SlamSystem`'s
`save_checkpoint` / `resume` / `runtime.checkpoint_every`.

Port against port on the CPU (the file layout is the port's own): a tree
round-trips exactly, a file that does not fit the tree it is loaded into
is rejected, the cadence writes `ckpt_%06d.npz`, and a run resumed from
frame 16 of the 36-frame loop clip (local BA on, loop closure, draws from
the system's own generator) ends exactly where the straight run ends.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline
from slam1_tpu_torch.utils import checkpoint, synthetic
from slam1_tpu_torch.utils.tree import flatten
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 36
EVERY = 16


class Pair(tuple):
    pass


def _tree():
    from slam1_tpu_torch.models.posegraph import PoseGraph
    g = torch.Generator().manual_seed(3)
    graph = PoseGraph(poses=torch.randn(5, 4, 4, generator=g),
                      ei=torch.arange(4), ej=torch.arange(1, 5),
                      z=torch.randn(4, 4, 4, generator=g),
                      w=torch.tensor([1.0, 0.0, 2.0, 3.0]))
    return (graph, 7, (torch.tensor([True, False]),
                       torch.arange(6, dtype=torch.uint8).reshape(2, 3)))


def test_tree_round_trip(tmp_path):
    tree = _tree()
    path = str(tmp_path / "sub" / "tree.npz")
    checkpoint.save(path, tree, meta={"note": "x", "edges": [[1, 2.5]]})
    like = (tree[0]._replace(poses=torch.zeros(5, 4, 4)), 0,
            (torch.zeros(2, dtype=torch.bool),
             torch.zeros((2, 3), dtype=torch.uint8)))
    back = checkpoint.load(path, like)
    assert type(back[0]) is type(tree[0]) and back[1] == 7
    assert isinstance(back[1], int)
    for a, b in zip(flatten(back), flatten(tree)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert checkpoint.load_meta(path) == {"note": "x", "edges": [[1, 2.5]]}
    with np.load(path) as data:
        header = checkpoint._header(data)
        assert header["version"] == checkpoint.SCHEMA_VERSION == 1
        assert header["n_leaves"] == 8 and "leaf_7" in data


@pytest.mark.parametrize("fault", ["leaf-count", "shape", "dtype", "version"])
def test_mismatched_tree_rejected(tmp_path, fault, monkeypatch):
    tree = _tree()
    path = str(tmp_path / "tree.npz")
    checkpoint.save(path, tree)
    graph, n, (flags, table) = tree
    like = {"leaf-count": (graph, n, (flags,)),
            "shape": (graph._replace(w=torch.zeros(5)), n, (flags, table)),
            "dtype": (graph, n, (flags, table.to(torch.int32))),
            "version": tree}[fault]
    if fault == "version":
        monkeypatch.setattr(checkpoint, "SCHEMA_VERSION", 2)
    with pytest.raises(ValueError):
        checkpoint.load(path, like)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The clip run straight through with a checkpoint every 16 frames,
    and run again from the first checkpoint."""
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    cfg = tiny_config()
    cfg = cfg.replace(runtime=dataclasses.replace(
        cfg.runtime, checkpoint_every=EVERY, checkpoint_dir=str(ckpt_dir)))
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=N_FRAMES, n_points=1200,
                                 trajectory="loop", speed=0.9,
                                 image_hw=(h, w), device="cpu")
    lefts, rights = synthetic.render_sequence(world, h, w)
    straight = pipeline.SlamSystem(world.cam, cfg, seed=5, bow_train_frame=8)
    for i in range(N_FRAMES):
        straight.process(lefts[i], rights[i])
    first = str(ckpt_dir / f"ckpt_{EVERY:06d}.npz")
    # The same cadence: a checkpoint consumes the verification its poll
    # dispatched at once, so the snapshot at frame 32 is part of the run.
    resumed = pipeline.SlamSystem.resume(first, world.cam, cfg, device="cpu")
    at_resume = dict(frame_count=resumed.frame_count,
                     frame=resumed.state.frame,
                     gen=resumed.draws.get_state().clone(),
                     last_drained=resumed._last_drained,
                     kf_at_last_ba=resumed._kf_at_last_ba)
    for i in range(EVERY + 1, N_FRAMES):
        resumed.process(lefts[i], rights[i])
    return dict(dir=ckpt_dir, first=first, straight=straight,
                resumed=resumed, at_resume=at_resume,
                p_straight=straight.finalize(), p_resumed=resumed.finalize())


def test_checkpoint_every_writes_files(runs):
    names = sorted(p.name for p in runs["dir"].iterdir())
    assert names == [f"ckpt_{f:06d}.npz" for f in (16, 32)]
    meta = checkpoint.load_meta(runs["first"])
    assert meta["frame_count"] == EVERY and meta["seed"] == 5
    assert meta["bow_trained"] and meta["kf_at_last_ba"] == 16


def test_resume_restores_bookkeeping_and_generator(runs):
    at = runs["at_resume"]
    assert at["frame_count"] == at["frame"] == at["last_drained"] == EVERY
    assert at["kf_at_last_ba"] == 16
    # the generator continues the stream of a fresh system's after 16
    # steps: the same draws as a generator run that far
    cfg = tiny_config()
    ref = pipeline.DrawSource(5, "cpu")
    ref.init(cfg.detector.max_kp)
    for _ in range(EVERY):
        ref.step(cfg.tracking.ransac_iters, cfg.detector.max_kp)
    assert torch.equal(at["gen"], ref.get_state())
    fresh = pipeline.DrawSource(5, "cpu")
    assert not torch.equal(at["gen"], fresh.get_state())
    fresh.set_state(at["gen"])
    assert torch.equal(fresh.step(4, 8).pnp, ref.step(4, 8).pnp)


def test_resume_equals_straight_run(runs):
    a, b = runs["straight"], runs["resumed"]
    np.testing.assert_array_equal(runs["p_resumed"], runs["p_straight"])
    assert len(b.metrics) == N_FRAMES - 1 - EVERY
    assert b.metrics == a.metrics[EVERY:]
    assert [(i, j) for i, j, _, _ in b.loop_edges] == \
        [(i, j) for i, j, _, _ in a.loop_edges] and len(a.loop_edges) >= 1
    for (_, _, za, _), (_, _, zb, _) in zip(a.loop_edges, b.loop_edges):
        np.testing.assert_array_equal(za, zb)
    # the windows after the checkpoint: (36 - 1) // 5 - 16 // 5 of them
    assert len(a.ba_costs) == 7 and len(b.ba_costs) == 4
    assert [float(c) for c in b.ba_costs] == [float(c)
                                              for c in a.ba_costs[3:]]
    for name in ("xyz", "valid", "count", "obs", "obs_count", "hash_slot"):
        assert torch.equal(getattr(a.state.map, name),
                           getattr(b.state.map, name)), name
    assert torch.equal(a.state.kf.poses, b.state.kf.poses)
    assert a.n_slates == b.n_slates


def test_save_checkpoint_drains_first(runs, tmp_path):
    """A snapshot taken between polls holds no undrained row: the rows
    are consumed before the state is written."""
    s = runs["straight"]
    cfg = s.cfg.replace(runtime=dataclasses.replace(s.cfg.runtime,
                                                    checkpoint_every=0))
    sys_ = pipeline.SlamSystem.resume(runs["first"], s.cam, cfg,
                                      device="cpu")
    h, w = cfg.image.height, cfg.image.width
    frame = torch.zeros(h, w)
    sys_.process(frame, frame)                  # frame 17: not a poll frame
    assert sys_._last_drained == EVERY
    path = str(tmp_path / "mid.npz")
    sys_.save_checkpoint(path)
    assert sys_._last_drained == EVERY + 1 == len(sys_.metrics) + EVERY
    assert checkpoint.load_meta(path)["frame_count"] == EVERY + 1
