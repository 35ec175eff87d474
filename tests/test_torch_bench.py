"""`slam-torch bench` (slam1_tpu_torch/bench.py) against the root
bench.py, on the CPU at tiny sizes.

One in-process `slam-torch bench --device cpu --tiny` is shared by the
tests below: its last line carries exactly the root bench's keys, it
leaves the tracked `.bench_baseline.json` untouched (the port caches
under its own build directory, under its own clip key), and its SLAM
half (`measure_slam` on the 40-frame loop2 clip at tiny_config(), whose
drain is synchronous) gives the ATE and loop closures of a direct
`SlamSystem` run on the same clip. The CPU reference-equivalent
baselines are held to the root bench's own on the same frames.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from slam1_tpu_torch import bench, cli
from slam1_tpu_torch.config import SlamConfig, tiny_config
from slam1_tpu_torch.models import pipeline
from slam1_tpu_torch.utils.evalmetrics import ate_rmse
from slam1_tpu_torch.utils.synthetic import make_world, render_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED_CACHE = os.path.join(REPO, ".bench_baseline.json")
# bench.py:499-519, in order.
BENCH_KEYS = ["metric", "value", "unit", "data", "vs_baseline",
              "ate_rmse_m", "ref_ate_rmse_m", "loop_closures",
              "ref_loop_closures", "vo_frames_per_s_per_chip",
              "vo_vs_baseline"]
REF_FRAMES = 8


def _root_bench():
    """The root bench.py (the JAX package's measurement), by path: its
    reference baselines are what the port's copies must reproduce."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def bench_run():
    """(exit code, stdout lines, tracked cache digest before, after) of
    one tiny bench on the CPU."""
    before = _digest(TRACKED_CACHE)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--device", "cpu", "--tiny"])
    return rc, buf.getvalue().strip().splitlines(), before, \
        _digest(TRACKED_CACHE)


def test_bench_prints_the_root_bench_line(bench_run):
    rc, lines, _, _ = bench_run
    assert rc == 0
    line = json.loads(lines[-1])
    assert list(line) == BENCH_KEYS
    assert line["metric"] == "slam_frames_per_s_per_chip"
    assert line["unit"] == "frames/s"
    assert line["data"] == f"synthetic-loop2-{bench.TINY_CLIPS['slam_frames']}"
    assert line["value"] > 0 and line["vo_frames_per_s_per_chip"] > 0
    assert np.isfinite(line["ate_rmse_m"])
    # cv2 and scikit-learn are present here: the baselines are measured.
    assert line["vs_baseline"] > 0 and line["vo_vs_baseline"] > 0
    assert line["ref_loop_closures"] is not None


def test_bench_leaves_the_tracked_baseline_alone(bench_run):
    _, _, before, after = bench_run
    assert before == after
    with open(bench.CACHE_PATH) as f:
        cache = json.load(f)
    h, w = tiny_config().image.height, tiny_config().image.width
    assert cache["clip"] == (
        f"port-loop2-{bench.TINY_CLIPS['slam_frames']}-{h}x{w}")
    assert cache["host_fp"] == bench._host_fingerprint()
    assert os.path.realpath(bench.CACHE_PATH) != os.path.realpath(
        TRACKED_CACHE)


def test_measure_slam_equals_a_direct_run(bench_run):
    """The bench's timed SLAM pass against SlamSystem fed the same clip
    by hand (frame 0, then process_block in blocks of 32)."""
    _, lines, _, _ = bench_run
    line = json.loads(lines[-1])
    cfg = tiny_config()
    assert cfg.bow.poll_lag_s == 0.0
    n = bench.TINY_CLIPS["slam_frames"]
    h, w = cfg.image.height, cfg.image.width
    world = make_world(11, n_frames=n, n_points=20 * n, trajectory="loop2",
                       speed=1.0, image_hw=(h, w), device="cpu")
    frames = [render_frame(world, i, h, w) for i in range(n)]
    L = torch.stack([a for a, _ in frames])
    R = torch.stack([b for _, b in frames])
    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=30)
    sys_.process(L[0], R[0])
    for s in range(1, n, 32):
        sys_.process_block(L[s:s + 32], R[s:s + 32])
    ate = ate_rmse(sys_.finalize(), world.poses.numpy(), align=False)
    assert round(ate, 4) == line["ate_rmse_m"]
    assert len(sys_.loop_edges) == line["loop_closures"]
    assert len(sys_.loop_edges) >= 1


def test_reference_baselines_match_the_root_bench():
    """measure_reference_slam and measure_reference of the port and of
    the root bench.py on the same frames, camera and poses (the first
    frames of the VO clip at the default canvas): the same ATE and loop
    closures, and a VO rate each. (fps is a host-clock time and is not
    compared.)"""
    root = _root_bench()
    cfg = SlamConfig()
    world = bench.make_clip_world(0, REF_FRAMES, bench.N_POINTS, "arc", cfg,
                                  "cpu")
    L, R = bench.render_chunk(world, 0, REF_FRAMES, cfg)
    L, R = L.numpy(), R.numpy()
    port = bench.measure_reference_slam(L, R, world, REF_FRAMES)
    want = root.measure_reference_slam(L, R, world, REF_FRAMES)
    assert port is not None and want is not None
    assert port[1] == want[1] and port[2] == want[2]
    assert np.isfinite(port[1]) and port[0] > 0
    vo_port = bench.measure_reference(L, R, world.cam, False, 4)
    vo_root = root.measure_reference(L, R, world.cam, False, 4)
    assert vo_port > 0 and vo_root > 0
