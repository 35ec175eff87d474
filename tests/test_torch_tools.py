"""The port's measurement tools (tools/port_*.py) on the CPU at tiny
sizes: each gives a record with the keys of its JAX counterpart's
record file, and each refuses to run where its default device, the
card, is missing.

One tiny `port_global_ba_scale` run (40 frames, keyframe_every=2) with
its checkpoint is shared: `port_dist_ba_scale` runs on it at two gloo
ranks (tests/torch_dist_ranks.py), `port_loop_grid` at one hit.
"""

import contextlib
import io
import json
import math
import os

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from torch_dist_ranks import run_ranks

from tools import (port_dist_ba_scale, port_global_ba_scale, port_loop_grid,
                   port_multihost_smoke, port_profile_ablate,
                   port_profile_slam, port_profile_stage, port_roofline,
                   port_two_view_pairs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 40
TOOLS = (port_global_ba_scale, port_dist_ba_scale, port_multihost_smoke,
         port_loop_grid, port_roofline, port_profile_stage,
         port_profile_slam, port_profile_ablate, port_two_view_pairs)


def _keys(name):
    with open(os.path.join(REPO, name)) as f:
        return set(json.load(f))


def _run(tool, argv):
    """tool.main(argv) in process: (exit code, its last stdout line as
    JSON)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def scale_run(tmp_path_factory):
    """(record, checkpoint path) of the tiny global-BA scale run."""
    ckpt = str(tmp_path_factory.mktemp("gba") / "gba.npz")
    rc, rec = _run(port_global_ba_scale,
                   ["--device", "cpu", "--tiny", "--frames", str(FRAMES),
                    "--ckpt", ckpt])
    assert rc == 0
    return rec, ckpt


@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: t.__name__)
def test_tools_default_to_the_card(tool):
    """Without --device a tool runs on the card; where there is none it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


def test_global_ba_scale_record(scale_run):
    rec, ckpt = scale_run
    assert _keys("BENCH_GLOBAL.json") <= set(rec)
    assert rec["backend"] == "cpu" and rec["frames"] == FRAMES
    assert rec["data"] == f"synthetic-loop2-{FRAMES}"
    assert 0 < rec["keyframes"] <= rec["bucket"]
    assert rec["global_ba_observations"] > 0
    assert len(rec["ba_cost_trace"]) == rec["lm_iters"]
    assert math.isfinite(rec["cost_after"])
    assert rec["cost_after"] <= rec["cost_before"]
    assert rec["kf_ate_after_m"] <= 1.05 * rec["kf_ate_before_m"]
    assert os.path.exists(ckpt)


def test_global_ba_scale_from_checkpoint(scale_run):
    """--from-ckpt runs the backend stages on the saved state: the same
    keyframes and the same global BA as the straight run."""
    rec, ckpt = scale_run
    rc, again = _run(port_global_ba_scale,
                     ["--device", "cpu", "--tiny", "--frames", str(FRAMES),
                      "--from-ckpt", ckpt])
    assert rc == 0
    assert "pipeline_fps" not in again
    for k in ("keyframes", "bucket", "global_ba_observations",
              "cost_before", "cost_after", "loop_closures"):
        assert again[k] == rec[k], k


def test_dist_ba_scale_two_gloo_ranks(scale_run, tmp_path):
    _, ckpt = scale_run
    out = run_ranks(2, ["dist_ba_scale"], {"dist_ba_scale": {
        "ckpt": ckpt, "lm_iters": 3, "cg_iters": 16}}, tmp_path)
    rec = out[0]["dist_ba_scale"]["record"]
    assert out[1]["dist_ba_scale"]["record"] is None
    assert _keys("DIST_BA_SCALE.json") <= set(rec)
    assert rec["shards"] == 2 and rec["n_dropped"] == 0
    assert rec["backend"] == "gloo"
    assert rec["rel_cost_parity"] < 5e-2
    assert len(rec["cost_trace_dist"]) == 3


def test_loop_grid_record(scale_run):
    _, ckpt = scale_run
    rc, rec = _run(port_loop_grid,
                   ["--device", "cpu", "--tiny", "--ckpt", ckpt, "--frames",
                    str(FRAMES), "--hits", str(FRAMES - 1), "--span", "2"])
    assert rc == 0
    (hit,) = rec["hits"]
    assert hit["hit"] == FRAMES - 1 and hit["anchor"] <= FRAMES - 1
    assert len(hit["cands"]) == len(hit["inliers"]) > 0
    assert all(i >= 0 for i in hit["inliers"])


def test_roofline_record():
    rc, rec = _run(port_roofline, ["--device", "cpu", "--tiny"])
    assert rc == 0
    with open(os.path.join(REPO, "PROFILE_r05.json")) as f:
        want = json.load(f)
    assert set(want) <= set(rec)
    assert len(rec["kernels"]) == 4
    for k in rec["kernels"]:
        assert set(want["kernels"][0]) <= set(k)
        assert k["time_us"] > 0 and k["sol_us"] > 0
        assert k["bound"] in ("bytes", "operations")


@pytest.mark.parametrize("tool,key", [(port_profile_stage, "stages_ms"),
                                      (port_profile_slam, "stages_ms"),
                                      (port_profile_ablate, "combos_ms")],
                         ids=lambda x: getattr(x, "__name__", x))
def test_profile_records(tool, key):
    rc, rec = _run(tool, ["--device", "cpu", "--tiny", "--reps", "1"])
    assert rc == 0 and rec["device"] == "cpu"
    assert rec[key] and all(math.isfinite(v) and v > 0
                            for v in rec[key].values())
