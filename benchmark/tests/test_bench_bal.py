"""The BAL cell (`bal-venice-1778`) on the CPU at a tiny size, and its
controls on the card.

- The generator (`yardstick/bal_synth.py`): the exact sizes, one track
  histogram for every seed (Venice's: every point on 2 to 200 cameras, a
  mean of 5001946 / 993923), observations ordered by point and camera,
  every point in front of its cameras, the same seed the same problem.
- The work formulas: `yardstick/bal_bounds.py` equal to the program's
  (`slam1_tpu_torch/utils/bounds.py`).
- A sound run reads correct, and a run with the timed path broken reads
  not correct and worse than the sound one: half the observations left
  out, one camera's focal length moved 5%, k1 and k2 dropped from the
  program's projection.

The controls, on the card at the cell's size (`cost_gap`'s limit in
`traffic/bal-venice-passes.json` lies between the largest reading of
sound runs and the smallest of the controls; `cam_gap`'s, which no
limit separates, guards gross faults at twice the sound runs; PERF.md
gives the readings):

    python3 -m benchmark.tests.test_bench_bal --seeds 11,12,13

prints one JSON line of readings per seed: the plain reference itself in
float32 with the operands of every product rounded to TF32
(`ba_ref.tf32`), put in the program's place and held to the float64
reference as a run holds the program.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "bal-venice-1778"
torch.set_num_threads(1)


def _cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    conf = json.loads((ROOT / next(c["file"] for c in bench["configs"]
                                   if c["name"] == cell["config"])).read_text())
    tr = json.loads((ROOT / "benchmark" / "traffic"
                     / f"{cell['traffic']}.json").read_text())
    return conf, tr


def tiny():
    """The configuration cut to a CPU test's size: 24 cameras, 400
    points, Venice's mean track length, tracks of at most 16 cameras
    drawn from the 20 nearest."""
    conf, tr = _cell()
    conf = copy.deepcopy(conf)
    conf.update(cameras=24, points=400,
                observations=round(400 * 5001946 / 993923))
    conf["scene"].update(track_max=16, track_window=20)
    return conf, tr


def drive(seconds=0.05):
    from benchmark.harness import bal, cli, trace
    conf, tr = tiny()
    run = cli.Run(CELL, conf, tr, 2 ** 31 + 11, seconds, False,
                  time.perf_counter())
    run.window = trace.Window(False, 1.0)
    bal.passes(run, torch.device("cpu"))
    return run


def verdict(run):
    limits = run.traffic["limits"]
    vals = {n: run.checks.get(n) for n in limits}
    return all(v is not None and math.isfinite(v) and v <= limits[n]
               for n, v in vals.items()), vals


def test_track_histogram_is_venice_for_every_seed():
    from benchmark.yardstick import bal_synth
    counts = bal_synth.track_counts(993923, 5001946, 200)
    assert int(counts.sum()) == 993923 and counts[:2].sum() == 0
    assert int((counts * torch.arange(201).numpy()).sum()) == 5001946
    assert counts[200] > 0 and counts[2] > counts[3] > counts[20] > 0


def test_generator_sizes_order_and_seed():
    from benchmark.yardstick import bal_synth
    conf, _ = tiny()
    a = bal_synth.make(5, conf, "cpu")
    b = bal_synth.make(5, conf, "cpu")
    c = bal_synth.make(6, conf, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.cam_idx, c.cam_idx)
    assert a.cams.shape == (24, 9) and a.points.shape == (400, 3)
    assert a.uv.shape == (conf["observations"], 2)
    for p in (a, c):
        tracks = torch.bincount(p.lm_idx, minlength=400)
        assert tracks.min() >= 2 and tracks.max() <= 16
        key = p.lm_idx * 24 + p.cam_idx
        assert bool((key[1:] > key[:-1]).all())     # by point, then camera
    assert torch.equal(torch.bincount(torch.bincount(a.lm_idx)),
                       torch.bincount(torch.bincount(c.lm_idx)))
    for p in (a, c):
        # 1% of the observations moved 20-100 px, the rest within the noise.
        err = (p.uv.double() - bal_synth.project(
            p.true_cams[p.cam_idx], p.true_points[p.lm_idx])).norm(dim=-1)
        assert int((err > 15.0).sum()) == round(0.01 * conf["observations"])
        assert float(err.max()) < 106.0 and int((err > 6.0).sum()) == \
            int((err > 15.0).sum())
    R = bal_synth._rotation(a.true_cams[a.cam_idx, :3])
    P = (R @ a.true_points[a.lm_idx][:, :, None])[:, :, 0] \
        + a.true_cams[a.cam_idx, 3:6]
    assert bool((P[:, 2] < 0).all())
    assert float((P[:, :2].norm(dim=-1) / -P[:, 2]).max()) < 1.0


def test_work_formulas_are_the_programs():
    from benchmark.yardstick import bal_bounds
    from slam1_tpu_torch.utils import bounds
    sizes = (5001946, 1778, 993923)
    assert bal_bounds.lm_iteration_work(*sizes, 64) == \
        bounds.bal_lm_iteration_work(*sizes, 64)
    for half in ("landmarks", "cameras"):
        assert bal_bounds.schur_work(*sizes, half) == \
            bounds.bal_schur_work(*sizes, half)
    for launch in ("cameras", "landmarks", "cost"):
        assert bal_bounds.obs_work(*sizes, launch) == \
            bounds.bal_obs_work(*sizes, launch)


@pytest.fixture(scope="module")
def sound_run():
    return drive()


def test_sound_run_is_correct(sound_run):
    ok, vals = verdict(sound_run)
    assert ok, vals
    assert sound_run.attempted >= 1


def _half(monkeypatch):
    from slam1_tpu_torch.models import ba
    orig = ba.bundle_adjust

    def half(p, cam, cfg, **k):
        keep = (torch.arange(p.w.shape[0]) % 2 == 0).to(p.w.dtype)
        out, cost = orig(p._replace(w=p.w * keep), cam, cfg, **k)
        return out._replace(w=p.w), cost
    monkeypatch.setattr(ba, "bundle_adjust", half)


def _focal_moved(monkeypatch):
    from slam1_tpu_torch.models import ba
    orig = ba.bundle_adjust

    def moved(p, cam, cfg, **k):
        out, cost = orig(p, cam, cfg, **k)
        cams = out.cams.clone()
        cams[3, 6] *= 1.05
        return out._replace(cams=cams), cost
    monkeypatch.setattr(ba, "bundle_adjust", moved)


def _no_distortion(monkeypatch):
    from slam1_tpu_torch.ops import bal_obs

    def flat(fn):
        def call(cam9, X, *a):
            return fn(torch.cat([cam9[..., :7],
                                 torch.zeros_like(cam9[..., 7:])], -1),
                      X, *a)
        return call
    monkeypatch.setattr(bal_obs, "project", flat(bal_obs.project))
    monkeypatch.setattr(bal_obs, "obs_terms", flat(bal_obs.obs_terms))


@pytest.mark.parametrize("fault", [_half, _focal_moved, _no_distortion],
                         ids=["half", "focal_moved", "no_distortion"])
def test_fault_comes_out_not_correct(fault, monkeypatch, sound_run):
    fault(monkeypatch)
    broken = drive()
    ok, vals = verdict(broken)
    assert not ok, vals
    limits = broken.traffic["limits"]
    assert any(broken.checks[n] > max(limits[n], sound_run.checks[n])
               for n in limits), (vals, sound_run.checks)


def control(seed, conf, tr, device):
    """Readings of the float32 + TF32 reference against the float64 one,
    as a run reads the program."""
    from benchmark.harness import bal, cli, common
    from benchmark.reference import ba_ref, bal_ref
    from benchmark.yardstick import bal_synth
    from slam1_tpu_torch.config import BAConfig
    run = cli.Run(CELL, conf, tr, seed, 0, False, time.perf_counter())
    cfg = dataclasses.replace(BAConfig(), **conf.get("ba_config", {}))
    data = bal_synth.make(common.sub_seeds(seed, 1)[0], conf, device)
    inputs = [x.to(device) for x in (data.cam_idx, data.lm_idx, data.uv,
                                     data.w)]
    cams, points, _, _ = bal_ref.lm(data.cams, data.points, *inputs,
                                    dataclasses.asdict(cfg),
                                    dtype=torch.float32, rnd=ba_ref.tf32)
    bal.check(run, data, cams, points, cfg, device)
    return run.checks, run.info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    conf, tr = _cell()
    for seed in [int(s) for s in args.seeds.split(",")]:
        out, info = control(seed, conf, tr, torch.device("cuda"))
        print(json.dumps({"cell": CELL, "seed": seed, "control": "tf32",
                          "readings": out, "limits": tr["limits"],
                          "info": info}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
