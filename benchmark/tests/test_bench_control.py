"""The controls: what the numbers compared read when the computation
steps one precision below the configuration's (float32 with TF32 off,
`slam1_tpu_torch/runtime.py`): TF32.

- `ba-global-2048`: the plain reference itself in float32, with the
  operands of every product rounded to TF32 (`ba_ref.tf32`: a TF32
  tensor-core product reads no more of them; cuBLAS runs the small
  batched products on other paths, so the switch alone would leave
  them float32), put in the program's place and held to the float64
  reference as a run holds the program (pose gap, cost gap at its
  output).
- `slam-live-10hz`: the program with TF32 switched on (the path its
  runtime pins off), driven through the cell's run and checked against
  the ground truth as a run is.

On the card at the cell's own size:

    python3 -m benchmark.tests.test_bench_control --cell ba-global-2048 \
        --seeds 11,12,13

prints one JSON line of readings per seed. As a test it runs the BA
control at a small size on the CPU (the rounding is emulated).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _cell(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = json.loads((ROOT / next(c["file"] for c in bench["configs"]
                                   if c["name"] == cell["config"])).read_text())
    tr = json.loads((ROOT / "benchmark" / "traffic"
                     / f"{cell['traffic']}.json").read_text())
    return conf, tr


def ba_control(seed, conf, tr, device):
    """Readings of the float32 + TF32 reference against the float64 one."""
    from benchmark.harness import cli, offline
    from benchmark.reference import ba_ref
    run = cli.Run("ba", conf, tr, seed, 0, False, time.perf_counter())
    cam, data = offline._ba_problem(run, device)
    from slam1_tpu_torch.config import BAConfig
    cfg = dataclasses.asdict(dataclasses.replace(
        BAConfig(), **conf.get("ba_config", {})))
    inputs = [x.to(device) for x in (data.cam_idx, data.lm_idx, data.uv,
                                     data.ur, data.w)]
    P, _X, c_ref = ba_ref.lm(data.poses.to(device), data.points.to(device),
                             *inputs, cam, cfg)
    P32, X32, _c = ba_ref.lm(data.poses.to(device), data.points.to(device),
                             *inputs, cam, cfg, dtype=torch.float32,
                             rnd=ba_ref.tf32)
    cost = ba_ref.full_cost(P32, X32, *inputs, cam, cfg["huber_delta"])
    n = data.n_kf
    return {"pose_gap_m": float(torch.max(torch.linalg.norm(
        P32[:n, :3, 3].double() - P[:n, :3, 3], dim=-1))),
        "cost_gap": float(abs(cost - c_ref) / c_ref)}


def slam_control(cell, seed, seconds, device):
    """A run of the SLAM cell with the program's TF32 switched on."""
    from benchmark.harness import cli, slam, trace
    import slam1_tpu_torch.runtime  # noqa: F401  (pins TF32 off at import)
    conf, tr = _cell(cell)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    run = cli.Run(cell, conf, tr, seed, seconds, False, time.perf_counter())
    run.window = trace.Window(False, 1.0)
    getattr(slam, tr["driver"].split(".")[1])(run, device)
    return dict(run.checks)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    conf, tr = _cell(args.cell)
    for seed in [int(s) for s in args.seeds.split(",")]:
        if tr["driver"] == "offline.ba":
            out = ba_control(seed, conf, tr, device)
        else:
            out = slam_control(args.cell, seed, args.seconds, device)
        print(json.dumps({"cell": args.cell, "seed": seed, "control": "tf32",
                          "readings": out, "limits": tr["limits"]}),
              flush=True)


def test_ba_control_fails_its_limits():
    conf, tr = _cell("ba-global-2048")
    conf, tr = copy.deepcopy(conf), copy.deepcopy(tr)
    conf["drive_frames"] = 120
    tr["problem"]["camera_rows"] = 64
    out = ba_control(5, conf, tr, torch.device("cpu"))
    assert any(out[n] > lim for n, lim in tr["limits"].items()), out


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
