"""The offline driver: back-to-back passes of one solver on one problem
made from the seed, as `slam-torch ba` runs them after a drive.

- `ba`: `ba.bundle_adjust(problem, cam, BAConfig(), graphs=True)` over
  the keyframes of a drive (`yardstick/synth.ba_problem`).

Set-up makes the problem, moves it to the card and runs `warm_passes`
passes (the first captures the solver's graphs). The window runs passes
from the same inputs until `--seconds` have passed, each ending in a
synchronize; `offline_pass_ms` is the window's wall time over the
passes. The last pass's output is then held to the plain reference,
run on the card in float64 once the program's graphs and state are
freed: the same LM iterations with exact solves
(`reference/ba_ref.py`), against which the program's poses and its
cost (worked out again in float64 at its poses and points) are held.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from benchmark.harness import common
from benchmark.harness.trace import Spans
from benchmark.reference import ba_ref
from benchmark.yardstick import synth


def _window(run, device, one_pass):
    """Warm passes, then the measured window of passes -> last output."""
    for _ in range(run.traffic["warm_passes"]):
        out = one_pass()
    common.sync(device)
    if run.trace:
        run.spans = Spans()
        run.spans.graphs()
    run.window_opens()
    run.window.start()
    passes = 0
    t0 = time.perf_counter()
    while True:
        out = one_pass()
        common.sync(device)
        passes += 1
        if run.window.due():
            run.window.stop()
        if time.perf_counter() - t0 >= run.seconds:
            break
    wall = time.perf_counter() - t0
    run.window.stop()
    if run.spans:
        run.spans.close()
    run.e2e["offline_pass_ms"] = 1e3 * wall / passes
    run.attempted = passes
    run.memory_peak_bytes = common.memory_peak(device)
    return out


def _ba_problem(run, device):
    tr = run.traffic
    world_seed, problem_seed = common.sub_seeds(run.seed, 2)
    d, w, p = tr["drive"], tr["world"], tr["problem"]
    cam = synth.camera(run.config)
    frames = run.config["drive_frames"]
    truth = synth.drive(d["kind"], frames, d["speed"])
    n_points = int(round(w["points_per_m"] * frames * d["speed"]))
    world = synth.make_world(world_seed, truth, n_points, cam,
                             w["patch_size"], tuple(w["z_range"]), device)
    img = run.config["image"]
    data = synth.ba_problem(
        problem_seed, world, truth, p["keyframe_every"], p["camera_rows"],
        p["obs_per_frame"], p["px_noise"], p["outlier_share"],
        p["pose_noise"], p["point_noise"],
        (img["valid_height"], img["valid_width"]))
    return cam, data


def ba(run, device):
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import ba as ba_mod
    cam, data = _ba_problem(run, device)
    cfg = dataclasses.replace(BAConfig(), **run.config.get("ba_config", {}))
    pcam = common.program_camera(cam, device)
    problem = ba_mod.make_problem(
        poses=data.poses, points=data.points, cam_idx=data.cam_idx,
        lm_idx=data.lm_idx, uv=data.uv, w=data.w, ur=data.ur,
        wr=torch.ones_like(data.w))
    problem = ba_mod.BAProblem(*[x.to(device) for x in problem])
    o, c, l = (problem.uv.shape[0], problem.poses.shape[0],
               problem.points.shape[0])
    run.info["sizes"] = {"obs": o, "cams": c, "live_cams": data.n_kf,
                         "points": l, "cg_iters": cfg.cg_iters,
                         "lm_iters": cfg.lm_iters}
    print(f"bench: BA problem {run.info['sizes']}", file=sys.stderr)

    def one_pass():
        return ba_mod.bundle_adjust(problem, pcam, cfg, graphs=True)

    out, _cost = _window(run, device, one_pass)
    poses, points = out.poses.cpu(), out.points.cpu()
    del out, _cost, problem, one_pass
    ba_mod.BA_GRAPHS.clear()
    common.free_device(device)
    inputs = [x.to(device) for x in (data.cam_idx, data.lm_idx, data.uv,
                                     data.ur, data.w)]
    P, _X, c_ref = ba_ref.lm(data.poses.to(device), data.points.to(device),
                             *inputs, cam, dataclasses.asdict(cfg))
    cost = ba_ref.full_cost(poses.to(device), points.to(device), *inputs,
                            cam, cfg.huber_delta)
    n = data.n_kf
    run.checks = {
        "pose_gap_m": float(torch.max(torch.linalg.norm(
            poses[:n, :3, 3].double() - P[:n, :3, 3].cpu(), dim=-1))),
        "cost_gap": float(abs(cost - c_ref) / c_ref)}
    run.info["cost"], run.info["cost_ref"] = float(cost), float(c_ref)
    print(f"bench: {run.info}", file=sys.stderr)
