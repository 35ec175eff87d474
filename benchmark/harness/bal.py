"""The BAL driver: back-to-back bundle adjustment passes over one BAL
problem made from the seed, as `slam-torch bal` runs one.

- `passes`: `ba.bundle_adjust(problem, (), BAConfig(), model=ba.BAL)`
  over the configuration's problem (`yardstick/bal_synth.make`), on the
  card: its graphs `bal_lm` and `bal_cost`.

Set-up makes the problem on the card and runs `warm_passes` passes (the
first captures the graphs). The window runs passes from the same inputs
until `--seconds` have passed, each ending in a synchronize;
`offline_pass_ms` is the window's wall time over the passes. The last
pass's output is then held to the plain reference, run on the card in
float64 once the program's graphs and state are freed
(`reference/bal_ref.py`: the same LM iterations and PCG, matrix-free):
`cost_gap`, the program's full cost (worked out again in float64 at its
cameras and points) against the reference's, relative; `cam_gap`, the
largest over the cameras of the distance between the program's camera
centres and the reference's after the least-squares similarity of the
first onto the second (the gauge is free), over the scene's median
depth.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from benchmark.harness import common, offline
from benchmark.reference import bal_ref
from benchmark.yardstick import bal_synth


def centres(cams):
    """Camera centres -R^T t (C,3) of BAL cameras (C,9), float64."""
    R = bal_ref.rotation(cams[:, :3].double())
    return -(R.transpose(1, 2) @ cams[:, 3:6].double()[:, :, None])[:, :, 0]


def aligned_distances(a, b):
    """|s R a_i + t - b_i| (N,) after the least-squares similarity
    (Umeyama) of the points a (N,3) onto b (N,3)."""
    ma, mb = a.mean(0), b.mean(0)
    A, B = a - ma, b - mb
    U, S, Vt = torch.linalg.svd(B.T @ A)
    d = torch.ones(3, dtype=a.dtype, device=a.device)
    d[2] = torch.sign(torch.det(U @ Vt))
    R = U @ torch.diag(d) @ Vt
    s = (S * d).sum() / (A * A).sum()
    return torch.linalg.norm(s * A @ R.T + mb - b, dim=-1)


def median_depth(cams, points, cam_idx, lm_idx) -> float:
    """The median over the observations of the point's depth -P_z in its
    camera."""
    P = (bal_ref.rotation(cams[cam_idx, :3].double())
         @ points[lm_idx].double()[:, :, None])[:, :, 0] \
        + cams[cam_idx, 3:6].double()
    return float(torch.median(-P[:, 2]))


def check(run, data, cams, points, cfg, device):
    """run.checks of the program's (cams, points) against the float64
    reference from the problem's start."""
    inputs = [x.to(device) for x in (data.cam_idx, data.lm_idx, data.uv,
                                     data.w)]
    R_cams, R_points, c_ref, _ = bal_ref.lm(
        data.cams.to(device), data.points.to(device), *inputs,
        dataclasses.asdict(cfg), dtype=torch.float64)
    cost = bal_ref.full_cost(cams.to(device), points.to(device), *inputs,
                             cfg.huber_delta)
    depth = median_depth(R_cams, R_points, inputs[0], inputs[1])
    gaps = aligned_distances(centres(cams.to(device)), centres(R_cams)) / depth
    q = torch.quantile(gaps, torch.tensor([0.5, 0.9, 0.99], dtype=gaps.dtype,
                                          device=gaps.device))
    run.checks = {"cost_gap": float(abs(cost - c_ref) / c_ref),
                  "cam_gap": float(gaps.max())}
    run.info.update(cost=float(cost), cost_ref=float(c_ref),
                    median_depth_m=depth,
                    cam_gap_p50_p90_p99=[float(x) for x in q])


def passes(run, device):
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import ba, bal
    model = ba.BAL            # a program without BAL's camera model stops
    cfg = dataclasses.replace(BAConfig(), **run.config.get("ba_config", {}))
    data = bal_synth.make(common.sub_seeds(run.seed, 1)[0], run.config,
                          device)
    problem = bal.BalProblem(*data[:6])
    run.info["sizes"] = {"obs": problem.uv.shape[0],
                         "cams": problem.cams.shape[0],
                         "points": problem.points.shape[0],
                         "cg_iters": cfg.cg_iters, "lm_iters": cfg.lm_iters}
    print(f"bench: BAL problem {run.info['sizes']}", file=sys.stderr)

    def one_pass():
        return ba.bundle_adjust(problem, (), cfg, graphs=True, model=model)

    out, _cost = offline._window(run, device, one_pass)
    cams, points = out.cams.cpu(), out.points.cpu()
    del out, _cost, problem, one_pass
    ba.BA_GRAPHS.clear()
    common.free_device(device)
    check(run, data, cams, points, cfg, device)
    print(f"bench: {run.info}", file=sys.stderr)
