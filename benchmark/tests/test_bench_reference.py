"""The plain references against the program at sizes where both are
exact: BA's LM with a dense reduced solve (the program's own path up to
16 cameras)."""

import dataclasses

import torch

from benchmark.reference import ba_ref
from benchmark.yardstick import synth

torch.set_num_threads(1)
CAM = synth.Camera(718.856, 718.856, 607.1928, 185.2157, 0.5371657)


def test_ba_reference_follows_the_programs_dense_path():
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import ba
    from slam1_tpu_torch.ops.camera import StereoCamera
    truth = synth.drive("arc", 24, 1.0)
    world = synth.make_world(4, truth, 3000, CAM)
    d = synth.ba_problem(4, world, truth, 2, 12, 256, 0.5, 0.02,
                         [0.02] * 3 + [0.002] * 3, 0.05)
    prob = ba.make_problem(poses=d.poses, points=d.points,
                           cam_idx=d.cam_idx, lm_idx=d.lm_idx, uv=d.uv,
                           w=d.w, ur=d.ur, wr=torch.ones_like(d.w))
    cfg = BAConfig()
    out, cost = ba.bundle_adjust(prob, StereoCamera.create(*CAM,
                                                           device="cpu"),
                                 cfg, graphs=False)
    P, X, c = ba_ref.lm(d.poses, d.points, d.cam_idx, d.lm_idx, d.uv, d.ur,
                        d.w, CAM, dataclasses.asdict(cfg))
    assert float(abs(float(cost) - c) / c) < 1e-3
    gap = torch.linalg.norm(out.poses[:, :3, 3].double() - P[:, :3, 3], dim=-1)
    assert float(gap.max()) < 1e-3


def test_ba_reference_follows_the_programs_cg_path():
    """Past 16 camera rows the program and the reference both take
    cg_iters block-Jacobi PCG iterations a step."""
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import ba
    from slam1_tpu_torch.ops.camera import StereoCamera
    truth = synth.drive("arc", 60, 1.0)
    world = synth.make_world(6, truth, 2400, CAM)
    d = synth.ba_problem(6, world, truth, 2, 32, 128, 0.5, 0.02,
                         [0.02] * 3 + [0.002] * 3, 0.05)
    prob = ba.make_problem(poses=d.poses, points=d.points,
                           cam_idx=d.cam_idx, lm_idx=d.lm_idx, uv=d.uv,
                           w=d.w, ur=d.ur, wr=torch.ones_like(d.w))
    cfg = BAConfig(cg_iters=8)
    out, cost = ba.bundle_adjust(prob, StereoCamera.create(*CAM,
                                                           device="cpu"),
                                 cfg, graphs=False)
    P, X, c = ba_ref.lm(d.poses, d.points, d.cam_idx, d.lm_idx, d.uv, d.ur,
                        d.w, CAM, dataclasses.asdict(cfg))
    assert float(abs(float(cost) - c) / c) < 1e-3
    gap = torch.linalg.norm(out.poses[:, :3, 3].double() - P[:, :3, 3], dim=-1)
    assert float(gap.max()) < 1e-3
    # Run to convergence instead, the steps end elsewhere: the 8
    # iterations are what the reference follows.
    ex = dict(dataclasses.asdict(cfg), cg_iters=10 ** 4)
    P2, _, _ = ba_ref.lm(d.poses, d.points, d.cam_idx, d.lm_idx, d.uv, d.ur,
                         d.w, CAM, ex)
    assert float(torch.linalg.norm(P2[:, :3, 3] - P[:, :3, 3],
                                   dim=-1).max()) > 100 * float(gap.max())
