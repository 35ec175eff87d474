"""Alternative stereo VO frontend: FAST corners + LK optical flow + dense
disparity (counterpart of `slam1_tpu/models/vo_flow.py`).

No descriptors: temporal correspondence comes from pyramidal LK
(`ops/lk.py`), stereo correspondence from the dense SGM disparity map
(`ops/disparity.py`), and the pose from `ops/pnp.ransac_pnp` on the
previous frame's triangulated corners against their tracks. Corners come
from the one-level `detect`, whose FAST score map is one launch of the
hand-written kernel per frame on CUDA tensors.

The state carries a `torch.Generator` for RANSAC in place of the
reference's PRNG key; `vo_step` may take the frame's draws instead.

`vo_step` runs eagerly. On CUDA tensors `run_sequence` runs each frame
after the first as one replay of a captured CUDA graph of the step
(`utils/graphs.py`), as the reference runs one compiled program per
frame: the RANSAC draws are made from the state's generator before the
replay (the same numbers, in the same order, as `vo_step` draws), and
the step's launches (the SGM column loop, LK's iterations, RANSAC-PnP)
become the graph's nodes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam1_tpu_torch.config import SlamConfig
from slam1_tpu_torch.models.tracker import chain_pose
from slam1_tpu_torch.ops import disparity as disp_ops
from slam1_tpu_torch.ops import lk, pnp, triangulate
from slam1_tpu_torch.ops.brief import gaussian_blur
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.detector import detect
from slam1_tpu_torch.utils import graphs as graph_mod
from slam1_tpu_torch.utils.graphs import StepGraph


class FlowVOState(NamedTuple):
    T_w_cam: torch.Tensor     # (4,4) world-from-camera
    prev_left: torch.Tensor   # (H,W) previous left image, LK-smoothed
    prev_xy: torch.Tensor     # (N,2) keypoints detected in prev left
    prev_mask: torch.Tensor   # (N,)
    prev_disp: torch.Tensor   # (H,W) previous disparity map
    prev_dvalid: torch.Tensor
    xi_vel: torch.Tensor      # (6,) motion prior
    generator: torch.Generator  # RANSAC sampling stream
    frame: int


class FlowVOMetrics(NamedTuple):
    num_tracked: torch.Tensor
    num_stereo: torch.Tensor
    num_inliers: torch.Tensor
    mean_reproj_err: torch.Tensor
    pnp_ok: torch.Tensor


def _detect_corners(img, cfg: SlamConfig):
    f = detect(img[None], cfg.detector, cfg.image.valid_height,
               cfg.image.valid_width)
    return f.xy[0], f.mask[0]


def _smooth_for_lk(img, cfg: SlamConfig):
    s = cfg.flow.blur_sigma
    return gaussian_blur(img, s) if s > 0 else img


def _dense_disparity(left, right, cfg: SlamConfig):
    d = cfg.disparity
    return disp_ops.disparity(left, right, max_disp=d.max_disp,
                              radius=d.radius, sgm=d.sgm, p1=d.p1, p2=d.p2,
                              lr_check=d.lr_check, lr_tol=d.lr_tol,
                              uniq_ratio=d.uniq_ratio)


def init_state(left, right, cam: StereoCamera, cfg: SlamConfig,
               seed: int = 0) -> FlowVOState:
    """Bootstrap: frame-0 corners and frame-0 disparity."""
    xy, mask = _detect_corners(left, cfg)
    d = _dense_disparity(left, right, cfg)
    gen = torch.Generator(device=left.device)
    gen.manual_seed(seed)
    return FlowVOState(
        T_w_cam=torch.eye(4, dtype=left.dtype, device=left.device),
        prev_left=_smooth_for_lk(left, cfg), prev_xy=xy, prev_mask=mask,
        prev_disp=d.disp, prev_dvalid=d.valid,
        xi_vel=torch.zeros(6, dtype=left.dtype, device=left.device),
        generator=gen, frame=0)


def vo_step(state: FlowVOState, left, right, cam: StereoCamera,
            cfg: SlamConfig, u=None):
    """Process one stereo pair -> (new_state, metrics): track the previous
    corners, gate both endpoints by the held disparity, triangulate the
    PREVIOUS frame's points and solve PnP against the CURRENT tracks.
    u: optional (K,N) RANSAC draws replacing the state's generator."""
    fcfg = cfg.flow
    left_s = _smooth_for_lk(left, cfg)

    tr = lk.lk_track(state.prev_left, left_s, state.prev_xy, state.prev_mask,
                     win=fcfg.win, levels=fcfg.levels, iters=fcfg.iters,
                     max_err=fcfg.max_err)
    q1, q2 = state.prev_xy, tr.xy

    # Right-image coordinates of the previous frame's corners from the
    # held disparity map.
    prev_d = disp_ops.DisparityResult(state.prev_disp, state.prev_dvalid)
    d1, d1_ok = disp_ops.sample_disparity(prev_d, q1)
    stereo_ok = tr.mask & d1_ok & (d1 > 0.0) \
        & (d1 < cfg.disparity.max_disp - 1.0)
    uv_r1 = q1 - torch.stack([d1, torch.zeros_like(d1)], dim=-1)

    X1, tri_ok = triangulate.stereo_rectified(
        cam, q1, uv_r1, min_disparity=cfg.matcher.min_disparity)
    corr_ok = stereo_ok & tri_ok
    res = pnp.ransac_pnp(X1, q2, corr_ok, cam, cfg.tracking,
                         xi_init=state.xi_vel,
                         generator=None if u is not None else state.generator,
                         u=u)
    T_w, xi_used = chain_pose(state.T_w_cam, res, state.xi_vel)

    # Next state: fresh corners and disparity of the new frame.
    xy, mask = _detect_corners(left, cfg)
    d = _dense_disparity(left, right, cfg)
    new_state = FlowVOState(
        T_w_cam=T_w, prev_left=left_s, prev_xy=xy, prev_mask=mask,
        prev_disp=d.disp, prev_dvalid=d.valid, xi_vel=xi_used,
        generator=state.generator, frame=state.frame + 1)
    metrics = FlowVOMetrics(
        num_tracked=torch.sum(tr.mask),
        num_stereo=torch.sum(corr_ok),
        num_inliers=res.num_inliers,
        mean_reproj_err=res.mean_err,
        pnp_ok=res.ok)
    return new_state, metrics


def _graphed_step(cam: StereoCamera, cfg: SlamConfig):
    """vo_step as a StepGraph's function: (the state's tensor leaves,
    left, right, draws) -> (the same leaves, metrics)."""
    def step(carry, left, right, u):
        s, m = vo_step(FlowVOState(*carry, generator=None, frame=0), left,
                       right, cam, cfg, u=u)
        return tuple(s)[:-2], m
    return step


def _run_graphed(state: FlowVOState, lefts, rights, cam: StereoCamera,
                 cfg: SlamConfig, draws=None):
    """Frames 1.. of (F,H,W) CUDA stacks from `state`, one graph call per
    frame: the first is the graph's warm-up step and capture, each later
    one a replay. Returns (state, graph, poses (F-1,4,4), metrics stacked
    over F-1); the state's tensors are the graph's static state."""
    f = lefts.shape[0]
    n = state.prev_xy.shape[0]
    graph = StepGraph(_graphed_step(cam, cfg), "flow_vo_step")
    carry = tuple(state)[:-2]        # all but generator and frame
    poses = torch.empty((f - 1, 4, 4), dtype=lefts.dtype, device=lefts.device)
    cols = None
    for i in range(1, f):
        u = (draws[i - 1].to(device=lefts.device, dtype=lefts.dtype)
             if draws is not None else
             pnp.draw_uniform(cfg.tracking.ransac_iters, n, state.generator,
                              lefts.device))
        carry, m = graph(carry, lefts[i], rights[i], u)
        if cols is None:
            cols = [torch.empty((f - 1,) + v.shape, dtype=v.dtype,
                                device=v.device) for v in m]
        # Both live in the graph's buffers until the next replay.
        poses[i - 1].copy_(carry[0])
        for col, v in zip(cols, m):
            col[i - 1].copy_(v)
    return (FlowVOState(*carry, generator=state.generator,
                        frame=state.frame + f - 1), graph, poses,
            FlowVOMetrics(*cols))


def run_sequence(lefts, rights, cam: StereoCamera, cfg: SlamConfig,
                 seed: int = 0, draws=None):
    """Host driver over (F,H,W) stacks -> (poses (F,4,4) numpy, list of
    F-1 FlowVOMetrics of numpy scalars). draws: optional sequence of F-1
    (K,N) RANSAC draw arrays. On CUDA tensors every frame after the
    first is one replay of the step's CUDA graph; on the CPU a loop of
    vo_step. Per-frame outputs stay on the device and come back in one
    transfer at the end."""
    state = init_state(lefts[0], rights[0], cam, cfg, seed)
    if lefts.shape[0] < 2:
        return state.T_w_cam[None].cpu().numpy(), []
    if graph_mod.graphed(lefts):
        _, _, poses, m = _run_graphed(state, lefts, rights, cam, cfg, draws)
    else:
        poses, ms = [], []
        for i in range(1, lefts.shape[0]):
            state, mi = vo_step(state, lefts[i], rights[i], cam, cfg,
                                u=None if draws is None else draws[i - 1])
            poses.append(state.T_w_cam)
            ms.append(mi)
        poses = torch.stack(poses)
        m = FlowVOMetrics(*[torch.stack(v) for v in zip(*ms)])
    poses = torch.cat([torch.eye(4, dtype=poses.dtype,
                                 device=poses.device)[None], poses])
    poses = poses.cpu().numpy()
    cols = [v.cpu().numpy() for v in m]
    return poses, [FlowVOMetrics(*[np.asarray(c[i]) for c in cols])
                   for i in range(poses.shape[0] - 1)]
