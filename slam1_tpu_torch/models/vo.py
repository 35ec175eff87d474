"""Stereo visual odometry: the first end-to-end slice of the port
(counterpart of `slam1_tpu/models/vo.py`).

`vo_step` runs detect -> stereo match -> triangulate -> temporal match
-> RANSAC-PnP -> pose chaining on the device of its input tensors; on
CUDA tensors the FAST and Hamming stages launch the hand-written
kernels. The state carries a `torch.Generator` for RANSAC in place of
the reference's PRNG key; tests may pass each frame's draws instead.

`vo_step` runs eagerly. On CUDA tensors `vo_block` runs each frame as
one replay of a captured CUDA graph of the step (`utils/graphs.py`), as
the reference runs one compiled program per frame: the RANSAC draws are
made from the state's generator before the replay (the same numbers, in
the same order, as `vo_step` draws), and the returned state lives in
the graph's buffers, so a state handed to `vo_block` on the card is
consumed by it (the reference donates it). The returned state carries
the graph, which the next vo_block call with the same camera and config
replays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from slam1_tpu_torch.config import SlamConfig
from slam1_tpu_torch.models.frontend import stereo_frontend
from slam1_tpu_torch.models.tracker import chain_pose, temporal_track
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.pnp import draw_uniform
from slam1_tpu_torch.types import StereoObservations
from slam1_tpu_torch.utils import graphs as graph_mod
from slam1_tpu_torch.utils.graphs import StepGraph


class VOState(NamedTuple):
    T_w_cam: torch.Tensor          # (4,4) current world-from-camera pose
    prev_obs: StereoObservations   # previous frame's triangulated features
    xi_vel: torch.Tensor           # (6,) last relative twist (motion prior)
    generator: torch.Generator     # RANSAC sampling stream
    frame: int
    graph: Optional[StepGraph] = None  # vo_block's graph on the card


class VOMetrics(NamedTuple):
    num_stereo: torch.Tensor       # triangulated stereo matches
    num_temporal: torch.Tensor     # temporal correspondences
    num_inliers: torch.Tensor
    mean_reproj_err: torch.Tensor
    pnp_ok: torch.Tensor


def init_state(left, right, cam: StereoCamera, cfg: SlamConfig,
               seed: int = 0) -> VOState:
    """Bootstrap from the first stereo pair."""
    _, obs = stereo_frontend(left, right, cam, cfg)
    gen = torch.Generator(device=left.device)
    gen.manual_seed(seed)
    return VOState(
        T_w_cam=torch.eye(4, dtype=left.dtype, device=left.device),
        prev_obs=obs,
        xi_vel=torch.zeros(6, dtype=left.dtype, device=left.device),
        generator=gen,
        frame=0,
    )


def vo_step(state: VOState, left, right, cam: StereoCamera,
            cfg: SlamConfig, u=None):
    """Process one new stereo pair; returns (new_state, metrics).
    u: optional (K,N) RANSAC draws replacing the state's generator."""
    feats, obs = stereo_frontend(left, right, cam, cfg)
    track = temporal_track(state.prev_obs, feats, cam, cfg,
                           xi_prior=state.xi_vel,
                           generator=None if u is not None
                           else state.generator, u=u)
    T_w, xi_used = chain_pose(state.T_w_cam, track.pnp, state.xi_vel)
    new_state = VOState(T_w_cam=T_w, prev_obs=obs, xi_vel=xi_used,
                        generator=state.generator, frame=state.frame + 1,
                        graph=state.graph)
    metrics = VOMetrics(
        num_stereo=torch.sum(obs.mask),
        num_temporal=track.num_candidates,
        num_inliers=track.pnp.num_inliers,
        mean_reproj_err=track.pnp.mean_err,
        pnp_ok=track.pnp.ok,
    )
    return new_state, metrics


def _graphed_step(cam: StereoCamera, cfg: SlamConfig):
    """vo_step as a StepGraph's function: ((T_w_cam, prev_obs, xi_vel),
    left, right, draws) -> (the same three, metrics)."""
    def step(carry, left, right, u):
        s, m = vo_step(VOState(*carry, generator=None, frame=0), left,
                       right, cam, cfg, u=u)
        return (s.T_w_cam, s.prev_obs, s.xi_vel), m
    return step


def _step_graph(state: VOState, cam: StereoCamera, cfg: SlamConfig):
    """The graph vo_block replays: the state's own, or a new one where
    the state has none or one made for another camera or config."""
    g = state.graph
    if g is not None and g.key[0] is cam and g.key[1] == cfg:
        return g
    return StepGraph(_graphed_step(cam, cfg), "vo_step", key=(cam, cfg))


def vo_block(state: VOState, lefts, rights, cam: StereoCamera,
             cfg: SlamConfig, draws=None):
    """K frames of VO. Returns (state, poses (K,4,4), metrics stacked
    over K). On CUDA tensors one graph replay per frame into poses and
    metrics allocated once per call; on the CPU a loop over vo_step."""
    if graph_mod.graphed(lefts):
        return _vo_block_graphed(state, lefts, rights, cam, cfg, draws)
    poses, ms = [], []
    for i in range(lefts.shape[0]):
        state, m = vo_step(state, lefts[i], rights[i], cam, cfg,
                           u=None if draws is None else draws[i])
        poses.append(state.T_w_cam)
        ms.append(m)
    return state, torch.stack(poses), VOMetrics(
        *[torch.stack(v) for v in zip(*ms)])


def _vo_block_graphed(state, lefts, rights, cam, cfg, draws):
    k = lefts.shape[0]
    n = state.prev_obs.mask.shape[0]
    graph = _step_graph(state, cam, cfg)
    carry = (state.T_w_cam, state.prev_obs, state.xi_vel)
    poses = torch.empty((k, 4, 4), dtype=lefts.dtype, device=lefts.device)
    cols = None
    for i in range(k):
        u = (draws[i].to(device=lefts.device, dtype=lefts.dtype)
             if draws is not None else
             draw_uniform(cfg.tracking.ransac_iters, n, state.generator,
                          lefts.device))
        carry, m = graph(carry, lefts[i], rights[i], u)
        if cols is None:
            cols = [torch.empty((k,) + v.shape, dtype=v.dtype,
                                device=v.device) for v in m]
        # Both live in the graph's buffers until the next replay.
        poses[i].copy_(carry[0])
        for col, v in zip(cols, m):
            col[i].copy_(v)
    return (VOState(*carry, generator=state.generator,
                    frame=state.frame + k, graph=graph), poses,
            VOMetrics(*cols))


def run_sequence(lefts, rights, cam: StereoCamera, cfg: SlamConfig,
                 seed: int = 0, draws=None):
    """Host driver: sequential VO over (F,H,W) stacks.

    draws: optional sequence of F-1 (K,N) RANSAC draw arrays, one per
    tracked frame. Returns (poses (F,4,4) numpy, list of F-1 VOMetrics
    of numpy scalars). Per-frame outputs stay on the device and come
    back in one transfer at the end.
    """
    state = init_state(lefts[0], rights[0], cam, cfg, seed)
    if lefts.shape[0] < 2:
        return state.T_w_cam[None].cpu().numpy(), []
    state, poses, m = vo_block(
        state, lefts[1:], rights[1:], cam, cfg, draws=draws)
    poses = torch.cat([torch.eye(4, dtype=poses.dtype,
                                 device=poses.device)[None], poses])
    poses = poses.cpu().numpy()
    cols = [v.cpu().numpy() for v in m]
    metrics = [VOMetrics(*[np.asarray(c[i]) for c in cols])
               for i in range(poses.shape[0] - 1)]
    return poses, metrics
