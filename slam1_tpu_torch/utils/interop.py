"""Carry state across from the JAX package.

Each function takes one of `slam1_tpu`'s NamedTuples whose leaves have
been exported as numpy arrays (`jax.device_get` / `np.asarray`) and
returns the port's counterpart on `device`. Nothing here imports jax:
the inputs are plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from slam1_tpu_torch.models.ba import BAProblem
from slam1_tpu_torch.models.bow import BowState
from slam1_tpu_torch.models.mapping import KeyframeStore, MapState
from slam1_tpu_torch.models.pipeline import SlamState
from slam1_tpu_torch.models.vo import VOState
from slam1_tpu_torch.models.vo_flow import FlowVOState
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.runtime import default_device
from slam1_tpu_torch.types import Features, StereoObservations
from slam1_tpu_torch.utils.synthetic import SyntheticWorld


def tensor(a, device=None) -> torch.Tensor:
    """numpy array (or scalar) -> tensor on `device`, dtype kept (a
    copy: exported arrays may be read-only)."""
    return torch.as_tensor(np.array(a), device=default_device(device))


def _convert(nt, cls, device):
    return cls(*[tensor(v, device) for v in nt])


def camera(cam_np, device=None) -> StereoCamera:
    return _convert(cam_np, StereoCamera, device)


def features(f_np, device=None) -> Features:
    return _convert(f_np, Features, device)


def observations(o_np, device=None) -> StereoObservations:
    return _convert(o_np, StereoObservations, device)


def world(w_np, device=None) -> SyntheticWorld:
    return SyntheticWorld(points=tensor(w_np.points, device),
                          patches=tensor(w_np.patches, device),
                          poses=tensor(w_np.poses, device),
                          cam=camera(w_np.cam, device))


def vo_state(s_np, device=None, seed: int = 0) -> VOState:
    """The reference's VOState without its PRNG key: the port's state
    gets a fresh generator seeded with `seed`."""
    device = default_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return VOState(T_w_cam=tensor(s_np.T_w_cam, device),
                   prev_obs=observations(s_np.prev_obs, device),
                   xi_vel=tensor(s_np.xi_vel, device), generator=gen,
                   frame=int(np.asarray(s_np.frame)))


def flow_vo_state(s_np, device=None, seed: int = 0) -> FlowVOState:
    """The reference's FlowVOState without its PRNG key: the port's state
    gets a fresh generator seeded with `seed`."""
    device = default_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return FlowVOState(
        *[tensor(getattr(s_np, k), device) for k in FlowVOState._fields[:7]],
        generator=gen, frame=int(np.asarray(s_np.frame)))


def map_state(m_np, device=None) -> MapState:
    return _convert(m_np, MapState, device)


def kf_store(k_np, device=None) -> KeyframeStore:
    return _convert(k_np, KeyframeStore, device)


def bow_state(b_np, device=None) -> BowState:
    return _convert(b_np, BowState, device)


def slam_state(s_np, device=None) -> SlamState:
    """The reference's SlamState without its PRNG key (the port's draws
    come from a DrawSource)."""
    return SlamState(
        T_w_cam=tensor(s_np.T_w_cam, device),
        prev_obs=observations(s_np.prev_obs, device),
        xi_vel=tensor(s_np.xi_vel, device),
        frame=tensor(s_np.frame, device),
        map=map_state(s_np.map, device), kf=kf_store(s_np.kf, device),
        bow=bow_state(s_np.bow, device),
        traj=tensor(s_np.traj, device), rel=tensor(s_np.rel, device),
        rel_mask=tensor(s_np.rel_mask, device),
        last_kf_frame=tensor(s_np.last_kf_frame, device),
        last_kf_pos=tensor(s_np.last_kf_pos, device),
        prev_lm=tensor(s_np.prev_lm, device), rows=tensor(s_np.rows, device))


def ba_problem(p_np, device=None) -> BAProblem:
    """The reference's BAProblem (a BA problem's twelve arrays), index
    arrays widened to int64."""
    p = _convert(p_np, BAProblem, device)
    return p._replace(cam_idx=p.cam_idx.long(), lm_idx=p.lm_idx.long(),
                      pe_i=p.pe_i.long(), pe_j=p.pe_j.long())
