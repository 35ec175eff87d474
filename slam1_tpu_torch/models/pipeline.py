"""Full SLAM driver: VO + mapping + BoW + place recognition + loop
closure + pose-graph backend (counterpart of
`slam1_tpu/models/pipeline.py`).

Per frame, `slam_step` runs the frontend, temporal tracking, PnP, pose
chaining, the keyframe policy, map insertion, landmark culling and the
BoW histogram + loop-candidate query on the device of its inputs, and
writes one packed metrics row into a device-side ring. It reads nothing
back to the host beyond what `vo_step` reads, so the camera loop never
waits on the device. The host-side `SlamSystem` drains the ring at a
fixed cadence (one transfer per drain), triggers loop verification on
the drained rows, and relaxes the pose graph on accepted loops.

Fixed-cadence backend launches ride on the drains: windowed local BA
every `ba.local_every` keyframes (`local_ba_step`), pose-graph
relaxation on accepted loops, checkpoints every
`runtime.checkpoint_every` frames. With `bow.poll_lag_s > 0` the drain
is asynchronous: a worker thread fetches a snapshot of the ring every
`bow.poll_max_pending` frames and each verification slate's result, and
the camera loop consumes what has landed. `global_ba_step` is the
offline pass over all keyframes, with the pose graph as priors.

State tables are updated in place by `slam_step` (the reference donates
its state); the backend steps (`local_ba_step`, `global_ba_step`, the
PGO's `_pgo_apply`) replace the tensors they change. The state's `frame` is a
0-d int32 tensor on the state's device, as in the reference: culling,
the trajectory write and the ring row are decided on the device, so the
step's host code is the same at every frame. Random draws come from a
`DrawSource`, drawn before the step; the default draws from seeded
`torch.Generator`s.

On CUDA tensors `SlamSystem` runs each frame after the bootstrap as one
replay of a captured CUDA graph of `_step_core` (`utils/graphs.py`),
as the reference runs one compiled program per frame, and each call of
`local_ba_step`, of a loop slate (`verify_loop_slate` +
`_pack_slate_result`) and of `place_query` as one replay of a graph
captured over the step graph's state, as the reference jits each of
them. The pose-graph relaxation (the reference's jitted `_pgo_step`)
replays three such graphs per PGO bucket: `pgo_build` builds the pose
graph, `pgo_gn` (one Gauss-Newton iteration, the live count a device
scalar) is replayed once per iteration, `pgo_apply` writes the state.
On the CPU, and with `SlamSystem(..., graphs=False)`, the same
functions run eagerly. The offline `global_ba_step` replays graphs of
the registry of `utils/graphs.py` on CUDA tensors (`ba_build`, `ba_lm`
once per LM iteration, `ba_apply`), unless called with `graphs=False`.
`SlamSystem.frame_count` is the host mirror of `frame` that steers the
host's cadences.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from slam1_tpu_torch.config import SlamConfig
from slam1_tpu_torch.models import ba
from slam1_tpu_torch.models import bow as bow_mod
from slam1_tpu_torch.models import mapping
from slam1_tpu_torch.models import posegraph
from slam1_tpu_torch.models.ba import _cost as ba_cost
from slam1_tpu_torch.models.ba import bundle_adjust, make_problem
from slam1_tpu_torch.models.frontend import stereo_frontend
from slam1_tpu_torch.models.loop_closure import place_query, \
    verify_loop_slate
from slam1_tpu_torch.models.tracker import chain_pose, temporal_track
from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.pnp import uniform
from slam1_tpu_torch.runtime import default_device
from slam1_tpu_torch.types import StereoObservations
from slam1_tpu_torch.utils import checkpoint as ckpt_mod
from slam1_tpu_torch.utils import graphs as graph_mod
from slam1_tpu_torch.utils.graphs import StepGraph, copy_out
from slam1_tpu_torch.utils.metrics import span, traced, wait

MAX_LOOP_EDGES = 128
KF_FEATURES = 1024          # per-keyframe snapshot (top-K by corner score)
PGO_BUCKETS = (512, 2048, 8192)
LOOP_RANSAC_ITERS = 1024    # hypotheses of loop verification

ROW_W = 16                  # packed metrics row width
ROW_RING = 256              # device-side metrics ring capacity (frames)
ALT_CAND_BASE = 10          # first runner-up (cand, chi2) pair in a row


class StepDraws(NamedTuple):
    pnp: torch.Tensor    # (K,N) RANSAC draws of temporal tracking
    bow: torch.Tensor    # (N,) reservoir sample draws
    bow2: torch.Tensor   # (N,) DB-row sample draws


class DrawSource:
    """Uniform draws in [1e-9, 1) for every random site of the system.

    Each site has its own stream: the per-frame step, the one-off BoW
    training, and loop verification, whose draws for a (hit, candidate,
    salt) slate entry come from a generator seeded by that entry (as the
    reference folds it into its key). `gen_device` is where the
    generators live (default: `device`); draws are moved to `device`.
    """

    def __init__(self, seed: int, device, gen_device=None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen_device = torch.device(gen_device or device)
        self._gen = torch.Generator(self.gen_device)
        self._gen.manual_seed(self.seed)

    def _uniform(self, shape, gen=None):
        u = uniform(shape, gen or self._gen, self.gen_device)
        return u.to(self.device)

    def get_state(self) -> torch.Tensor:
        """The step stream's generator state (a CPU byte tensor, for a
        CUDA generator too); the other streams are seeded per call."""
        return self._gen.get_state()

    def set_state(self, state: torch.Tensor):
        self._gen.set_state(state.cpu().to(torch.uint8))

    def init(self, n: int):
        """(N,) reservoir and (N,) DB-row draws of the bootstrap frame."""
        return self._uniform((n,)), self._uniform((n,))

    def step(self, k: int, n: int) -> StepDraws:
        return StepDraws(self._uniform((k, n)), self._uniform((n,)),
                         self._uniform((n,)))

    def train(self, r: int):
        """(R,) draws of the k-means initialisation."""
        g = torch.Generator(self.gen_device)
        g.manual_seed(self.seed * 1000 + 999)
        return self._uniform((r,), g)

    def slate(self, hit_frames, cand_frames, salt: int, k: int, n: int):
        """(B,K,N) RANSAC draws, one stream per slate entry."""
        out = []
        for hf, c in zip(hit_frames, cand_frames):
            g = torch.Generator(self.gen_device)
            g.manual_seed(((self.seed ^ 0x5A5A) << 32)
                          | ((hf * 7919 + c * 31 + salt) & 0x7FFFFFFF))
            out.append(self._uniform((k, n), g))
        return torch.stack(out)


class SlamState(NamedTuple):
    T_w_cam: torch.Tensor
    prev_obs: StereoObservations
    xi_vel: torch.Tensor
    frame: torch.Tensor           # () int32
    map: mapping.MapState
    kf: mapping.KeyframeStore
    bow: bow_mod.BowState
    traj: torch.Tensor            # (F,4,4)
    rel: torch.Tensor             # (F,6) twist of edge (i-1 -> i)
    rel_mask: torch.Tensor        # (F,)
    last_kf_frame: torch.Tensor   # () int32
    last_kf_pos: torch.Tensor     # (3,) translation at the last keyframe
    prev_lm: torch.Tensor         # (N,) int32 landmark row of each
                                  # prev_obs slot (-1 unknown)
    rows: torch.Tensor            # (ROW_RING, ROW_W) metrics ring: frame
                                  # f's row lives at f % ROW_RING


class StepOutput(NamedTuple):
    loop_hit: bool
    loop_candidate: int
    loop_chi2: float
    is_kf: bool
    kf_n: int
    num_stereo: int
    num_inliers: int
    mean_reproj_err: float
    pnp_ok: bool
    frame: int
    alt_cands: tuple              # ((frame, chi2), ...) runner-ups


def _unpack_row(row) -> StepOutput:
    """(ROW_W,) float32 packed metrics row -> host StepOutput (layout:
    _step_core's out_row)."""
    r = np.asarray(row)
    alts = tuple((int(r[k]), float(r[k + 1]))
                 for k in range(ALT_CAND_BASE, ROW_W - 1, 2) if r[k] >= 0)
    return StepOutput(
        loop_hit=bool(r[0] > 0.5), loop_candidate=int(r[1]),
        loop_chi2=float(r[2]), is_kf=bool(r[3] > 0.5), kf_n=int(r[4]),
        num_stereo=int(r[5]), num_inliers=int(r[6]),
        mean_reproj_err=float(r[7]), pnp_ok=bool(r[8] > 0.5),
        frame=int(r[9]), alt_cands=alts)


def _init_state(left, right, cam, cfg: SlamConfig,
                draws: DrawSource) -> SlamState:
    feats, obs = stereo_frontend(left, right, cam, cfg)
    mf = cfg.mapping.max_frames
    dev, dt = left.device, left.dtype
    state = SlamState(
        T_w_cam=torch.eye(4, dtype=dt, device=dev),
        prev_obs=obs,
        xi_vel=torch.zeros(6, dtype=dt, device=dev),
        frame=torch.zeros((), dtype=torch.int32, device=dev),
        map=mapping.init_map(cfg.mapping, device=dev),
        kf=mapping.init_kf_store(mf, KF_FEATURES, device=dev),
        bow=bow_mod.init_bow(cfg.bow, mf, device=dev),
        traj=torch.eye(4, dtype=dt, device=dev).repeat(mf, 1, 1),
        rel=torch.zeros((mf, 6), dtype=dt, device=dev),
        rel_mask=torch.zeros(mf, dtype=torch.bool, device=dev),
        last_kf_frame=torch.zeros((), dtype=torch.int32, device=dev),
        last_kf_pos=torch.zeros(3, dtype=dt, device=dev),
        prev_lm=torch.full((obs.mask.shape[0],), -1, dtype=torch.int32,
                           device=dev),
        rows=torch.zeros((ROW_RING, ROW_W), dtype=dt, device=dev),
    )
    # Frame 0 is always a keyframe.
    new_map, lm_of = mapping.insert(
        state.map, obs.xyz, obs.desc, obs.mask, 0, obs.uv_l, cfg.mapping,
        uv_r_u=obs.uv_r[:, 0], obs_row=0)
    kf = mapping.kf_insert(state.kf, obs, state.T_w_cam, KF_FEATURES,
                           frame=0, is_kf=True)
    u_acc, u_add = draws.init(feats.mask.shape[0])
    bw = bow_mod.accumulate(state.bow, u_acc, feats.desc, feats.mask,
                            cfg.bow.sample_desc_per_frame)
    bw = bow_mod.add_frame(bw, u_add, 0, feats.desc, feats.mask, is_kf=True)
    return state._replace(map=new_map, prev_lm=lm_of, kf=kf, bow=bw)


def _inherit_landmarks(match_idx, inherit, prev_lm):
    """cur_lm[match_idx[i]] = prev_lm[i] for inheriting lanes i, -1
    elsewhere; several lanes on one slot resolve as the reference's
    scatter does (the highest lane wins)."""
    n = prev_lm.shape[0]
    lanes = torch.arange(n, device=prev_lm.device)
    win = torch.full((n + 1,), -1, dtype=torch.int64, device=prev_lm.device)
    win.scatter_reduce_(0, torch.where(inherit, match_idx.long(), n),
                        torch.where(inherit, lanes, -1), "amax")
    win = win[:n]
    return torch.where(win >= 0, prev_lm[torch.clamp(win, min=0)], -1)


def _put_row(table, idx, ok, value):
    """table[idx] = value where the 0-d bool `ok` holds, else kept; `idx`
    is a 0-d tensor, clamped into the table. Decided on the device."""
    i = torch.clamp(idx.long(), 0, table.shape[0] - 1).reshape(1)
    table.index_copy_(0, i, torch.where(ok, value[None],
                                        table.index_select(0, i)))


def _pose_at(traj, frame):
    """traj[clip(frame, 0, F - 1)] for an int or 0-d tensor `frame`,
    gathered on the device (the reference's clamped index)."""
    f = mapping.scalar(frame, torch.int64, traj.device)
    return traj.index_select(
        0, torch.clamp(f, 0, traj.shape[0] - 1).reshape(1))[0]


def _step_core(state: SlamState, left, right, cam: StereoCamera,
               cfg: SlamConfig, u: StepDraws):
    """One frame on the device of its inputs; nothing is read back to
    the host, so the function can be captured as a CUDA graph."""
    feats, obs = stereo_frontend(left, right, cam, cfg)
    track = temporal_track(state.prev_obs, feats, cam, cfg,
                           xi_prior=state.xi_vel, u=u.pnp)
    T_w, xi_used = chain_pose(state.T_w_cam, track.pnp, state.xi_vel)
    frame = state.frame + 1

    # Keyframe policy: every Nth frame or enough translation since the
    # last keyframe.
    mcfg = cfg.mapping
    is_kf = (frame - state.last_kf_frame) >= mcfg.keyframe_every
    if mcfg.keyframe_trans > 0:
        dist = torch.linalg.norm(T_w[:3, 3] - state.last_kf_pos)
        is_kf = is_kf | (dist > mcfg.keyframe_trans)
    kf_row = state.kf.n                        # row this keyframe will take

    # Feature-track landmark identity: the current slot inherits the
    # landmark of the previous slot the tracker matched to it (inliers).
    inherit = (track.match_mask & track.pnp.inliers & (state.prev_lm >= 0))
    cur_lm = _inherit_landmarks(track.match_idx, inherit, state.prev_lm)

    # Map: world points of this frame's stereo observations, recorded
    # under the keyframe row.
    xyz_w = se3.transform_points(T_w, obs.xyz)
    new_map, lm_of = mapping.insert(
        state.map, xyz_w, obs.desc, obs.mask & is_kf, frame, obs.uv_l,
        mcfg, uv_r_u=obs.uv_r[:, 0], obs_row=kf_row, known_row=cur_lm)
    new_prev_lm = torch.where(lm_of >= 0, lm_of, cur_lm)

    # Landmark culling at a fixed cadence, under a mask on the device.
    if mcfg.cull_min_obs > 0 and mcfg.cull_every > 0:
        new_map = mapping.cull(new_map, frame, mcfg.cull_min_obs,
                               mcfg.cull_max_age,
                               gate=(frame % mcfg.cull_every) == 0)

    kf = mapping.kf_insert(state.kf, obs, T_w, KF_FEATURES, frame=frame,
                           is_kf=is_kf)

    # BoW: reservoir sample, DB row (keyframes only), query.
    bw = bow_mod.accumulate(state.bow, u.bow, feats.desc, feats.mask,
                            cfg.bow.sample_desc_per_frame)
    bw = bow_mod.add_frame(bw, u.bow2, frame, feats.desc, feats.mask,
                           is_kf=is_kf)
    cands, chi2s = bow_mod.query_topk(bw, frame, feats.desc, feats.mask,
                                      cfg.bow, k=4)
    loop_hit = (cands[0] >= 0) & (chi2s[0] < cfg.bow.chi2_accept)

    # Past the end of the trajectory the write is dropped, as in JAX.
    inside = frame < state.traj.shape[0]
    _put_row(state.traj, frame, inside, T_w)
    _put_row(state.rel, frame, inside, xi_used)
    _put_row(state.rel_mask, frame, inside, inside)

    dt = left.dtype
    out_row = torch.stack([
        loop_hit.to(dt), cands[0].to(dt), chi2s[0].to(dt),
        is_kf.to(dt), kf.n.to(dt),
        torch.sum(obs.mask).to(dt),
        track.pnp.num_inliers.to(dt), track.pnp.mean_err.to(dt),
        track.pnp.ok.to(dt), frame.to(dt),
        cands[1].to(dt), chi2s[1].to(dt),
        cands[2].to(dt), chi2s[2].to(dt),
        cands[3].to(dt), chi2s[3].to(dt)])
    state.rows.index_copy_(0, (frame % ROW_RING).long().reshape(1),
                           out_row[None])
    new_state = SlamState(
        T_w_cam=T_w, prev_obs=obs, xi_vel=xi_used, frame=frame,
        map=new_map, kf=kf, bow=bw, traj=state.traj, rel=state.rel,
        rel_mask=state.rel_mask,
        last_kf_frame=torch.where(is_kf, frame, state.last_kf_frame),
        last_kf_pos=torch.where(is_kf, T_w[:3, 3], state.last_kf_pos),
        prev_lm=new_prev_lm, rows=state.rows)
    return new_state, out_row, feats


def slam_step(state: SlamState, left, right, cam: StereoCamera,
              cfg: SlamConfig, draws: DrawSource):
    """One frame: (state, left, right) -> (state, packed row, features)."""
    u = draws.step(cfg.tracking.ransac_iters, state.prev_obs.mask.shape[0])
    return _step_core(state, left, right, cam, cfg, u)


def _graphed_step(cam: StereoCamera, cfg: SlamConfig):
    """_step_core as a StepGraph's function: (state, left, right, draws)
    -> (state, packed row)."""
    def step(state, left, right, u):
        new_state, row, _ = _step_core(state, left, right, cam, cfg, u)
        return new_state, row
    return step


def slam_step_block(state: SlamState, lefts, rights, cam: StereoCamera,
                    cfg: SlamConfig, draws: DrawSource):
    """K frames as an eager loop over slam_step. Returns (state, rows
    (K, ROW_W)). The reference scans them in one program only to spread
    a remote TPU's per-program cost; on the card `SlamSystem.
    process_block` replays a captured graph of the step once per frame
    instead, which leaves the host no per-launch work."""
    rows = []
    for i in range(lefts.shape[0]):
        state, row, _ = slam_step(state, lefts[i], rights[i], cam, cfg, draws)
        rows.append(row)
    return state, torch.stack(rows)


def _set_rows(table, idx, ok, values):
    """A copy of `table` (R, ...) with table[idx[k]] = values[k] for the
    lanes where `ok` holds, whose `idx` must be distinct and in range;
    the other lanes write nothing (the reference's `mode="drop"`). They
    land in one extra row that is cut off again, so no write depends on
    the order of a scatter and nothing is read back to the host."""
    n = table.shape[0]
    buf = torch.cat([table, table[:1]])
    buf[torch.where(ok, idx, n)] = values
    return buf[:n]


def _slot_observations(state: SlamState, rows, row_ok):
    """The observation slots of keyframe rows `rows` (R,) flattened to
    R * OPF observations: (cam_idx, lm, lm clipped into the table, valid,
    uv, ur)."""
    obs = state.map.obs[rows]                               # (R,OPF,4)
    ur = state.map.obs_ur[rows].reshape(-1)
    opf = obs.shape[1]
    cap = state.map.xyz.shape[0]
    dev = obs.device
    cam_idx = torch.arange(rows.shape[0], device=dev).repeat_interleave(opf)
    lm = obs[..., 1].to(torch.int64).reshape(-1)
    lm_ok = (lm >= 0) & (lm < cap)
    lmc = torch.clamp(lm, 0, cap - 1)
    slot_ok = (torch.arange(opf, device=dev)[None, :]
               < state.map.obs_count[rows][:, None]).reshape(-1)
    valid = slot_ok & lm_ok & row_ok[cam_idx] & state.map.valid[lmc]
    return cam_idx, lm, lmc, valid, obs[..., 2:4].reshape(-1, 2), ur


def local_ba_step(state: SlamState, cam: StereoCamera, cfg: SlamConfig,
                  end_kf=None):
    """Windowed local BA over the `ba.window` keyframes ending at
    keyframe row `end_kf` (an int or 0-d tensor; default: the newest).

    Builds a BAProblem from the per-keyframe observation slots, runs
    `ba.local_lm_iters` Schur-LM iterations, and feeds the optimised
    poses back into the trajectory and the keyframe store and the
    optimised landmarks back into the map. Returns (state, BA cost, a
    0-d tensor). `end_kf` lets the backend catch up window by window
    when it consumes keyframe counts in bursts.

    Nothing is written in place and nothing is read back to the host:
    the returned state holds new tensors for `traj`, `rel`, `kf.poses`,
    `map.xyz` and `T_w_cam` and shares every other tensor with `state`,
    whose own tensors stay as they were.
    """
    w_kf = cfg.ba.window
    dev = state.traj.device
    f_cap = state.traj.shape[0]
    kf_cap = state.kf.xyz.shape[0]
    kfn = state.kf.n.long()
    if end_kf is not None:
        kfn = torch.minimum(mapping.scalar(end_kf, torch.int64, dev), kfn)
    start = torch.clamp(kfn - w_kf, 0, kf_cap - w_kf)
    rows = start + torch.arange(w_kf, device=dev)           # (W,)
    row_ok = rows < kfn
    frames = state.kf.frame_of_row[rows].long()             # (W,)
    fr_ok = row_ok & (frames >= 0)

    cam_idx, lm, _, valid, uv, ur = _slot_observations(state, rows, fr_ok)
    cap = state.map.xyz.shape[0]
    poses = state.traj[torch.clamp(frames, 0, f_cap - 1)]
    w = valid.to(uv.dtype)
    wr = ((ur > 0) & valid).to(uv.dtype)     # stereo term anchors scale

    # Compact the window's landmarks into a local table of W*OPF slots,
    # so the Schur elimination works over the window's landmarks and not
    # the map's capacity: sorted ids, the first of each run, and the
    # k-th first found by a search in the running count.
    n_obs = lm.shape[0]
    ids = torch.sort(torch.where(valid, lm, cap)).values    # (O,)
    is_first = (ids < cap) & torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev), ids[1:] != ids[:-1]])
    n_first = torch.cumsum(is_first.to(torch.int64), 0)
    lanes = torch.arange(n_obs, device=dev)
    src = torch.clamp(torch.searchsorted(n_first, lanes + 1), max=n_obs - 1)
    uniq_ok = lanes < n_first[-1]
    uniq = torch.where(uniq_ok, ids[src], cap)              # sorted, then cap
    lm_local = torch.clamp(torch.searchsorted(uniq, lm), 0, n_obs - 1)
    pts_local = state.map.xyz[torch.where(uniq_ok, uniq, 0)]

    prob = make_problem(poses, pts_local, cam_idx, lm_local, uv, w,
                        ur=ur, wr=wr)
    ba_cfg = dataclasses.replace(cfg.ba, lm_iters=cfg.ba.local_lm_iters)
    # Eager: on the card this runs inside the captured local_ba graph.
    out, cost = bundle_adjust(prob, cam, ba_cfg, graphs=False)

    xyz_new = _set_rows(state.map.xyz, uniq, uniq_ok, out.points)
    traj = _set_rows(state.traj, frames, fr_ok, out.poses)
    kf_poses = _set_rows(state.kf.poses, rows, row_ok, out.poses)
    t_w = _pose_at(traj, state.frame)

    # Re-derive the odometry twists of every edge touching a pose this
    # window changed (frames [lo, hi]; edge f couples f-1 and f, hence
    # <= hi + 1): PGO re-solves from `rel` + loop edges, so stale twists
    # would revert the refinement at the next relaxation, while a wider
    # bound would absorb every pose-graph relaxation in between into the
    # odometry. Convention (_pgo_step): rel[f] = -log(inv(traj[f-1])
    # @ traj[f]).
    big = torch.iinfo(torch.int64).max
    lo = torch.min(torch.where(fr_ok, frames, big))
    hi = torch.max(torch.where(fr_ok, frames, -1))
    rel_new = -se3.log_se3(se3.inverse(traj[:-1]) @ traj[1:])
    f_idx = torch.arange(1, f_cap, device=dev)
    upd = (f_idx >= lo) & (f_idx <= hi + 1) & state.rel_mask[1:]
    rel = torch.cat([state.rel[:1],
                     torch.where(upd[:, None], rel_new, state.rel[1:])])

    new_state = state._replace(
        traj=traj, kf=state.kf._replace(poses=kf_poses),
        map=state.map._replace(xyz=xyz_new), T_w_cam=t_w, rel=rel)
    return new_state, cost


def build_global_problem(state: SlamState, n_kf: int, obs_bucket: int = 0,
                         loop_rows=None, prior_odo_weight: float = 0.0,
                         prior_loop_weight: float = 0.0):
    """BAProblem over keyframe rows [0, n_kf) from the per-keyframe
    observation slots, and the (n_kf,) frame of each row (clipped into
    the trajectory). `n_kf` is a host integer, a bucket >= kf.n: padding
    rows carry no observation.

    obs_bucket > 0 compacts the observation axis: the raw slot layout
    is mostly padding. Valid rows are sorted to the front (stable) and
    the first `obs_bucket` kept; overflow beyond the bucket is dropped.

    loop_rows (optional): (le_i, le_j, le_z, le_w) fixed-capacity loop
    edges in keyframe-row indices. When given (and prior_odo_weight >
    0), the problem carries pose-prior edges: the consecutive-keyframe
    chain with the current relative poses as the prior mean (residual 0
    at the initial point) plus the loop edges.
    """
    dev = state.traj.device
    rows = torch.arange(n_kf, device=dev)
    fo = state.kf.frame_of_row[:n_kf].long()
    row_ok = (rows < state.kf.n) & (fo >= 0)
    cam_idx, lm, lmc, valid, uv, ur = _slot_observations(state, rows, row_ok)
    frames = torch.clamp(fo, 0, state.traj.shape[0] - 1)
    poses = state.traj[frames]
    w = valid.to(uv.dtype)
    wr = ((ur > 0) & valid).to(uv.dtype)
    if obs_bucket and obs_bucket < lm.shape[0]:
        order = torch.sort((~valid).to(torch.uint8),
                           stable=True).indices[:obs_bucket]
        cam_idx, lmc, uv, w, ur, wr = (a[order] for a in
                                       (cam_idx, lmc, uv, w, ur, wr))
    pe = {}
    if loop_rows is not None and prior_odo_weight > 0:
        le_i, le_j, le_z, le_w = loop_rows
        ei = torch.arange(n_kf - 1, device=dev)
        chain_ok = row_ok[:-1] & row_ok[1:]
        z_chain = se3.inverse(poses[:-1]) @ poses[1:]
        pe = dict(
            pe_i=torch.cat([ei, le_i.long()]),
            pe_j=torch.cat([ei + 1, le_j.long()]),
            pe_z=torch.cat([z_chain, le_z]),
            pe_w=torch.cat([prior_odo_weight * chain_ok.to(uv.dtype),
                            prior_loop_weight * (le_w > 0).to(uv.dtype)]))
    return make_problem(poses, state.map.xyz, cam_idx, lmc, uv, w,
                        ur=ur, wr=wr, **pe), frames


def _global_problem(state, cam: StereoCamera, cfg: SlamConfig, n_kf: int,
                    obs_bucket: int, loop_rows):
    """What global BA solves: `build_global_problem` (pose priors when
    `loop_rows` is given), then the one-shot association gate ->
    (problem, frames)."""
    prob, frames = build_global_problem(
        state, n_kf, obs_bucket, loop_rows=loop_rows,
        prior_odo_weight=(cfg.ba.prior_odo_weight
                          if loop_rows is not None else 0.0),
        prior_loop_weight=cfg.ba.prior_loop_weight)
    if cfg.ba.global_trim_px > 0:
        # One-shot association gate at the (post-PGO) initial point: the
        # observation store accumulates a small garbage tail
        # (mis-inherited landmark identities, voxel-merge gluings, points
        # at the depth clamp) whose residuals dwarf the rest and that
        # every LM step would chase. Trimmed at a fixed pixel radius
        # before the solve: the trajectory is globally consistent here.
        _, r0, _ = ba_cost(prob, cam, cfg.ba.huber_delta)
        rn0 = torch.linalg.norm(r0[:, :2], dim=-1)
        keep = (rn0 < cfg.ba.global_trim_px).to(prob.w.dtype)
        prob = prob._replace(w=prob.w * keep, wr=prob.wr * keep)
    return prob, frames


def _global_write_back(state, n_kf: int, frames, poses, points):
    """The state with global BA's poses and points: `traj`, `kf.poses`,
    `map.xyz` and `T_w_cam` replaced. Only real keyframe rows write back
    (n_kf is a bucket >= kf.n; padding rows' frames clip to 0)."""
    rows = torch.arange(n_kf, device=frames.device)
    ok = (rows < state.kf.n) & (state.kf.frame_of_row[:n_kf] >= 0)
    traj = _set_rows(state.traj, frames, ok, poses)
    kf_poses = torch.cat([
        torch.where(ok[:, None, None], poses, state.kf.poses[:n_kf]),
        state.kf.poses[n_kf:]])
    t_w = _pose_at(traj, state.frame)
    return state._replace(
        traj=traj, kf=state.kf._replace(poses=kf_poses),
        map=state.map._replace(xyz=points), T_w_cam=t_w)


class _KfRows(NamedTuple):
    n: torch.Tensor
    frame_of_row: torch.Tensor


class _MapSlots(NamedTuple):
    obs: torch.Tensor
    obs_ur: torch.Tensor
    obs_count: torch.Tensor
    valid: torch.Tensor
    xyz: torch.Tensor


class _BuildLeaves(NamedTuple):
    """The leaves of a SlamState that `_global_problem` reads."""
    traj: torch.Tensor
    kf: _KfRows
    map: _MapSlots


class _KfPoses(NamedTuple):
    n: torch.Tensor
    frame_of_row: torch.Tensor
    poses: torch.Tensor


class _MapXyz(NamedTuple):
    xyz: torch.Tensor


class _ApplyLeaves(NamedTuple):
    """The leaves of a SlamState that `_global_write_back` reads or
    replaces."""
    traj: torch.Tensor
    frame: torch.Tensor
    T_w_cam: torch.Tensor
    kf: _KfPoses
    map: _MapXyz


def _global_ba_leaves(state: SlamState):
    """(_BuildLeaves, _ApplyLeaves) of a SlamState."""
    kf, mp = state.kf, state.map
    return (_BuildLeaves(state.traj, _KfRows(kf.n, kf.frame_of_row),
                         _MapSlots(mp.obs, mp.obs_ur, mp.obs_count, mp.valid,
                                   mp.xyz)),
            _ApplyLeaves(state.traj, state.frame, state.T_w_cam,
                         _KfPoses(kf.n, kf.frame_of_row, kf.poses),
                         _MapXyz(mp.xyz)))


def _graphed_ba_build(cfg: SlamConfig, n_kf: int, obs_bucket: int):
    """_global_problem as a graph's function: (_BuildLeaves, cam,
    *loop_rows) -> (the same leaves, (problem, frames))."""
    def step(leaves, cam, *loop_rows):
        return leaves, _global_problem(leaves, cam, cfg, n_kf, obs_bucket,
                                       loop_rows or None)
    return step


def _graphed_ba_apply(cfg: SlamConfig, n_kf: int):
    """The final cost and `_global_write_back` as a graph's function:
    (ba._LMCarry, _ApplyLeaves, frames) -> (the same carry, (the leaves
    written, cost))."""
    def step(carry, leaves, frames):
        cost = ba.final_cost(carry.problem, carry.cam, cfg.ba, carry.poses,
                             carry.points)
        return carry, (_global_write_back(leaves, n_kf, frames, carry.poses,
                                          carry.points), cost)
    return step


def global_ba_step(state: SlamState, cam: StereoCamera, cfg: SlamConfig,
                   n_kf: int, obs_bucket: int = 0,
                   return_trace: bool = False, loop_rows=None,
                   graphs: bool = True):
    """Global BA over the first n_kf keyframe rows; returns (state,
    cost), plus the per-LM-iteration BATrace when `return_trace`.
    `obs_bucket`: compacted observation count (see build_global_problem);
    callers pick the smallest bucket covering
    int(sum(map.obs_count[:n_kf])). `loop_rows` (fixed-capacity
    keyframe-row loop edges) enables the pose-prior regularisation.
    Replaces `traj`, `kf.poses`, `map.xyz` and `T_w_cam`; writes nothing
    in place.

    Three stages (`utils/graphs.py`): `ba_build` (the problem and the
    trim, on the state leaves it reads), then `utils/graphs.iterate` of
    `ba.lm_stage` (`ba_lm`, one LM iteration, `cfg.ba.lm_iters` times,
    the graph `bundle_adjust` replays for a problem of these shapes) and
    `ba_apply` (the final cost and the write-back). On CUDA tensors each
    is a replay of a captured CUDA graph, as the reference runs one
    compiled program; `ba_build` and `ba_apply` are kept in the graph
    registry under the kind "global_ba" by the device, the shapes and
    dtypes they read, `cfg`, `n_kf` and (`ba_build`) `obs_bucket`. On
    the CPU, and with `graphs=False`, the same functions run eagerly."""
    on_card = graph_mod.graphed(state.traj, wanted=graphs)
    build_in, apply_in = _global_ba_leaves(state)
    size = f"[{n_kf},{obs_bucket}]"
    loop = tuple(loop_rows) if loop_rows is not None else ()
    _, (prob, frames) = graph_mod.run(
        graph_mod.Stage("global_ba", (cfg, n_kf, obs_bucket),
                        "ba_build" + size,
                        _graphed_ba_build(cfg, n_kf, obs_bucket)),
        build_in, cam, *loop, graphed=on_card)
    leaves, cost, trace = graph_mod.iterate(
        ba.lm_stage(cfg.ba, prob),
        graph_mod.Stage("global_ba", (cfg, n_kf), "ba_apply" + size,
                        _graphed_ba_apply(cfg, n_kf)),
        ba._lm_carry(prob, cam, cfg.ba, return_trace), cfg.ba.lm_iters,
        end_inputs=(apply_in, frames), keep=lambda c, out: (*out, c.trace),
        graphed=on_card)
    new_state = state._replace(
        traj=leaves.traj, T_w_cam=leaves.T_w_cam,
        kf=state.kf._replace(poses=leaves.kf.poses),
        map=state.map._replace(xyz=leaves.map.xyz))
    if return_trace:
        return new_state, cost, trace
    return new_state, cost


def _pgo_graph(traj, rel, rel_mask, le_i, le_j, le_z, le_w, bucket: int):
    """The pose graph over the first `bucket` poses of `traj`: the
    odometry edges of `rel` (i -> i + 1, weighted by rel_mask), then the
    fixed-capacity loop edges."""
    t = traj[:bucket]
    ei = torch.arange(bucket - 1, device=traj.device)
    # rel[f] = log(T_f_{f-1}); the edge measurement is T_{f-1}_f.
    z_odo = se3.exp_se3(-rel[1:bucket])
    w_odo = rel_mask[1:bucket].to(torch.float32)
    return posegraph.PoseGraph(
        poses=t, ei=torch.cat([ei, le_i.long()]),
        ej=torch.cat([ei + 1, le_j.long()]), z=torch.cat([z_odo, le_z]),
        w=torch.cat([w_odo, le_w]))


def _pgo_apply(traj, kf_frames, frame, map_xyz, map_last, map_valid,
               graph: posegraph.PoseGraph, bucket: int):
    """What follows the Gauss-Newton iterations, whose poses `graph`
    holds: the cost, the relaxed poses written over the first `bucket`
    rows of `traj` (unless they are not all finite), the pose at
    `frame`, the keyframes' poses and the landmarks re-anchored: each
    map point rides the pose correction of its last-observation frame.
    -> (traj, T_w_cam, keyframe poses, map xyz, cost)."""
    opt = graph.poses
    cost = posegraph.cost(graph, opt)
    # Never let a non-finite relaxation replace a finite trajectory.
    opt = torch.where(torch.isfinite(opt).all(), opt, traj[:bucket])
    traj_old = traj
    traj = traj.clone()
    traj[:bucket] = opt
    t_w = _pose_at(traj, frame)
    new_kf_poses = traj[torch.clamp(kf_frames.long(), 0, traj.shape[0] - 1)]
    f_lm = torch.clamp(map_last.long(), 0, traj.shape[0] - 1)
    d = traj[f_lm] @ se3.inverse(traj_old[f_lm])            # (CAP,4,4)
    xyz2 = (d[:, :3, :3] @ map_xyz[..., None])[..., 0] + d[:, :3, 3]
    xyz2 = torch.where(map_valid[:, None], xyz2, map_xyz)
    return traj, t_w, new_kf_poses, xyz2, cost


def _pgo_step(traj, rel, rel_mask, kf_frames, le_i, le_j, le_z, le_w,
              frame, map_xyz, map_last, map_valid,
              bucket: int, iters: int, cg_iters: int, n_live):
    """Pose-graph relaxation over the first `bucket` poses, then
    landmark re-anchoring (`_pgo_graph`, `iters` calls of
    `posegraph.gn_step`, `_pgo_apply`: the ops SlamSystem's programs
    run). `n_live` (an int or a 0-d int32 tensor): poses [0, n_live)
    carry the odometry; later rows of the bucket only ride along.
    `frame` (an int or 0-d tensor) picks the returned current pose."""
    graph = _pgo_graph(traj, rel, rel_mask, le_i, le_j, le_z, le_w, bucket)
    for _ in range(iters):
        graph = graph._replace(poses=posegraph.gn_step(
            graph, graph.poses, cg_iters, n_live=n_live))
    return _pgo_apply(traj, kf_frames, frame, map_xyz, map_last, map_valid,
                      graph, bucket)


def _pack_slate_result(res) -> torch.Tensor:
    """Batched LoopPairResult -> one (K,19) array [T.flat, anchor,
    inliers, ok] per row, fetched with one transfer."""
    dt = res.T_anchor_cand.dtype
    k = res.ok.shape[0]
    return torch.cat([
        res.T_anchor_cand.reshape(k, 16),
        torch.stack([res.anchor_frame.to(dt), res.num_inliers.to(dt),
                     res.ok.to(dt)], dim=-1)], dim=-1)


def _graphed_local_ba(cam: StereoCamera, cfg: SlamConfig):
    """local_ba_step as a backend graph's function: (state, end_kf, a 0-d
    int64 tensor) -> (state, cost)."""
    def step(state, end_kf):
        return local_ba_step(state, cam, cfg, end_kf=end_kf)
    return step


def _graphed_slate(cam: StereoCamera, cfg: SlamConfig):
    """verify_loop_slate + _pack_slate_result as a backend graph's
    function: (state, u, cand_frames, hit_frames) -> (state, (K,19))."""
    def step(state, u, cand_frames, hit_frames):
        res = verify_loop_slate(u, state.kf, cand_frames, hit_frames, cam,
                                cfg)
        return state, _pack_slate_result(res)
    return step


def _graphed_pgo_build(bucket: int):
    """_pgo_graph at the `bucket` as a backend program's function: (state,
    le_i, le_j, le_z, le_w) -> (state, PoseGraph)."""
    def step(state, le_i, le_j, le_z, le_w):
        return state, _pgo_graph(state.traj, state.rel, state.rel_mask,
                                 le_i, le_j, le_z, le_w, bucket)
    return step


def _graphed_pgo_gn(cg_iters: int):
    """One Gauss-Newton iteration as a backend program's function:
    (state, PoseGraph, n_live, a 0-d int32 tensor) -> (state, the
    PoseGraph with the updated poses and the same edge tensors)."""
    def step(state, graph, n_live):
        return state, graph._replace(poses=posegraph.gn_step(
            graph, graph.poses, cg_iters, n_live=n_live))
    return step


def _graphed_pgo_apply(bucket: int):
    """_pgo_apply as a backend program's function: (state, PoseGraph at
    the relaxed poses) -> (state with traj, T_w_cam, the poses of the
    stored keyframes and the map written, cost)."""
    def step(state, graph):
        kf, mp = state.kf, state.map
        traj, t_w, kf_poses, xyz, cost = _pgo_apply(
            state.traj, kf.frame_of_row, state.frame, mp.xyz,
            mp.last_frame, mp.valid, graph, bucket)
        kf_sel = torch.where((kf.frame_of_row >= 0)[:, None, None],
                             kf_poses, kf.poses)
        return state._replace(traj=traj, T_w_cam=t_w,
                              kf=kf._replace(poses=kf_sel),
                              map=mp._replace(xyz=xyz)), cost
    return step


def _graphed_place_query(cfg: SlamConfig, n_rows: int):
    """place_query at the `n_rows` bucket as a backend graph's function:
    (state, q_row, max_frame, 0-d int64 tensors) -> (state, (cands,
    scores))."""
    b = cfg.bow
    def step(state, q_row, max_frame):
        return state, place_query(state.kf, q_row, max_frame, n_rows,
                                  k=b.place_topk, thresh=b.place_thresh,
                                  nms_frames=b.place_nms_frames)
    return step


@dataclasses.dataclass
class LoopEvent:
    frame: int
    candidate: int
    chi2: float
    num_inliers: int
    accepted: bool


def _upload(what: str, values, device) -> torch.Tensor:
    """`values` (a list or an array) as a tensor on `device`. From
    pageable host memory to a card the copy synchronizes the stream, so
    it runs as the read-back `host:wait.<what>` (`metrics.wait`)."""
    with wait(what):
        return torch.as_tensor(values, device=device)


class SlamSystem:
    """Host-side orchestrator (the `slam.run(config)` API).

    Nothing in the per-frame path reads the device: each slam_step
    writes one packed metrics row into the device ring, and the host
    drains the ring with one transfer. With `bow.poll_lag_s == 0` the
    drain happens at every poll (every `bow.loop_poll_every` frames;
    deterministic). With `bow.poll_lag_s > 0` a worker thread fetches a
    snapshot of the ring once `bow.poll_max_pending` frames have
    accumulated, and each slate's packed result; polls consume what has
    landed, so the backend (loop detection, local BA, PGO) lags the
    camera loop by a bounded number of frames and never stalls it.
    `draws` replaces the default DrawSource (seeded with `seed`).

    On CUDA tensors every frame after the bootstrap is one replay of a
    CUDA graph of the step, captured at frame 1 (`step_graph`), and the
    backend's local BA, loop slate, place query (one graph per row
    bucket) and pose-graph relaxation (`pgo_build`, `pgo_gn` replayed
    once per Gauss-Newton iteration and `pgo_apply`, per PGO bucket;
    the live PGO, `detect_loops_offline`'s and `finalize`'s) each replay
    a graph captured over the step graph's static state at their first
    call (`backend_graphs`); `graphs=False` runs them all eagerly
    instead, for comparisons. On CPU tensors everything runs eagerly.
    Write-backs from outside the graphs (BoW training, a backend program
    that ran before the step graph existed) replace state tensors; the
    next replay copies them into the graphs' state (`StepGraph.load`).

    Its host work runs in spans (`utils/metrics.py`; recorded while a
    profiler records or inside `metrics.recording()`):
    `host:slam.process` (its frame, which the spans inside it share:
    the frame processed), `.step`, `.after_frames`, `.train_bow`,
    `.poll`, `.drain_rows`, `.place_query`, `.slate` (the dispatch),
    `.consume`, `.local_ba`, `.pgo`, `.finalize`, `.checkpoint`, and
    `host:worker.fetch` on the worker thread (its frame: the one whose
    poll handed it over). Every blocking read-back on the calling
    thread goes through `metrics.wait`, which counts a host sync and
    opens `host:wait.<what>`: `poll` (the query keyframe's frame),
    `place_query` (its two results), `ring` and `slate` (in the
    synchronous mode, or under `force`), `fetch` (a worker's fetch
    awaited under `force`), `pgo`, `loop_edge_rows`, `detect_loops`,
    `poses` and `pose_graph`; so does every copy of host values to the
    card (`_upload`), which waits for the stream as a read-back does:
    `slate_inputs`, `pgo_inputs` and `loop_edge_inputs`.
    """

    def __init__(self, cam: StereoCamera, cfg: Optional[SlamConfig] = None,
                 seed: int = 0, bow_train_frame: int = 30,
                 draws: Optional[DrawSource] = None, graphs: bool = True):
        self.cam = cam
        self.cfg = cfg or SlamConfig()
        if self.cfg.bow.poll_max_pending > ROW_RING:
            raise ValueError(
                f"bow.poll_max_pending={self.cfg.bow.poll_max_pending} "
                f"exceeds the {ROW_RING}-row metrics ring")
        self.seed = seed
        self.bow_train_frame = bow_train_frame
        self.draws = draws or DrawSource(seed, cam.fx.device)
        self.state: Optional[SlamState] = None
        self.graphs = graphs
        self.step_graph: Optional[StepGraph] = None
        self.backend_graphs: dict = {}   # name -> StepGraph over step_graph
        self.loop_edges: list = []       # (i, j, Z (4,4) np, weight)
        self.loop_events: list = []
        self.metrics: list = []          # drained StepOutputs
        self.ba_costs: list = []         # 0-d tensors, one per local BA
        self.pgo_costs: list = []        # 0-d tensors, one per relaxation
        self.frame_count = 0             # host mirror of state.frame
        self._kf_at_last_ba = 1
        self._bow_trained = False
        self._hit_history = []           # [(frame, [(cand, chi2)])]
        self._last_drained = 0
        self._verifying: list = []       # (rows, packed, depth) slates
        self._last_place_kf = 0
        self._defer_pgo = False
        self.n_slates = 0                # slates dispatched
        # poll_lag_s > 0 selects the batched asynchronous drain; 0 drains
        # at every poll (synchronous, deterministic).
        self._async = self.cfg.bow.poll_lag_s > 0.0
        self._pool = None
        self._ring_inflight = None       # (future, first, last frame)
        self._verify_inflight = None     # (future, rows, depth)
        if self._async:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="slam-fetch")

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    def _fetch(self, tensor):
        """A future of `tensor` as a numpy array on the host, fetched by
        the worker thread. `tensor` must not be written afterwards: the
        worker reads it whenever the device gets there."""
        frame = self.frame_count

        def fetch():
            with span("host:worker.fetch", frame=frame):
                return tensor.cpu().numpy()
        return self._pool.submit(fetch)

    @staticmethod
    def _landed(fut, force: bool):
        """A fetch's array; under `force` a wait for the worker's
        read-back, else one that has landed."""
        if not force:
            return fut.result()
        with wait("fetch"):
            return fut.result()

    # ------------------------------------------------------------- core
    def process(self, left, right):
        first = self.state is None
        with span("host:slam.process",
                  frame=0 if first else self.frame_count + 1):
            if first:
                self.state = _init_state(left, right, self.cam, self.cfg,
                                         self.draws)
                self.frame_count = 0
                return None
            if (self.frame_count - self._last_drained) + 1 > ROW_RING:
                self._poll(force=True)       # never let the ring wrap
            out_row = self._step(left, right)
            if self.step_graph is not None:  # the next replay overwrites it
                out_row = out_row.clone()
            self._after_frames(1)
            return out_row

    @traced("host:slam.step")
    def _step(self, left, right):
        """One frame after the bootstrap: its draws, then the step (a
        graph replay on the card) -> the packed row."""
        u = self.draws.step(self.cfg.tracking.ransac_iters,
                            self.state.prev_obs.mask.shape[0])
        if graph_mod.graphed(left, wanted=self.graphs):
            if self.step_graph is None:
                self.step_graph = StepGraph(
                    _graphed_step(self.cam, self.cfg), "slam_step")
            self.state, row = self.step_graph(self.state, left, right, u)
            return row
        self.state, row, _ = _step_core(self.state, left, right, self.cam,
                                        self.cfg, u)
        return row

    def _program(self, name: str, fn, *inputs):
        """One backend program `fn(state, *inputs) -> (state, out)` on
        self.state -> out. Once the step runs as a graph, the program is
        the graph `name` over the step graph's static state (captured at
        its first call, replayed after), and `out` is the graph's own,
        overwritten by its next replay (it may be handed to that replay
        as an input); before that, and with graphs=False, it runs
        eagerly."""
        if self.step_graph is None:
            self.state, out = fn(self.state, *inputs)
            return out
        graph = self.backend_graphs.get(name)
        if graph is None:
            graph = self.backend_graphs[name] = StepGraph(
                fn, name, over=self.step_graph)
        self.state, out = graph(self.state, *inputs)
        return out

    def _backend(self, name: str, fn, *inputs):
        """`_program`, with `out` copied out of the graphs' pool."""
        out = self._program(name, fn, *inputs)
        if self.step_graph is None:
            return out
        return copy_out(out)

    def _device_int(self, v: int, dtype=torch.int64) -> torch.Tensor:
        """A 0-d integer input of a backend program, filled on the
        device."""
        return torch.full((), v, dtype=dtype, device=self.state.traj.device)

    def process_block(self, lefts, rights):
        """Process a (K,H,W) block of frames (bootstrap frame 0 with
        process() first). Host cadences land on block boundaries."""
        assert self.state is not None, "bootstrap with process() first"
        k = int(lefts.shape[0])
        assert k <= ROW_RING, (
            f"block of {k} frames exceeds the {ROW_RING}-row metrics "
            f"ring; split the block")
        # Rows carry loop-closure trigger bits: drain before the block
        # that would overwrite undrained rows.
        if (self.frame_count - self._last_drained) + k > ROW_RING:
            self._poll(force=True)
        for i in range(k):
            self._step(lefts[i], rights[i])
        self._after_frames(k)

    def _crossed(self, every: int, k: int) -> bool:
        return every > 0 and (self.frame_count // every
                              != (self.frame_count - k) // every)

    @traced("host:slam.after_frames")
    def _after_frames(self, k: int):
        self.frame_count += k
        if (not self._bow_trained
                and self.frame_count >= self.bow_train_frame):
            self._train_bow()
            self._bow_trained = True
        if self._crossed(self.cfg.bow.loop_poll_every, k):
            self._poll()
        # Checkpoint after the poll, so backend work launched on this
        # frame (local BA, PGO) is captured.
        rt = self.cfg.runtime
        if self._crossed(rt.checkpoint_every, k):
            self.save_checkpoint(os.path.join(
                rt.checkpoint_dir, f"ckpt_{self.frame_count:06d}.npz"))

    @traced("host:slam.drain_rows")
    def _drain_rows(self, force=False):
        """Undrained metrics rows from the device ring, oldest first,
        one transfer per drain. In the asynchronous mode a drain hands a
        snapshot of the ring to the worker once `poll_max_pending` frames
        have accumulated and returns the rows of the snapshot that has
        landed (none while it is in flight); `force` waits for it and
        fetches the rest itself."""
        rows = []
        if self._ring_inflight is not None:
            fut, first, last = self._ring_inflight
            if not (force or fut.done()):
                return rows
            ring = self._landed(fut, force)
            self._ring_inflight = None
            rows = [ring[f % ROW_RING] for f in range(first, last + 1)]
            self._last_drained = last
        n_new = self.frame_count - self._last_drained
        if n_new <= 0:
            return rows
        if self._async and not force:
            if n_new >= self.cfg.bow.poll_max_pending:
                # The live ring is written in place by later steps: the
                # worker gets a copy made at this point of the stream.
                self._ring_inflight = (
                    self._fetch(self.state.rows.clone()),
                    self._last_drained + 1, self.frame_count)
            return rows
        with wait("ring"):
            ring = self.state.rows.cpu().numpy()
        start = self._last_drained + 1
        if n_new > ROW_RING:
            warnings.warn(f"metrics ring overflowed: "
                          f"{n_new - ROW_RING} rows lost")
            start = self.frame_count - ROW_RING + 1
        rows += [ring[f % ROW_RING] for f in
                 range(start, self.frame_count + 1)]
        self._last_drained = self.frame_count
        return rows

    @traced("host:slam.poll")
    def _poll(self, force=False):
        """Consume landed metrics rows and launch backend work; `force`
        (finalize, checkpoints) drains everything, waiting for fetches
        still in flight."""
        cfg = self.cfg
        self._consume_verifications(force)
        rows = self._drain_rows(force)
        if not rows:
            return
        drained = [_unpack_row(r) for r in rows]
        self.metrics.extend(drained)
        kf_n = int(drained[-1].kf_n)

        # Brute-force place recognition, once per drain: the newest
        # keyframe's snapshot against every stored one.
        if (cfg.bow.place_query and kf_n > self._last_place_kf
                and kf_n >= 2):
            self._last_place_kf = kf_n
            q_row = kf_n - 1
            with wait("poll"):
                q_frame = int(self.state.kf.frame_of_row[q_row])
            max_frame = q_frame - cfg.bow.query_exclude
            if max_frame > 0:
                pairs = self._place_pairs(q_row, q_frame, max_frame, kf_n)
                if pairs:
                    self._try_close_loop(pairs)

        # Every drained hit row joins a rolling history; verification is
        # keyframe-vs-keyframe, so consumption lag cannot invalidate it.
        gate = cfg.bow.chi2_accept * self.ALT_CHI2_SLACK
        newest = None
        for r in drained:
            if not r.loop_hit:
                continue
            hf = r.frame
            cands = [(int(r.loop_candidate), float(r.loop_chi2))] + [
                (c, v) for c, v in r.alt_cands if c >= 0 and v <= gate]
            self._hit_history.append((hf, cands))
            newest = (hf, cands)
        del self._hit_history[:-self.HIT_HISTORY]
        if self._bow_trained and newest:
            # Progression-consistent confirmation: a genuine revisit's
            # candidate advances with the camera (+-candidate_tol).
            hf, cur = newest
            tol = cfg.bow.candidate_tol
            need = max(cfg.bow.confirm_polls - 1, 1)
            confirmed = []
            for c, v in cur:
                support = 0
                for phf, pcands in self._hit_history:
                    gap = hf - phf
                    if gap <= 0 or gap > self.HIT_WINDOW:
                        continue
                    if any(min(abs(c - p - gap), abs(c - p + gap)) <= tol
                           for p, _ in pcands):
                        support += 1
                if support >= need:
                    confirmed.append((c, v))
            strong = cur[0][1] <= cfg.bow.chi2_strong
            if confirmed or strong:
                confirmed.sort(key=lambda cv: cv[1])
                slate = list(confirmed) if confirmed else list(cur)
                if strong and all(c != cur[0][0] for c, _ in slate):
                    slate.insert(0, cur[0])
                pairs = [(hf, c, v) for c, v in slate]
                # A second, older anchor gives an independent slate.
                for phf, pcands in reversed(self._hit_history[:-1]):
                    if hf - phf >= self.SECOND_ANCHOR_GAP:
                        pairs += [(phf, c, v) for c, v in pcands[:2]]
                        break
                self._try_close_loop(pairs)

        # One windowed BA per cadence window the drained keyframe count
        # has passed: bursty row consumption must not skip windows.
        if cfg.ba.local_every:
            while kf_n - self._kf_at_last_ba >= cfg.ba.local_every:
                self._kf_at_last_ba += cfg.ba.local_every
                with span("host:slam.local_ba"):
                    cost = self._backend(
                        "local_ba", _graphed_local_ba(self.cam, cfg),
                        self._device_int(self._kf_at_last_ba))
                self.ba_costs.append(cost)   # stays on the device

    @traced("host:slam.place_query")
    def _place_pairs(self, q_row, q_frame, max_frame, kf_n):
        """place_query of keyframe row q_row -> [(q_frame, cand, score)]."""
        cfg = self.cfg
        cap = self.state.kf.desc.shape[0]
        n_rows = next((b for b in (128, 512, 1024, 2048, 8192)
                       if b >= kf_n and b <= cap), cap)
        cands, scores = self._backend(
            f"place_query[{n_rows}]", _graphed_place_query(cfg, n_rows),
            self._device_int(q_row), self._device_int(max_frame))
        with wait("place_query"):
            cands = cands.cpu().numpy()
        with wait("place_query"):
            scores = scores.cpu().numpy()
        return [(q_frame, int(c), float(s))
                for c, s in zip(cands, scores) if c >= 0]

    @traced("host:slam.train_bow")
    def _train_bow(self):
        u = self.draws.train(self.state.bow.reservoir.shape[0])
        bw = bow_mod.train(self.state.bow, u, self.cfg.bow)
        # Backfill DB rows of keyframes seen before the vocabulary.
        chunk = 128
        for s in range(0, self.frame_count + 1, chunk):
            bw = bow_mod.backfill_chunk(bw, s, chunk)
        self.state = self.state._replace(bow=bw)

    # ----------------------------------------------------- loop closure
    ALT_CHI2_SLACK = 1.5
    MAX_VERIFY_PER_HIT = 6
    HIT_HISTORY = 24
    HIT_WINDOW = 32
    SECOND_ANCHOR_GAP = 16
    SLATE_K = 8
    NEAR_MISS_MIN = 7

    def _try_close_loop(self, pairs):
        """Dispatch one slate of (hit_frame, cand_frame, chi2) pairs,
        best first: each distinct candidate (beyond candidate_tol of one
        already taken) not in an already-closed window nor under
        verification."""
        tol = self.cfg.bow.candidate_tol
        inflight = [(phf, pc) for rows, _p, _d in self._verifying
                    for phf, pc, _v in rows]
        if self._verify_inflight is not None:
            inflight += [(vf, vc) for vf, vc, _v in self._verify_inflight[1]]

        def _suppressed(hf, c):
            if self._edge_is_dup(c, hf):
                return True
            for phf, pc in inflight:
                gap = hf - phf
                if gap < 0:
                    continue
                if min(abs(c - pc), abs(c - pc - gap),
                       abs(c - pc + gap)) <= tol:
                    return True
            return False

        todo = []
        for hf, c, v in pairs:
            if len(todo) >= self.MAX_VERIFY_PER_HIT:
                break
            if (c >= 0 and all(abs(c - c2) > tol for _, c2, _v in todo)
                    and not _suppressed(hf, c)):
                todo.append((hf, c, v))
        if todo:
            self._dispatch_slate(todo, depth=0)

    @traced("host:slam.slate")
    def _dispatch_slate(self, rows, depth=0, salt=0):
        """Verify a slate of [(hit_frame, cand_frame, chi2)] as one
        batch, padded to SLATE_K with cand=-1 (ok=False rows); the
        packed (K,19) result is consumed at the next poll."""
        rows = rows[:self.SLATE_K]
        pad = self.SLATE_K - len(rows)
        hfs = [hf for hf, _c, _v in rows] + [0] * pad
        cs = [c for _hf, c, _v in rows] + [-1] * pad
        dev = self.state.kf.xyz.device
        u = self.draws.slate(hfs, cs, salt, LOOP_RANSAC_ITERS,
                             self.state.kf.xyz.shape[1])
        packed = self._backend(
            "slate", _graphed_slate(self.cam, self.cfg), u,
            _upload("slate_inputs", cs, dev),
            _upload("slate_inputs", hfs, dev))
        self.n_slates += 1
        self._verifying.append((rows, packed, depth))

    def _retry_rows(self, frame, cand, chi2, a_frame):
        """Near-miss retry slate: the adjacent candidate keyframes against
        the same anchor, the candidate against the preceding anchor, and
        the original pair under fresh draws."""
        ke = max(self.cfg.mapping.keyframe_every, 1)
        rows = [(frame, cand, chi2), (frame, cand - ke, chi2),
                (frame, cand + ke, chi2)]
        if a_frame > 0:
            rows.append((a_frame - 1, cand, chi2))
        return [(hf, c, v) for hf, c, v in rows if c >= 0]

    def _edge_is_dup(self, cand, anchor) -> bool:
        """An accepted edge suppresses further edges of the same revisit
        window (both endpoints within bow.rearm_frames)."""
        wnd = max(self.cfg.bow.rearm_frames, 1)
        return any(abs(cand - i) <= wnd and abs(anchor - j) <= wnd
                   for i, j, _Z, _w in self.loop_edges)

    def _apply_slate(self, rows, fetched, depth=0):
        """Consume one fetched (K,19) slate: record events, accept
        verified edges of distinct revisit windows, and collect one
        depth-1 retry slate from near misses."""
        packed = np.asarray(fetched)
        retries = []
        for k, (frame, cand, chi2) in enumerate(rows):
            row = packed[k]
            T_ac = row[:16].reshape(4, 4)
            a_frame = int(row[16])
            n_inl = int(row[17])
            ok = bool(row[18] > 0.5)
            self.loop_events.append(LoopEvent(
                frame=frame, candidate=cand, chi2=chi2,
                num_inliers=n_inl, accepted=ok))
            if not ok:
                if (depth == 0 and n_inl >= self.NEAR_MISS_MIN
                        and not self._edge_is_dup(cand, frame)):
                    retries += self._retry_rows(frame, cand, chi2, a_frame)
                continue
            if self._edge_is_dup(cand, a_frame):
                continue
            if not np.isfinite(T_ac).all():
                continue
            # Edge (cand, anchor): Z = T_cand_anchor = inv(T_anchor_cand)
            Z = np.asarray(np.linalg.inv(np.asarray(T_ac)))
            self.loop_edges.append((cand, a_frame, Z,
                                    float(self.cfg.ba.pg_loop_weight)))
            if not self._defer_pgo:
                self._run_pgo()
        if retries:
            seen, uniq = [], []
            for hf, c, v in retries:
                if all((hf, c) != s for s in seen):
                    seen.append((hf, c))
                    uniq.append((hf, c, v))
            self._dispatch_slate(uniq, depth=1, salt=1)

    @traced("host:slam.consume")
    def _consume_verifications(self, force=False):
        """Apply dispatched slates (retries dispatched meanwhile extend
        the list: drain until empty). In the asynchronous mode one
        slate's result is in flight to the worker at a time and is
        applied once it has landed; `force` waits for all of them."""
        if not self._async:
            while self._verifying:
                pending, self._verifying = self._verifying, []
                for rows, packed, depth in pending:
                    with wait("slate"):
                        fetched = packed.cpu().numpy()
                    self._apply_slate(rows, fetched, depth=depth)
            return
        while True:
            if self._verify_inflight is not None:
                fut, rows, depth = self._verify_inflight
                if not (force or fut.done()):
                    return
                self._verify_inflight = None
                self._apply_slate(rows, self._landed(fut, force),
                                  depth=depth)
            if not self._verifying:
                return
            rows, packed, depth = self._verifying.pop(0)
            self._verify_inflight = (self._fetch(packed), rows, depth)
            if not force:
                return

    def loop_edge_rows(self, cap: int = MAX_LOOP_EDGES):
        """Fixed-capacity (le_i, le_j, le_z, le_w) loop edges with
        endpoints as keyframe-row indices."""
        with wait("loop_edge_rows"):
            rof = self.state.kf.row_of_frame.cpu().numpy()
        le_i = np.zeros(cap, np.int32)
        le_j = np.zeros(cap, np.int32)
        le_z = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        le_w = np.zeros(cap, np.float32)
        k = 0
        for i, j, Z, w in self.loop_edges[-cap:]:
            ri = int(rof[i]) if 0 <= i < rof.shape[0] else -1
            rj = int(rof[j]) if 0 <= j < rof.shape[0] else -1
            if ri < 0 or rj < 0:
                continue
            le_i[k], le_j[k], le_z[k], le_w[k] = ri, rj, Z, w
            k += 1
        dev = self.state.traj.device
        return tuple(_upload("loop_edge_inputs", a, dev)
                     for a in (le_i, le_j, le_z, le_w))

    def detect_loops_offline(self, stride_kf: int = 8,
                             run_pgo: bool = True) -> int:
        """Post-hoc loop sweep: every stride_kf-th keyframe is
        place-queried against the whole store and its candidates
        verified; one full relaxation at the end. Returns the number of
        loop edges added."""
        cfg = self.cfg
        with wait("detect_loops"):
            kf_n = int(self.state.kf.n)
        if kf_n < 2:
            return 0
        with wait("detect_loops"):
            fo = self.state.kf.frame_of_row[:kf_n].cpu().numpy()
        n0 = len(self.loop_edges)
        self._defer_pgo = True
        try:
            for q_row in range(stride_kf, kf_n, stride_kf):
                q_frame = int(fo[q_row])
                max_frame = q_frame - cfg.bow.query_exclude
                if max_frame <= 0:
                    continue
                pairs = self._place_pairs(q_row, q_frame, max_frame, kf_n)
                if pairs:
                    self._try_close_loop(pairs)
                self._consume_verifications(force=True)
        finally:
            self._defer_pgo = False
        added = len(self.loop_edges) - n0
        if run_pgo and added:
            self._run_pgo(iters=self.cfg.ba.pg_iters)
        return added

    @traced("host:slam.pgo")
    def _run_pgo(self, iters: Optional[int] = None):
        """Relax the pose graph of the trajectory so far and its newest
        MAX_LOOP_EDGES loop edges: `iters` Gauss-Newton iterations
        (default: the live budget, max(pg_iters // 5, 3)); the host
        waits for the result."""
        bucket, n_live, edges = self._pgo_inputs()
        self.pgo_costs.append(self._pgo(
            bucket, iters or max(self.cfg.ba.pg_iters // 5, 3), n_live,
            *edges))
        dev = self.state.traj.device
        if dev.type == "cuda":
            with wait("pgo"):
                torch.cuda.synchronize(dev)

    def _pgo_inputs(self):
        """What a relaxation now takes: the smallest PGO bucket that holds
        the trajectory, the live poses in it, and the newest
        MAX_LOOP_EDGES loop edges as fixed-capacity (le_i, le_j, le_z,
        le_w) on the state's device."""
        n = self.frame_count + 1
        f_cap = self.state.traj.shape[0]
        bucket = next((b for b in PGO_BUCKETS if b >= n and b <= f_cap),
                      f_cap)
        edges = self.loop_edges
        if len(edges) > MAX_LOOP_EDGES:
            warnings.warn(
                f"pose graph holds {len(edges)} loop edges; only the "
                f"newest {MAX_LOOP_EDGES} are used (MAX_LOOP_EDGES)")
            edges = edges[-MAX_LOOP_EDGES:]
        le_i = np.zeros(MAX_LOOP_EDGES, np.int64)
        le_j = np.zeros(MAX_LOOP_EDGES, np.int64)
        le_z = np.tile(np.eye(4, dtype=np.float32), (MAX_LOOP_EDGES, 1, 1))
        le_w = np.zeros(MAX_LOOP_EDGES, np.float32)
        for k, (i, j, Z, w) in enumerate(edges):
            le_i[k], le_j[k], le_z[k], le_w[k] = i, j, Z, w
        dev = self.state.traj.device
        return bucket, min(n, bucket), tuple(
            _upload("pgo_inputs", a, dev) for a in (le_i, le_j, le_z, le_w))

    def _pgo(self, bucket: int, iters: int, n_live: int, le_i, le_j, le_z,
             le_w) -> torch.Tensor:
        """The relaxation as the programs `pgo_build[bucket]` (the pose
        graph from the state and the loop edges), `iters` times
        `pgo_gn[bucket]` (one Gauss-Newton iteration; `n_live` goes in as
        a 0-d int32 device tensor) and `pgo_apply[bucket]` (the state's
        write-back) -> the cost, a 0-d tensor on the device. Nothing is
        read back to the host between them."""
        graph = self._program(f"pgo_build[{bucket}]",
                              _graphed_pgo_build(bucket),
                              le_i, le_j, le_z, le_w)
        live = self._device_int(n_live, torch.int32)
        gn = _graphed_pgo_gn(self.cfg.ba.cg_iters)
        for _ in range(iters):
            graph = self._program(f"pgo_gn[{bucket}]", gn, graph, live)
        return self._backend(f"pgo_apply[{bucket}]",
                             _graphed_pgo_apply(bucket), graph)

    # ------------------------------------------------ checkpoint/resume
    @traced("host:slam.checkpoint")
    def save_checkpoint(self, path: str):
        """Snapshot the state, the step stream's generator and the
        host-side bookkeeping into one npz. Pending rows are drained
        first (resume replays from the snapshot), and verifications are
        consumed again after the poll: a hit among the drained rows
        dispatches a new slate, whose loop edge must be in the snapshot
        since its trigger rows are already consumed."""
        self._poll(force=True)
        self._consume_verifications(force=True)
        meta = {
            "frame_count": self.frame_count,
            "kf_at_last_ba": self._kf_at_last_ba,
            "seed": self.seed,
            "bow_train_frame": self.bow_train_frame,
            "bow_trained": self._bow_trained,
            "hit_history": self._hit_history,
            "last_place_kf": self._last_place_kf,
            "n_slates": self.n_slates,
            "loop_edges": [
                (int(i), int(j), np.asarray(Z).tolist(), float(w))
                for i, j, Z, w in self.loop_edges],
        }
        ckpt_mod.save(path, (self.state, self.draws.get_state()), meta=meta)

    @classmethod
    def resume(cls, path: str, cam: StereoCamera,
               cfg: Optional[SlamConfig] = None,
               device=None) -> "SlamSystem":
        """Restore a system from a checkpoint onto `device` (default: the
        card; raises where there is none); the camera is moved there."""
        cfg = cfg or SlamConfig()
        device = default_device(device)
        cam = cam.to(device)
        meta = ckpt_mod.load_meta(path)
        sys_ = cls(cam, cfg, seed=meta["seed"],
                   bow_train_frame=meta["bow_train_frame"])
        template = (_template_state(cam, cfg), sys_.draws.get_state())
        sys_.state, gen_state = ckpt_mod.load(path, template)
        sys_.draws.set_state(gen_state)
        sys_.frame_count = meta["frame_count"]
        # The ring's rows were consumed by the drain before the snapshot.
        sys_._last_drained = meta["frame_count"]
        sys_._kf_at_last_ba = meta["kf_at_last_ba"]
        sys_._bow_trained = meta["bow_trained"]
        sys_._hit_history = [
            (int(hf), [(int(c), float(v)) for c, v in cands])
            for hf, cands in meta["hit_history"]]
        sys_._last_place_kf = meta["last_place_kf"]
        sys_.n_slates = meta["n_slates"]
        sys_.loop_edges = [(i, j, np.asarray(Z, np.float32), w)
                           for i, j, Z, w in meta["loop_edges"]]
        return sys_

    # ------------------------------------------------------------ final
    @traced("host:slam.finalize")
    def finalize(self, run_pgo: bool = True):
        self._poll(force=True)                  # catch a trailing loop hit
        self._consume_verifications(force=True)  # ... and its verification
        if run_pgo and self.loop_edges:
            self._run_pgo(iters=self.cfg.ba.pg_iters)
        return self.poses()

    def poses(self) -> np.ndarray:
        with wait("poses"):
            return self.state.traj[:self.frame_count + 1].cpu().numpy()

    def pose_graph(self, poses) -> posegraph.PoseGraph:
        """The run's pose graph (odometry and loop edges, as _run_pgo
        builds it, without padding) at the (F,4,4) trajectory `poses`,
        on the CPU."""
        st = self.state
        f = poses.shape[0]
        ei = torch.arange(f - 1)
        le = self.loop_edges
        z_loop = np.stack([z for _, _, z, _ in le]) if le else np.zeros(
            (0, 4, 4), np.float32)
        with wait("pose_graph"):
            rel = st.rel[1:f].cpu()
        with wait("pose_graph"):
            rel_mask = st.rel_mask[1:f].cpu()
        return posegraph.PoseGraph(
            poses=torch.as_tensor(poses, dtype=torch.float32),
            ei=torch.cat([ei, torch.tensor([i for i, _, _, _ in le],
                                           dtype=torch.long)]),
            ej=torch.cat([ei + 1, torch.tensor([j for _, j, _, _ in le],
                                               dtype=torch.long)]),
            z=torch.cat([se3.exp_se3(-rel),
                         torch.as_tensor(z_loop, dtype=torch.float32)]),
            w=torch.cat([rel_mask.float(),
                         torch.tensor([w for _, _, _, w in le],
                                      dtype=torch.float32)]))


def _template_state(cam: StereoCamera, cfg: SlamConfig) -> SlamState:
    """A SlamState of the config's shapes on the camera's device (the
    bootstrap of a black frame): the structure a checkpoint loads into."""
    dev = cam.fx.device
    z = torch.zeros((cfg.image.height, cfg.image.width), dtype=torch.float32,
                    device=dev)
    return _init_state(z, z, cam, cfg, DrawSource(0, dev))


def run(lefts, rights, cam: StereoCamera, cfg: Optional[SlamConfig] = None,
        seed: int = 0, bow_train_frame: int = 30,
        draws: Optional[DrawSource] = None):
    """Batch API over pre-loaded (F,H,W) stacks. Returns (poses, system)."""
    sys_ = SlamSystem(cam, cfg, seed, bow_train_frame, draws=draws)
    for i in range(lefts.shape[0]):
        sys_.process(lefts[i], rights[i])
    return sys_.finalize(), sys_
