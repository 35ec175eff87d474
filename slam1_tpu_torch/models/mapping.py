"""Global map: fixed-capacity landmark table with voxel-hash dedup,
per-keyframe observation slots, and keyframe feature snapshots
(counterpart of `slam1_tpu/models/mapping.py`).

A pre-allocated landmark table plus an open-addressed voxel hash
(linear probing over `probes` slots); merge and insert are gathers and
scatters with masks, with no dynamic shapes and no host round trip.

The tables are updated in place (the reference donates its state); a
caller that needs the old state clones it first. Where the reference
masks a scatter by sending it out of bounds (`mode="drop"`), the port
keeps every write deterministic without compacting lanes (compaction
reads a count back to the host):
  - uniform sets (`valid = True`, `last_frame = frame`) and adds go
    through an integer hit count per row: dropped lanes add 0;
  - per-lane row writes target rows that are unique by construction
    (the `n` rows after the cursor, taken modulo the capacity) and keep
    the old value where no lane lands;
  - several new points picking one empty hash bucket resolve as the
    reference's last-write-wins: the highest lane wins, picked with a
    `scatter_reduce(amax)` over lane positions;
  - a keyframe row is rewritten as `where(gate, new, old)`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slam1_tpu_torch.config import MappingConfig
from slam1_tpu_torch.runtime import default_device
from slam1_tpu_torch.types import StereoObservations

# Large primes for the 3D voxel hash.
_P1, _P2, _P3 = 73856093, 19349669, 83492791
_I32_MIN = -(1 << 31)


class MapState(NamedTuple):
    xyz: torch.Tensor        # (CAP,3) world positions (running mean)
    desc: torch.Tensor       # (CAP,D) uint8 descriptor of first observation
    count: torch.Tensor      # (CAP,) int32 merged-observation count
    valid: torch.Tensor      # (CAP,) bool
    hash_slot: torch.Tensor  # (H+1,) int32 bucket -> landmark row, -1 empty;
                             # bucket H is never a real bucket
    cursor: torch.Tensor     # () int32 next free row
    last_frame: torch.Tensor # (CAP,) int32 frame of last observation
    obs: torch.Tensor        # (F,OPF,4) float32 [frame, landmark, u, v]
    obs_ur: torch.Tensor     # (F,OPF) float32 right-camera u
    obs_count: torch.Tensor  # (F,) int32 filled slots per row


def init_map(cfg: MappingConfig, desc_bytes: int = 32,
             dtype=torch.float32, device=None) -> MapState:
    device = default_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return MapState(
        xyz=z(cfg.capacity, 3),
        desc=z(cfg.capacity, desc_bytes, dt=torch.uint8),
        count=z(cfg.capacity, dt=torch.int32),
        valid=z(cfg.capacity, dt=torch.bool),
        hash_slot=torch.full((cfg.hash_size + 1,), -1, dtype=torch.int32,
                             device=device),
        cursor=z(dt=torch.int32),
        last_frame=z(cfg.capacity, dt=torch.int32),
        obs=z(cfg.max_frames, cfg.obs_per_frame, 4),
        obs_ur=z(cfg.max_frames, cfg.obs_per_frame),
        obs_count=z(cfg.max_frames, dt=torch.int32),
    )


def _wrap32(v):
    """int64 -> the int64 value of its low 32 bits read as int32 (the
    reference's int32 products wrap)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v)


def _hash_cells(ix, iy, iz, hash_size: int):
    """int64 voxel coordinates (int32 range) -> bucket in [0, H), with
    the reference's int32 arithmetic: wrapping products, XOR, abs (which
    leaves INT32_MIN as it is) and a floor remainder."""
    h = _wrap32(ix * _P1) ^ _wrap32(iy * _P2) ^ _wrap32(iz * _P3)
    h = torch.where(h == _I32_MIN, h, torch.abs(h))
    return torch.remainder(h, hash_size)


def _voxel_hash(xyz, voxel_size: float, hash_size: int):
    v = torch.floor(xyz / voxel_size).to(torch.int32).long()
    return _hash_cells(v[..., 0], v[..., 1], v[..., 2], hash_size)


def popcount8(x):
    """Bit count of each byte of a uint8 tensor (SWAR, no lookup)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def scalar(v, dtype, device) -> torch.Tensor:
    """0-d tensor of `v` on `device`: a tensor is cast, a Python number
    is filled in on the device (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _row_hits(n_rows: int, rows, gate):
    """(n_rows,) bool: rows that at least one gated lane targets."""
    hits = torch.zeros(n_rows, dtype=torch.int32, device=rows.device)
    hits.index_add_(0, torch.where(gate, rows, 0), gate.to(torch.int32))
    return hits > 0


def insert(state: MapState, xyz_world, desc, mask, frame_idx, uv,
           cfg: MappingConfig, uv_r_u=None, obs_row=None,
           known_row=None) -> Tuple[MapState, torch.Tensor]:
    """Merge-or-insert a batch of world points.

    xyz_world (N,3), desc (N,D), mask (N,), uv (N,2); frame_idx: int
    (or 0-d tensor); uv_r_u: optional (N,) right-camera u; obs_row: row
    of the observation table (int or 0-d tensor, default frame_idx);
    known_row: optional (N,) landmark row each input already belongs to
    (-1 = unknown), which takes priority over the hash probe.
    Returns (state, (N,) int32 landmark row of each input, -1 if
    dropped).
    """
    n = xyz_world.shape[0]
    dev = xyz_world.device
    cap = state.xyz.shape[0]
    if n > cap:
        raise ValueError(f"batch of {n} points exceeds the capacity {cap}")
    H = cfg.hash_size
    P = cfg.probes
    lanes = torch.arange(n, device=dev)
    # Hash grid at least the merge-ball diameter: probing the 8 corner
    # voxels of the ball then covers every voxel it intersects.
    vs = max(cfg.voxel_size, 2.0 * cfg.merge_radius)
    h0 = _voxel_hash(xyz_world, vs, H)

    r = cfg.merge_radius
    lo = torch.floor((xyz_world - r) / vs).to(torch.int32).long()
    hi = torch.floor((xyz_world + r) / vs).to(torch.int32).long()
    cx = torch.stack([lo[:, 0], hi[:, 0]], -1)
    cy = torch.stack([lo[:, 1], hi[:, 1]], -1)
    cz = torch.stack([lo[:, 2], hi[:, 2]], -1)
    # corner-major order (cx, cy, cz), as the reference probes
    hcor = _hash_cells(cx[:, :, None, None], cy[:, None, :, None],
                       cz[:, None, None, :], H).reshape(n, 8)
    probe = torch.arange(P, device=dev)
    buckets = ((hcor[:, :, None] + probe) % H).reshape(n, 8 * P)
    slots = state.hash_slot[buckets]                          # (N,8P)
    occ = slots >= 0
    slots_c = torch.clamp(slots, min=0).long()
    cand = state.xyz[slots_c]                                 # (N,8P,3)
    near = occ & (torch.sum((cand - xyz_world[:, None, :]) ** 2, dim=-1)
                  < r * r)
    if cfg.merge_desc_gate > 0:
        # Appearance gate: position alone merges distinct points under
        # drift; require descriptor agreement too.
        x = torch.bitwise_xor(state.desc[slots_c], desc[:, None, :])
        hd = torch.sum(popcount8(x).to(torch.int32), dim=-1)
        near = near & (hd <= cfg.merge_desc_gate)
    first = torch.argmax(near.to(torch.int32), dim=1)         # first True
    hash_row = torch.where(near.any(dim=1), slots_c[lanes, first], -1)
    if known_row is not None:
        kr = known_row.long()
        merge_row = torch.where((kr >= 0) & (kr < cap), kr, hash_row)
    else:
        merge_row = hash_row
    # New landmarks go on their own voxel's probe chain.
    b0 = (h0[:, None] + probe) % H                            # (N,P)
    vac = state.hash_slot[b0] < 0
    p0 = torch.argmax(vac.to(torch.int32), dim=1)
    free_bucket = torch.where(vac.any(dim=1), b0[lanes, p0], -1)

    is_merge = mask & (merge_row >= 0)
    is_new = mask & (merge_row < 0) & (free_bucket >= 0)
    # Rows for inserts by exclusive prefix sum over the batch.
    new_flag = is_new.to(torch.int64)
    offsets = torch.cumsum(new_flag, 0) - new_flag
    cursor0 = state.cursor.long()
    new_row = cursor0 + offsets
    is_new = is_new & (new_row < cap)

    frame_i = scalar(frame_idx, torch.int32, dev)
    dt = xyz_world.dtype

    # --- merges: running-mean position + count bump (a merge also
    # revives a culled landmark). Reads of the old rows come first.
    mrow = torch.where(is_merge, merge_row, 0)
    old_cnt = state.count[mrow].to(dt)
    delta = (xyz_world - state.xyz[mrow]) / torch.clamp(
        old_cnt + 1.0, min=1.0)[:, None]
    state.count.index_add_(0, mrow, is_merge.to(torch.int32))
    # Several lanes can merge into one row, and CUDA adds them in the
    # order its atomics land: summed in float64 and rounded once, since
    # bundle adjustment carries these positions back into the poses.
    moved = torch.zeros((cap, 3), dtype=torch.float64, device=dev)
    moved.index_add_(0, mrow, torch.where(is_merge[:, None], delta,
                                          torch.zeros_like(delta)).double())
    state.xyz.add_(moved.to(dt))
    hit = _row_hits(cap, mrow, is_merge)
    state.valid[:] = state.valid | hit
    state.last_frame[:] = torch.where(hit, frame_i, state.last_frame)

    # --- inserts: the n rows after the cursor (mod cap: unique), each
    # filled by the new lane with that offset, or kept.
    n_new = torch.sum(is_new.to(torch.int64))
    rows = (cursor0 + lanes) % cap
    take = lanes < n_new
    src = torch.searchsorted(torch.cumsum(new_flag, 0), lanes + 1)
    src = torch.clamp(src, max=n - 1)

    def fill(table, values):
        table[rows] = torch.where(
            take.reshape((-1,) + (1,) * (values.dim() - 1)),
            values[src].to(table.dtype), table[rows])

    fill(state.xyz, xyz_world)
    fill(state.desc, desc)
    fill(state.count, torch.ones(n, dtype=torch.int32, device=dev))
    fill(state.valid, torch.ones(n, dtype=torch.bool, device=dev))
    fill(state.last_frame, frame_i.expand(n))
    # Hash buckets: last write wins, i.e. the highest new lane.
    win = torch.full((H + 1,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, torch.where(is_new, free_bucket, H),
                        torch.where(is_new, lanes, -1), "amax")
    won = win[:H] >= 0
    state.hash_slot[:H] = torch.where(
        won, new_row[torch.clamp(win[:H], min=0)].to(torch.int32),
        state.hash_slot[:H])
    state.hash_slot[H:].fill_(-1)
    cursor = state.cursor + n_new.to(torch.int32)

    landmark_of = torch.where(is_merge, merge_row,
                              torch.where(is_new, new_row, -1))

    # --- observation records [frame, landmark, u, v] into the slots of
    # row `obs_row`: built in a local copy of the row whose extra last
    # slot takes the dropped lanes, then written back whole.
    opf = state.obs.shape[1]
    orow = frame_i if obs_row is None else scalar(obs_row, torch.int64, dev)
    frow = torch.clamp(orow.long(), 0, state.obs.shape[0] - 1).reshape(1)
    base = state.obs_count.index_select(0, frow)
    has_obs = landmark_of >= 0
    oflag = has_obs.to(torch.int64)
    slot = base + torch.cumsum(oflag, 0) - oflag
    w = has_obs & (slot < opf)
    slot_c = torch.where(w, slot, opf)
    rec = torch.stack([frame_i.to(dt).expand(n), landmark_of.to(dt),
                       uv[:, 0], uv[:, 1]], dim=-1)
    if uv_r_u is None:
        uv_r_u = torch.zeros(n, dtype=dt, device=dev)
    for table, values in ((state.obs, rec), (state.obs_ur, uv_r_u)):
        buf = torch.cat([table.index_select(0, frow)[0],
                         torch.zeros_like(values[:1])])
        buf[slot_c] = values           # duplicates only in the extra slot
        table.index_copy_(0, frow, buf[None, :opf])
    state.obs_count.index_copy_(
        0, frow, (base + torch.sum(w.to(torch.int64))).to(torch.int32))

    return state._replace(cursor=cursor), landmark_of.to(torch.int32)


def cull(state: MapState, frame, min_obs, max_age, gate=True) -> MapState:
    """Invalidate landmarks observed fewer than `min_obs` times and not
    seen for more than `max_age` frames (a later merge revives them),
    where `gate` (a bool or 0-d bool tensor: the cull's cadence, decided
    on the device) holds."""
    stale = (state.valid & (state.count < min_obs)
             & (frame - state.last_frame > max_age) & gate)
    state.valid[:] = state.valid & ~stale
    return state


class KeyframeStore(NamedTuple):
    """Per-keyframe top-K feature snapshots for loop closure."""
    xyz: torch.Tensor           # (F,K,3) camera-frame 3D points
    desc: torch.Tensor          # (F,K,D) uint8
    uv: torch.Tensor            # (F,K,2)
    mask: torch.Tensor          # (F,K) bool
    poses: torch.Tensor         # (F,4,4) world-from-camera at insertion
    frame_of_row: torch.Tensor  # (F,) int32 frame index of each keyframe
    row_of_frame: torch.Tensor  # (F,) int32 keyframe row of a frame, -1
    n: torch.Tensor             # () int32


def init_kf_store(max_frames: int, k: int, desc_bytes: int = 32,
                  dtype=torch.float32, device=None) -> KeyframeStore:
    device = default_device(device)
    return KeyframeStore(
        xyz=torch.zeros((max_frames, k, 3), dtype=dtype, device=device),
        desc=torch.zeros((max_frames, k, desc_bytes), dtype=torch.uint8,
                         device=device),
        uv=torch.zeros((max_frames, k, 2), dtype=dtype, device=device),
        mask=torch.zeros((max_frames, k), dtype=torch.bool, device=device),
        poses=torch.eye(4, dtype=dtype, device=device).repeat(
            max_frames, 1, 1),
        frame_of_row=torch.full((max_frames,), -1, dtype=torch.int32,
                                device=device),
        row_of_frame=torch.full((max_frames,), -1, dtype=torch.int32,
                                device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
    )


def kf_insert(store: KeyframeStore, obs: StereoObservations, pose,
              k: int, frame=0, is_kf=True) -> KeyframeStore:
    """Keep the k strongest valid stereo observations of this frame
    (score 1 + FAST response; invalid slots score -1, ties to the lowest
    index) in keyframe row `store.n`, when `is_kf` (0-d bool) holds.
    `frame` is an int or a 0-d tensor; its row of `row_of_frame` is
    clamped into the table on the device."""
    n = obs.mask.shape[0]
    dev = obs.mask.device
    scores = torch.where(obs.mask, 1.0 + obs.score.to(torch.float32),
                         torch.full_like(obs.score, -1.0,
                                         dtype=torch.float32))
    idx = torch.sort(scores, descending=True, stable=True).indices[:min(k, n)]
    sel_mask = obs.mask[idx]
    if n < k:
        idx = torch.cat([idx, torch.zeros(k - n, dtype=idx.dtype,
                                          device=dev)])
        sel_mask = torch.cat([sel_mask, torch.zeros(k - n, dtype=torch.bool,
                                                    device=dev)])
    gate = scalar(is_kf, torch.bool, dev)
    cap = store.xyz.shape[0]
    row = torch.clamp(store.n.long(), max=cap - 1).reshape(1)

    def put(table, value):
        old = table.index_select(0, row)
        table.index_copy_(0, row, torch.where(gate, value[None], old))

    put(store.xyz, obs.xyz[idx])
    put(store.desc, obs.desc[idx])
    put(store.uv, obs.uv_l[idx])
    put(store.mask, sel_mask)
    put(store.poses, pose)
    put(store.frame_of_row, scalar(frame, torch.int32, dev))
    frow = torch.clamp(scalar(frame, torch.int64, dev), 0, cap - 1)
    frow = frow.reshape(1)
    store.row_of_frame.index_copy_(0, frow, torch.where(
        gate, row.to(torch.int32), store.row_of_frame.index_select(0, frow)))
    return store._replace(n=store.n + gate.to(torch.int32))
