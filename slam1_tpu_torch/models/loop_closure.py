"""Loop closure: keyframe-vs-keyframe geometric verification and
brute-force place recognition (counterpart of
`slam1_tpu/models/loop_closure.py`).

Verification matches the candidate keyframe's snapshot against the
anchor keyframe's (the newest keyframe at or before the hit frame) and
runs RANSAC-PnP on the matches. A whole slate of candidate pairs runs
as one batch: one launch of the batched Hamming kernel and one batched
RANSAC, where the reference vmaps the pair function.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from slam1_tpu_torch.config import SlamConfig
from slam1_tpu_torch.models.mapping import KeyframeStore, scalar
from slam1_tpu_torch.ops import hamming
from slam1_tpu_torch.ops.brief import unpack_bits_pm1
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.ops.pnp import ransac_pnp

# Keyframes scored per matrix product in place_query: a (N, 32*K)
# product of N = K = 1024 is 128 MB of float32 scores.
PLACE_CHUNK = 32


class LoopPairResult(NamedTuple):
    T_anchor_cand: torch.Tensor   # (...,4,4) anchor camera from candidate
    anchor_frame: torch.Tensor    # (...) int32 frame index of the anchor kf
    num_inliers: torch.Tensor
    ok: torch.Tensor


def verify_loop_slate(u, store: KeyframeStore, cand_frames, hit_frames,
                      cam: StereoCamera, cfg: SlamConfig) -> LoopPairResult:
    """Verify a (B,) slate of candidate/anchor pairs at once.

    cand_frames, hit_frames: (B,) int tensors; entries with a negative
    candidate are padding (ok=False). u: (B,1024,K) RANSAC draws. The
    candidate keyframe's 3D points are matched against the 2D keypoints
    of the anchor, the newest keyframe at or before the hit frame.
    Returns a LoopPairResult with a leading (B,) axis.
    """
    cand = cand_frames.long()
    hit = hit_frames.long()
    n_rows = store.row_of_frame.shape[0]
    cap = store.xyz.shape[0]
    row = store.row_of_frame[torch.clamp(cand, 0, n_rows - 1)].long()
    kf_idx = torch.clamp(row, 0, cap - 1)
    kf_xyz = store.xyz[kf_idx]
    kf_desc = store.desc[kf_idx]
    kf_mask = store.mask[kf_idx] & ((row >= 0) & (cand >= 0))[:, None]

    # Anchor: the newest keyframe whose frame index <= hit frame.
    fo = store.frame_of_row.long()                  # (F,) -1 for empty
    elig = (fo >= 0) & (fo <= hit[:, None])         # (B,F)
    a_row = torch.argmax(torch.where(elig, fo, -1), dim=1)
    anchor_ok = torch.any(elig, dim=1)
    a_idx = torch.clamp(a_row, 0, cap - 1)
    a_frame = torch.where(anchor_ok, fo[a_idx], -1)
    a_mask = store.mask[a_idx] & (anchor_ok & (a_frame != cand))[:, None]

    # Recall-oriented descriptor stage: the 1024-hypothesis RANSAC and
    # the inlier gate give the precision.
    m = hamming.match_batched(kf_desc, store.desc[a_idx], kf_mask, a_mask,
                              ratio=min(cfg.matcher.ratio + 0.1, 0.95),
                              max_distance=cfg.matcher.max_hamming,
                              cross_check=cfg.matcher.cross_check)
    valid = m.mask & kf_mask
    uv_a = torch.gather(store.uv[a_idx], 1,
                        m.idx[..., None].expand(-1, -1, 2))
    loop_cfg = dataclasses.replace(cfg.tracking, ransac_iters=1024,
                                   ransac_sample=4)
    pnp = ransac_pnp(kf_xyz, uv_a, valid, cam, loop_cfg, u=u)
    ok = pnp.ok & anchor_ok & (pnp.num_inliers >= cfg.bow.min_loop_inliers)
    return LoopPairResult(T_anchor_cand=pnp.T,
                          anchor_frame=a_frame.to(torch.int32),
                          num_inliers=pnp.num_inliers, ok=ok)


def verify_loop_pair(u, store: KeyframeStore, cand_frame: int,
                     hit_frame: int, cam: StereoCamera,
                     cfg: SlamConfig) -> LoopPairResult:
    """One candidate/anchor pair (u: (1024,K) draws); see
    verify_loop_slate."""
    dev = store.xyz.device
    res = verify_loop_slate(
        u[None], store, torch.tensor([cand_frame], device=dev),
        torch.tensor([hit_frame], device=dev), cam, cfg)
    return LoopPairResult(*[v[0] for v in res])


def place_query(store: KeyframeStore, q_row, max_frame, n_rows: int,
                k: int = 4, thresh: int = 48, nms_frames: int = 50):
    """Brute-force place recognition: score every stored keyframe row
    below `n_rows` by how many of the query keyframe's descriptors have
    a match within Hamming distance `thresh` in its snapshot; return the
    top-k candidate frames (NMS-separated by >= nms_frames, frames
    newer than `max_frame` excluded) and their scores.

    `q_row` and `max_frame` are ints or 0-d tensors on the store's
    device; nothing is read back to the host, so with tensors the
    function can be captured as a CUDA graph (one per `n_rows`).
    The +-1 product is exact in bf16 with a float32 sum (and in float32
    on the CPU); it runs PLACE_CHUNK keyframes at a time.
    """
    dev = store.desc.device
    mm_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    q = scalar(q_row, torch.int64, dev).reshape(1)
    qa = unpack_bits_pm1(store.desc.index_select(0, q)[0]).to(mm_dtype)
    q_mask = store.mask.index_select(0, q)[0]                 # (N,)
    bits = qa.shape[1]
    K = store.desc.shape[1]
    scores = []
    for lo in range(0, n_rows, PLACE_CHUNK):
        hi = min(n_rows, lo + PLACE_CHUNK)
        da = unpack_bits_pm1(store.desc[lo:hi]).to(mm_dtype)  # (G,K,256)
        sim = (qa @ da.reshape(-1, bits).T).float()             # (N,G*K)
        dist = (bits - sim) * 0.5
        dist = torch.where(store.mask[lo:hi].reshape(1, -1), dist,
                           torch.full_like(dist, 1e9))
        dmin = torch.amin(dist.reshape(-1, hi - lo, K), dim=2)  # (N,G)
        scores.append(torch.sum(((dmin <= thresh) & q_mask[:, None])
                                .to(torch.float32), dim=0))
    scores = torch.cat(scores)
    fo = store.frame_of_row[:n_rows].long()
    valid = (fo >= 0) & (fo <= scalar(max_frame, torch.int64, dev))
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))

    cands, cscores = [], []
    for _ in range(k):
        v, b = torch.max(scores, dim=0)          # first index on ties
        f_b = fo.index_select(0, b.reshape(1))[0]
        cands.append(torch.where(v > 0, f_b, -1))
        cscores.append(v)
        scores = torch.where(torch.abs(fo - f_b) < nms_frames,
                             torch.full_like(scores, -1.0), scores)
    return torch.stack(cands).to(torch.int32), torch.stack(cscores)
